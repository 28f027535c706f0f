"""``BENCHMARK.json`` read, and each name in it found as a file.

A cell (``workloads`` entry) names a configuration and a traffic mix;
the configuration's entry names its file, the traffic mix is
``traffic/<name>.json``, the mix's ``driver`` key names the code that
runs it, ``drivers/<driver>.py``, and each metric is read by
``metrics/<name>.py``, all beside this file (or in the directory a
caller gives).  Adding a configuration, a mix, a driver or a metric
adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    end_to_end: list        # the metric entries this cell reports ...
    per_layer: list         # ... untraced and traced
    bench_dir: Path


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT,
         bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of ``bench`` with its files read; file paths in
    ``bench`` are relative to ``root``."""
    bench_dir = Path(bench_dir or HERE)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((Path(root) / cfg["file"]).read_text()),
        traffic=json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


_LOADED: dict = {}


def _module(bench_dir: Path, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py``, loaded from its path once."""
    path = (Path(bench_dir) / kind / f"{name}.py").resolve()
    if path not in _LOADED:
        mod_name = f"portbench._{kind}_{len(_LOADED)}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def reader(bench_dir: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(bench_dir, "metrics", metric).read


def driver(c: Cell):
    """The module ``drivers/<driver>.py`` that the cell's traffic mix
    names."""
    return _module(c.bench_dir, "drivers", c.traffic["driver"])
