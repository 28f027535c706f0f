"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up makes the cell's inputs from the
seed, builds the program's objects from them and warms the cell's own
shapes; the window then runs the program's calls back to back for
``--seconds``; after it closes the plain reference judges every call's
verdict.  The last line of standard output is the result as one JSON
object, and the last lines of standard error give each number compared
beside its limit.  ``--trace 1`` runs the window under ``torch.profiler``
and reports the cell's per-layer metrics instead of its end-to-end ones.

The program is ``cometbft_tpu_torch``; nothing here imports ``jax`` or
the JAX package.  The module's top level imports the standard library
alone: the worker processes are forked before anything else loads.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import manifest  # noqa: E402

# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "cometbft_tpu")
# the CUDA driver's kernel cache, at a fixed path inside the checkout (the
# program builds its own libraries into ``build/``)
CACHE_DIRS = {"CUDA_CACHE_PATH": "nv"}


def pin_caches(root: Path) -> None:
    """Point every cache in CACHE_DIRS under ``root/build/portbench``."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / "build" / "portbench" / sub)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden, compared
    as whole names."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _log(line: str) -> None:
    print(f"portbench: {line}", flush=True)


@contextlib.contextmanager
def worker_pool():
    """The worker processes that make the cell's inputs and check them
    for the reference.  Open it before the process imports torch: the
    workers are forked while the process has no thread yet, and a
    forked pool, unlike a spawned one, leaves no resource-tracker
    process behind.  Closed and joined on exit."""
    import multiprocessing
    pool = multiprocessing.get_context("fork").Pool(
        max(1, min(8, os.cpu_count() or 1)))
    try:
        yield pool
    finally:
        pool.close()
        pool.join()


@contextlib.contextmanager
def _gc_pauses():
    """Count and time the collector's passes while the block runs:
    yields {generation: [count, seconds]}, filled as they happen."""
    import gc
    pauses = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
    started = [0.0]

    def callback(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            rec = pauses[info["generation"]]
            rec[0] += 1
            rec[1] += time.perf_counter() - started[0]

    gc.callbacks.append(callback)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(callback)


def _profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device=None, t_start: float | None = None, traffic=None,
             plant=None, pool=None) -> dict:
    """Set up, measure and judge one run of ``cell``.  ``device=None``
    is the card; tests pass ``"cpu"``.  ``traffic`` (a dict) overrides
    keys of the cell's traffic mix and ``plant`` (a context manager)
    wraps the window and its warm-up: the control and the faults use
    them.  ``pool`` is a ``worker_pool``.  Returns the result with the
    check lines and the earlier log lines."""
    from portbench import trace as tr
    t_start = T_START if t_start is None else t_start
    mix = dict(cell.traffic, **(traffic or {}))
    drv = manifest.driver(cell)
    # the pool makes the inputs while this process opens the card
    finish_inputs = drv.inputs(cell.config, mix, seed, pool)

    import torch
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.init()
        kind = torch.cuda.get_device_name()
    t_cuda = time.perf_counter()

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.libs import tracing
    if cuda:
        _build.load()
    _build.load_host()
    t_libs = time.perf_counter()

    inputs = finish_inputs()
    prog = drv.build(inputs, mix, device)
    t_inputs = time.perf_counter()

    with plant() if plant else contextlib.nullcontext():
        seen = drv.warm(prog, mix)
        if traced:
            tracing.configure(enabled=True, buffer_size=1 << 22)
        _freeze()
        t_warm = time.perf_counter()
        setup_s = t_warm - t_start
        prof = _profiler(cuda) if traced else contextlib.nullcontext()
        with _gc_pauses() as pauses, prof:
            off0 = tr.clock_offset()
            starts, ends, outs, t_open, t_close = drv.measure(
                prog, seconds, seen)
            off1 = tr.clock_offset()
    if cuda:
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated()
    lines = [
        f"setup split: import_cuda_s {t_cuda - t_start:.3f}, libs_s "
        f"{t_libs - t_cuda:.3f}, inputs_s {t_inputs - t_libs:.3f}, "
        f"warm_s {t_warm - t_inputs:.3f} ({seen['note']}), "
        f"setup_s {setup_s:.3f}",
        f"window: {len(starts)} calls in "
        f"{(t_close - t_open) / 1e9:.3f} s "
        f"({len(starts) / max(1e-9, (t_close - t_open) / 1e9):.4f} "
        f"commits/s); calls a tenth of it "
        f"{_tenths(starts, t_open, t_close)}; gc " + ", ".join(
            f"gen{g} {c} x {s * 1e3:.1f} ms" for g, (c, s) in pauses.items())]

    trace = None
    if traced:
        calls = [tr.Call(a, b) for a, b in zip(starts, ends)]
        tr.assign(calls, tracing.snapshot(category=tracing.CRYPTO))
        events = tr.device_events(prof, (off0 + off1) // 2) if cuda else []
        trace = tr.Trace(calls, events, (t_open, t_close))
        lines.append(
            f"trace: {len(events)} device events, B1 launches inside "
            f"calls {trace.aligned_share()}, clock drift {off1 - off0} ns")
    run = tr.Run(starts, ends, (t_close - t_open) / 1e9, setup_s, trace)
    del prog, prof

    # the reference, once the window has closed and its peak is read
    t_ref = time.perf_counter()
    mismatched = drv.judge(inputs, outs, seen["calls"], pool)
    lines.append(f"reference: {len(outs)} calls judged in "
                 f"{time.perf_counter() - t_ref:.3f} s")
    for i, got, want in mismatched[:3]:
        lines.append(f"mismatch at call {i}: program {got}, reference "
                     f"{want}")

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = manifest.reader(cell.bench_dir, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(starts) and not mismatched,
              "attempted": len(starts), "failed": len(mismatched),
              "metrics": metrics}
    if cuda:
        result["device"] = {"platform": "gpu", "kind": kind,
                            "count": cell.chips,
                            "memory_peak_bytes": memory_peak}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    if traced:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {
        "mismatched_calls": {"value": len(mismatched), "limit": 0},
        "calls": {"value": len(starts), "limit": 1}}
    return {"result": result, "lines": lines,
            "checks": [f"check mismatched_calls {len(mismatched)} limit 0",
                       f"check calls {len(starts)} limit 1 (at least)"]}


def _freeze() -> None:
    """Collect, then move every object made so far out of the
    collector's reach, so passes in the window do not walk the
    benchmark's pools."""
    import gc
    gc.collect()
    gc.freeze()


def _tenths(starts, t_open, t_close) -> list:
    """How many calls started in each tenth of the window."""
    counts = [0] * 10
    span = max(1, t_close - t_open)
    for t in starts:
        counts[min(9, (t - t_open) * 10 // span)] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = manifest.ROOT
    cell = manifest.cell(manifest.load(root / "BENCHMARK.json"),
                         args.workload, root)
    pin_caches(root)
    with worker_pool() as pool:
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"device(s), found {found}", file=sys.stderr)
            return 2
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       pool=pool)
    for line in out["lines"]:
        _log(line)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(out["result"]), flush=True)
    for line in out["checks"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
