"""CPU tests of the benchmark harness (``python -m pytest portbench -q``).

The cells run here at a tiny size on ``device="cpu"``, where the
program's kernel is its plain PyTorch version (about 2 s a launch), so
each run holds a few calls.  The test marked ``cuda`` runs a cell on the
card and skips without one.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import control, manifest, run, trace as tr, yardstick
from portbench.reference import commit as ref_commit
from portbench.reference import sign_bytes, zip215

ROOT = manifest.ROOT
BENCH = manifest.load(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 7


def tiny(cell: manifest.Cell, validators: int = 10) -> manifest.Cell:
    """The cell cut to a size the CPU runs in seconds: ten validators
    and four pool heights, three of them bad as the mix places them
    (one slot in each third of the set, the last past the 2/3 mark)."""
    cell.config = dict(cell.config, validators=validators)
    cell.traffic = dict(cell.traffic, pool_heights=4, warm_settle_s=0)
    return cell


def run_tiny(name: str, traced=False, seconds=2.5, **kw) -> dict:
    cell = tiny(manifest.cell(BENCH, name))
    return run.run_cell(cell, SEED, seconds, traced, device="cpu",
                        t_start=time.perf_counter(), **kw)


# --- the reference -----------------------------------------------------------

def test_sign_bytes_equal_the_programs():
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.canonical import (PRECOMMIT_TYPE,
                                                    PREVOTE_TYPE,
                                                    vote_sign_bytes)
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    cases = [("chain-a", PRECOMMIT_TYPE, 5, 0, b"\x01" * 32, 3, b"\x02" * 32,
              1_700_000_000, 123),
             ("", PREVOTE_TYPE, 2 ** 40, 7, b"", 0, b"", 0, 0),
             ("c" * 50, PRECOMMIT_TYPE, 1, 1, b"\x03" * 32, 200,
              b"\x04" * 32, -62135596800, 999_999_999)]
    for chain, typ, h, r, bh, total, ph, sec, ns in cases:
        want = vote_sign_bytes(chain, typ, h, r,
                               BlockID(bh, PartSetHeader(total, ph)),
                               Timestamp(sec, ns))
        make = sign_bytes.vote_template(chain, typ, h, r,
                                        sign_bytes.block_id(bh, total, ph))
        assert make(sec, ns) == want


def test_zip215_verdicts():
    from cryptography.hazmat.primitives.asymmetric.ed25519 import \
        Ed25519PrivateKey
    key = Ed25519PrivateKey.from_private_bytes(b"\x05" * 32)
    pub = key.public_key().public_bytes_raw()
    sig = key.sign(b"msg")
    assert zip215.verify(pub, b"msg", sig)
    assert not zip215.verify(pub, b"msh", sig)
    s = int.from_bytes(sig[32:], "little") + zip215.L      # s >= L
    assert not zip215.verify(pub, b"msg", sig[:32] + s.to_bytes(32, "little"))
    # A = the identity written with y = p + 1: non-canonical and of small
    # order.  ZIP-215 accepts [s]B = R; OpenSSL's strict check refuses it.
    ident = (zip215.P + 1).to_bytes(32, "little")
    s = 12345
    r = zip215.mul(s, zip215.B)
    zi = pow(r[2], zip215.P - 2, zip215.P)
    x, y = r[0] * zi % zip215.P, r[1] * zi % zip215.P
    r_bytes = (y | (x & 1) << 255).to_bytes(32, "little")
    edge = r_bytes + s.to_bytes(32, "little")
    assert zip215.verify(ident, b"any", edge)
    assert ref_commit.signature_ok(ident, b"any", edge)
    # the program's plain kernel agrees on all four
    from cometbft_tpu_torch.ops import ed25519 as oe
    items = [(pub, b"msg", sig), (pub, b"msh", sig), (ident, b"any", edge),
             (ident, b"any", edge[:32] + (s + 1).to_bytes(32, "little"))]
    _, mask = oe.verify_batch(items, device="cpu")
    assert mask == [ref_commit.signature_ok(*it) for it in items] == \
        [True, False, True, False]


def test_bad_slots_fall_in_each_part_of_the_set():
    """The mix plants one wrong signature in each third of the set, on
    heights of their own, so a check that leaves out any part of a
    commit meets a bad slot there."""
    from portbench import generator
    cfg = manifest.cell(BENCH, CELLS[0]).config
    mix = manifest.cell(BENCH, CELLS[0]).traffic
    n = 30
    for seed in (1, 2 ** 31 + 11, 2 ** 33):
        inputs = generator.start_inputs(dict(cfg, validators=n), mix,
                                        seed)()
        got = ref_commit.verdicts(inputs.chain_id, inputs.validators,
                                  inputs.heights)
        bad = sorted(v[1] for v in got if v[0] == "bad_sig")
        assert len(bad) == len(mix["bad_heights"]) == 3
        assert [int(lo * n) <= i < int(hi * n) for i, (lo, hi) in
                zip(bad, mix["bad_heights"])] == [True] * 3
        # the last lies past where a check that stops at 2/3 ends
        assert bad[-1] > n * 2 // 3
        assert got.count(("ok",)) == mix["pool_heights"] - 3


def test_reference_verdicts():
    pubs = [bytes([i]) * 32 for i in range(4)]
    assert ref_commit.verdict([10] * 4, [b"s"] * 4, [True] * 4) == ("ok",)
    assert ref_commit.verdict([10] * 4, [b"s"] * 4,
                              [True, True, False, False]) == ("bad_sig", 2)
    # absent slots are neither tallied nor checked
    assert ref_commit.verdict([10] * 4, [b"s", None, b"s", b"s"],
                              [True, False, True]) == ("bad_sig", 2)
    assert ref_commit.verdict([10] * 4, [b"s", None, None, b"s"],
                              [True, True]) == ("power", 20, 26)
    assert len({ref_commit.address(p) for p in pubs}) == 4


# --- the cells at a tiny size on the CPU -------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    out = run_tiny(name)
    res = out["result"]
    assert res["correct"] is True, out["lines"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or name in m["workloads"]}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"]["mismatched_calls"] == {"value": 0, "limit": 0}


def test_traced_run_reads_the_program_spans():
    out = run_tiny(CELLS[0], traced=True)
    res = out["result"]
    assert res["correct"] is True
    # no device on the CPU: the device's metrics have nothing to read
    assert set(res["metrics"]) == {"commit_rate", "walk_ms", "seam_ms",
                                   "host_prep_us_per_sig", "pad_share"}
    assert res["device"]["window_s"] > 0
    gaps = dict(res["breakdown"]["idle_gaps"])
    assert {"walk", "batch_verify", "prep_c"} <= set(gaps)
    assert sum(gaps.values()) == pytest.approx(res["device"]["window_s"])


# long enough for the window to go once round the tiny pool's four heights
ROUND_S = 8.0


def test_the_control_comes_out_not_correct():
    out = run_tiny(CELLS[0], seconds=ROUND_S,
                   traffic={"entry": "verify_commit_light"})
    res = out["result"]
    assert res["attempted"] >= 4, out["lines"]
    assert res["correct"] is False
    assert res["checks"]["mismatched_calls"]["value"] >= 1


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_a_broken_timed_path_comes_out_not_correct(fault):
    out = run_tiny(CELLS[0], seconds=ROUND_S, plant=control.FAULTS[fault])
    assert out["result"]["attempted"] >= 4, out["lines"]
    assert out["result"]["correct"] is False, out["lines"]
    assert out["result"]["failed"] >= 1


# --- driven by data ----------------------------------------------------------

# a driver of another shape than the commit's: one caller checks a fixed
# batch of signatures through the program's batch seam, judged by OpenSSL
_BATCH_DRIVER = """
import time
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey, Ed25519PublicKey)


def inputs(config, traffic, seed, pool):
    n = int(traffic["batch"])
    keys = [Ed25519PrivateKey.from_private_bytes(
        bytes([seed % 251, i]) * 16) for i in range(n)]
    msgs = [b"m%d" % i for i in range(n)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[seed % n] = keys[seed % n].sign(b"another")
    triples = [(k.public_key().public_bytes_raw(), m, s)
               for k, m, s in zip(keys, msgs, sigs)]
    return lambda: triples


def build(triples, traffic, device):
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
    keys = [Ed25519PubKey(p) for p, _, _ in triples]

    def one():
        bv = batch.create_batch_verifier(keys[0], device=device)
        for key, (_, m, s) in zip(keys, triples):
            bv.add(key, m, s)
        return list(bv.verify()[1])
    return one


def warm(one, traffic):
    one()
    return {"calls": 1, "note": "one batch"}


def measure(one, seconds, seen):
    starts, ends, outs = [], [], []
    t_open = time.monotonic_ns()
    t1 = t_open
    while True:
        t0 = time.monotonic_ns()
        if t0 >= t_open + int(seconds * 1e9):
            break
        outs.append(one())
        t1 = time.monotonic_ns()
        starts.append(t0)
        ends.append(t1)
    return starts, ends, outs, t_open, t1


def judge(triples, outs, first, pool):
    def ok(pub, msg, sig):
        try:
            Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
            return True
        except InvalidSignature:
            return False
    want = [ok(*t) for t in triples]
    return [(i, out, want) for i, out in enumerate(outs) if out != want]
"""


def test_new_files_alone_add_a_cell(tmp_path):
    """A configuration, two traffic mixes (one of them for a driver of
    another shape), the driver and a per-layer metric, added as files
    and entries, run through the harness unchanged."""
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "drivers"):
        shutil.copytree(manifest.HERE / sub, bench_dir / sub)
    cfg = json.loads((manifest.HERE / "configs" /
                      "ed25519-175.json").read_text())
    cfg.update(name="ed25519-tiny", validators=5, chain_id="tiny-chain")
    (bench_dir / "configs" / "ed25519-tiny.json").write_text(
        json.dumps(cfg))
    mix = json.loads((manifest.HERE / "traffic" /
                      "commit_serial.json").read_text())
    mix.update(pool_heights=4, warm_settle_s=0)
    (bench_dir / "traffic" / "tiny_serial.json").write_text(json.dumps(mix))
    (bench_dir / "traffic" / "tiny_batch.json").write_text(
        json.dumps({"driver": "batch_once", "batch": 6}))
    (bench_dir / "drivers" / "batch_once.py").write_text(_BATCH_DRIVER)
    (bench_dir / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n"
        "    return None if run.trace is None else len(run.trace.calls)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "ed25519-tiny", "source": "test",
                             "file": "portbench/configs/ed25519-tiny.json",
                             "reduced": [], "why": "test"})
    for name, traffic in (("tiny", "tiny_serial"), ("tiny-batch",
                                                    "tiny_batch")):
        bench["workloads"].append({"name": name, "config": "ed25519-tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "commit_p95_ms",
                               "workloads": ["tiny", "tiny-batch"]})
    for name in ("tiny", "tiny-batch"):
        cell = manifest.cell(bench, name, root=tmp_path,
                             bench_dir=bench_dir)
        assert cell.config["validators"] == 5
        out = run.run_cell(cell, SEED, 2.0, True, device="cpu",
                           t_start=time.perf_counter())
        res = out["result"]
        assert res["correct"] is True, out["lines"]
        assert res["metrics"]["calls_traced"]["value"] == res["attempted"]
        assert res["metrics"]["seam_ms"]["value"] > 0
    # the metric is the new cells' alone
    assert all(m["name"] != "calls_traced"
               for m in manifest.cell(bench, CELLS[0]).per_layer)
    # and a broken batch seam fails the new driver's judge too
    out = run.run_cell(cell, SEED, 2.0, False, device="cpu",
                       t_start=time.perf_counter(),
                       plant=control.FAULTS["answer_flipped"])
    assert out["result"]["correct"] is False


# --- what the process loads ----------------------------------------------------

_LOADS = """
import sys, time
from portbench import manifest, run
cell = manifest.cell(manifest.load(), {name!r})
cell.config = dict(cell.config, validators=4)
cell.traffic = dict(cell.traffic, pool_heights=3, warm_settle_s=0)
out = run.run_cell(cell, 11, 0.5, {traced}, device="cpu",
                   t_start=time.perf_counter())
assert out["result"]["correct"], out["lines"]
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_loads_no_jax(traced):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", _LOADS.format(name=CELLS[0], traced=traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cometbft_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.commit, portbench.generator; "
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"cometbft_tpu_torch", "torch", *run.FORBIDDEN}


def test_forbidden_names_are_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "cometbft_tpu_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout


# --- the trace's arithmetic ---------------------------------------------------

def test_trace_attribution():
    calls = [tr.Call(100, 200), tr.Call(300, 400)]
    tr.assign(calls, [
        {"ts_ns": 150, "dur_ns": 40, "name": "batch_verify"},
        {"ts_ns": 150, "dur_ns": 10, "name": "host_prep",
         "attrs": {"batch": 3, "bucket": 4}},
        {"ts_ns": 170, "dur_ns": 20, "name": "kernel_execute"},
        {"ts_ns": 350, "dur_ns": 30, "name": "batch_verify"}])
    t = tr.Trace(calls, [("ed25519_verify_kernel", 172, 185),
                         ("memcpy", 180, 188), ("ed25519_verify_kernel",
                                                360, 370)], (100, 400))
    assert calls[0].total("batch_verify") == 40
    assert t.busy_intervals() == [[172, 188], [360, 370]]
    assert t.busy_s == pytest.approx(26e-9)
    assert t.aligned_share() == 1.0
    gaps = dict(t.idle_gaps())
    gaps = {k: round(v * 1e9) for k, v in t.idle_gaps()}
    assert gaps == {"walk": 60 + 70, "host_prep": 10, "batch_verify": 30,
                    "kernel_execute": 2 + 2, "harness": 100}
    assert sum(gaps.values()) == pytest.approx(300 - 26)
    r = tr.Run([100, 300], [200, 400], 3e-7, 1.0, t)
    for name in ("walk_ms", "seam_ms", "host_prep_us_per_sig", "pad_share",
                 "b1_roofline", "device_idle"):
        assert manifest.reader(manifest.HERE, name)(r) is not None
    assert manifest.reader(manifest.HERE, "pad_share")(r) == \
        pytest.approx(25.0)
    assert manifest.reader(manifest.HERE, "walk_ms")(r) == \
        pytest.approx((60 + 70) / 2 / 1e6)


def test_yardstick_is_frozen():
    assert yardstick.OPS_PER_SIG == 2039 * 328 + 1546 * 238
    assert yardstick.least_seconds(10_000) == pytest.approx(
        10_000 * yardstick.OPS_PER_SIG / 3.345e13, rel=1e-3)
    assert yardstick.p95(list(range(1, 101))) == pytest.approx(95.05)


# --- the manifest against the contract ----------------------------------------

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(_NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mix = json.loads((manifest.HERE / "traffic" /
                          f"{w['traffic']}.json").read_text())
        assert (manifest.HERE / "drivers" / f"{mix['driver']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and _UNIT.match(m["unit"])
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[-1],
         "--seed", str(2 ** 32 + 3), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["metrics"]["b1_roofline"]["value"] < 100
