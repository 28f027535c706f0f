"""The port's record readers (cometbft_tpu_torch/tools/trace_report.py
and fleet_report.py) against the JAX package's tools:

  * tests/test_tracing.py's TestTraceReport cases on the port's recorder;
  * ``analyze`` gives the rows of the repository's tools/trace_report.py
    (floats to 1e-9) and ``render_report`` its text on three records: a
    synthetic one made from a seed, the record of a live 4-validator port
    net on the CPU and the record of a live 4-validator JAX net; the
    port's ``prep_pack`` and ``prep_c`` spans, nested in ``host_prep``,
    stay out of ``verify_ms`` as the reference leaves them;
  * TestLiveNetTrace's counterpart: ``/trace?height=2`` of the port's
    4-validator net over real sockets holds consensus step spans, a
    ``batch_verify`` of at least two signatures under the port's backend
    name, p2p ``send`` and ``recv``, ordered timestamps, and the report
    renders ``gossip_ms``;
  * ``python -m cometbft_tpu_torch.tools.trace_report`` and ``python -m
    cometbft_tpu_torch.tools.fleet_report`` render a saved ``/trace``
    body as the JAX tools do.

The port's nodes run ``device="cpu"`` with the accept-all stand-in
kernel, the JAX nodes the JAX package's ``cpu`` backend.
"""
import asyncio
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.libs import tracing as r_tracing
from cometbft_tpu.rpc import core as r_core
from cometbft_tpu.types import vote as r_vote_mod
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.tracing import Recorder
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.rpc import core as p_core
from cometbft_tpu_torch.tools import fleet_report
from cometbft_tpu_torch.tools import trace_report
from cometbft_tpu_torch.types import vote as p_vote_mod
from test_torch_reactor import (PNode, RNode, _doc, _mesh, _stop_all,
                                _stand_in, _wait_all_height)
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    """The repository's tools/<name>.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R_TRACE = _load("trace_report")
R_FLEET = _load("fleet_report")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture
def recorder(tmp_path):
    """A fresh process-global port recorder; the old one afterwards."""
    old = tracing.set_recorder(Recorder(buffer_size=65536,
                                        dump_dir=str(tmp_path)))
    yield tracing.recorder()
    tracing.set_recorder(old)


# -- tests/test_tracing.py's TestTraceReport on the port ----------------------

class TestTraceReport:
    def test_per_height_breakdown(self, recorder):
        base = tracing.now_ns()
        tracing.record_span(tracing.CONSENSUS, "step:Propose",
                            base, base + 10_000_000, height=4)
        recorder.record_instant(tracing.CONSENSUS,
                                "proposal_complete", 4, None)
        tracing.record_span(tracing.CRYPTO, "batch_verify",
                            base + 2_000_000, base + 5_000_000,
                            height=4, batch=128, backend="cpu")
        tracing.record_span(tracing.ABCI, "consensus/finalize_block",
                            base + 6_000_000, base + 9_000_000,
                            height=4)
        tracing.record_span(tracing.CONSENSUS, "save_block",
                            base + 9_000_000, base + 9_500_000,
                            height=4)
        record = {"events": tracing.snapshot()}
        rows = trace_report.analyze(record)
        assert 4 in rows
        r = rows[4]
        assert r["verify_ms"] == pytest.approx(3.0)
        assert r["execute_ms"] == pytest.approx(3.0)
        assert r["commit_ms"] == pytest.approx(0.5)
        assert r["batches"][0]["batch"] == 128
        assert r["batches"][0]["backend"] == "cpu"
        text = trace_report.render_report(record)
        assert "verify_ms" in text and "batch=128" in text

    def test_heightless_events_attributed_by_window(self, recorder):
        base = tracing.now_ns()
        tracing.record_span(tracing.CONSENSUS, "step:Prevote",
                            base, base + 10_000_000, height=9)
        # a crypto span with NO height, inside height 9's window
        recorder.record(tracing.CRYPTO, "kernel_execute",
                        base + 1_000_000, base + 2_000_000, -1, None)
        evs = tracing.snapshot()
        for e in evs:       # strip the height for the crypto event
            if e["category"] == "crypto":
                e["height"] = 0
        rows = trace_report.analyze({"events": evs})
        assert rows[9]["verify_ms"] == pytest.approx(1.0)


# -- tests/test_tracing.py's TestTraceRPC, against the reference's route -------

_ROUTE_EVENTS = [
    ("consensus", "commit", 100, 100, 12, None),
    ("p2p", "send", 110, 110, 13, {"bytes": 40}),
    ("crypto", "kernel_execute", 90, 140, 12,
     {"batch": 3, "bucket": 64, "kernel": "cuda", "warm": True}),
    ("consensus", "step:Propose", 90, 95, 12, {"round": 0}),
    ("p2p", "recv", 120, 120, 0, None),
    ("abci", "consensus/commit", 130, 135, 13, None),
]


@pytest.mark.parametrize("params", [
    {}, {"height": "12"}, {"height": "0", "category": "p2p"},
    {"limit": "2"}, {"category": "crypto", "limit": "1"},
    {"height": "x", "limit": "y"}, {"category": "nemesis"}])
def test_trace_route_answers_as_the_reference(params):
    """The same events in both packages' recorders: the port's /trace
    route answers each query as the JAX route does (count, events,
    int64s as strings, the filters), and its body renders."""
    bodies = []
    for mod, core in ((tracing, p_core), (r_tracing, r_core)):
        old = mod.set_recorder(mod.Recorder(buffer_size=64))
        try:
            for cat, name, start, end, h, attrs in _ROUTE_EVENTS:
                mod.recorder().record(cat, name, start, end, h, attrs)
            bodies.append(run(core.routes(None)["trace"](**params)))
        finally:
            mod.set_recorder(old)
    mine, theirs = bodies
    for key in ("enabled", "count", "events", "node"):
        assert mine[key] == theirs[key], key
    assert trace_report.render_report(mine) == R_TRACE.render_report(theirs)


# -- the records both tools read ----------------------------------------------

def _synthetic(seed=2323):
    """A record made from ``seed``: six heights of every category, nested
    crypto spans (the port's prep_pack / prep_c in host_prep in
    batch_verify), height-less events inside and outside the windows,
    stalls, markers, int64s as strings on some events, a reason and
    conflicting heights."""
    rng = np.random.default_rng(seed)
    events = []

    def ev(cat, name, ts, dur, h, **attrs):
        e = {"ts_ns": int(ts), "dur_ns": int(dur), "category": cat,
             "name": name, "height": int(h)}
        if attrs:
            e["attrs"] = attrs
        if rng.random() < 0.3:      # the route's int64-as-string form
            e = {**e, "ts_ns": str(e["ts_ns"]), "dur_ns": str(e["dur_ns"]),
                 "height": str(e["height"])}
        events.append(e)

    t = 1_000_000_000
    for h in range(1, 7):
        lo = t
        ev("consensus", "step:NewHeight", t, rng.integers(1e5, 1e6), h)
        ev("consensus", "step:Propose", t + 1e6, rng.integers(1e6, 2e7), h)
        for name in ("proposal_recv", "proposal_received", "block_part_recv",
                     "vote_recv", "vote_recv", "compact_block_miss",
                     "pipeline_advance"):
            if rng.random() < 0.8:
                ev("consensus", name, t + rng.integers(1e6, 3e7), 0, h)
        if h != 4:                  # height 4 falls back on step:Propose
            ev("consensus", "proposal_complete",
               t + rng.integers(5e6, 2e7), 0, h)
        for _ in range(int(rng.integers(1, 4))):
            b0 = t + rng.integers(2e7, 4e7)
            n = int(rng.integers(2, 200))
            stamp = 0 if rng.random() < 0.4 else h
            ev("crypto", "batch_verify", b0, 4e6, stamp, batch=n,
               backend="cpu")
            ev("crypto", "host_prep", b0 + 1e5, 2e6, stamp, batch=n,
               bucket=64, pipelined=False)
            ev("crypto", "prep_pack", b0 + 2e5, 5e5, stamp, batch=n)
            ev("crypto", "prep_c", b0 + 8e5, 1e6, stamp, batch=n, bucket=64)
            ev("crypto", "kernel_execute", b0 + 2.2e6, 1.5e6, stamp,
               batch=n, bucket=64, kernel="cuda", warm=True)
        if h == 2:
            ev("crypto", "kernel_compile", t + 3e7, 9e6, h, bucket=64)
        ev("consensus", "validate_block", t + 4.5e7, rng.integers(1e5, 1e6),
           h)
        ev("abci", "consensus/finalize_block", t + 4.6e7, 3e6, h)
        ev("abci", "consensus/commit", t + 5e7, 1e6, 0)
        for name in ("send", "recv", "send", "send_queue_full",
                     "send_rate_stall"):
            ev("p2p", name, t + rng.integers(0, 6e7), 0,
               0 if rng.random() < 0.5 else h,
               bytes=int(rng.integers(10, 5000)))
        ev("consensus", "save_block", t + 5.2e7, 2e6, h)
        ev("consensus", "step:Commit", t + 5.4e7, 4e6, h)
        ev("consensus", "apply_block", t + 5.9e7, 8e6, h)
        ev("consensus", "barrier_wait", t + 6.5e7, rng.integers(0, 3e6), h)
        ev("consensus", "commit", t + 6e7, 0, h)
        ev("mempool", "txs_recv", t + 1e7, 0, h, peer="p")
        t = lo + 7e7
    ev("crypto", "batch_verify", t + 5e8, 1e6, 0, batch=7, backend="cpu")
    ev("p2p", "recv", 10, 0, 0, bytes=3)      # before every window
    rng.shuffle(events)
    return {"reason": "synthetic", "wall_time": "2026-01-01T00:00:00Z",
            "node": "synthetic", "anchors": [[1_000_000_000, 5e18]],
            "extra": {"conflicting_heights": [3]}, "events": events}


def _port_net_records():
    """A live 4-validator port net over sockets to height 3 on the
    stand-in kernel: (route body of height 2, route body of the run)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ek, "verify_cols", _stand_in(ek))
        p_vote_mod._VERIFIED.clear()
        p_vote_mod._REJECTED.clear()
        old = tracing.set_recorder(Recorder(buffer_size=65536))
        try:
            doc, pvs = _doc(4, chain_id="trace-net")
            nodes = [PNode(doc, pv) for pv in pvs]

            async def go():
                for n in nodes:
                    await n.start()
                try:
                    await _mesh(nodes)
                    await _wait_all_height(nodes, 3)
                finally:
                    await _stop_all(nodes)
                routes = p_core.routes(None)
                return (await routes["trace"](height="2"),
                        await routes["trace"]())
            return run(go())
        finally:
            tracing.set_recorder(old)
            pipeline.reset_workers()
            oe.reset_bucket_tuning()


def _jax_net_record():
    """tests/test_tracing.py's live 4-validator JAX net to height 3 on
    the JAX package's cpu backend: the route body of the run."""
    from cometbft_tpu.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu.types.priv_validator import new_mock_pv
    from cometbft_tpu.types.timestamp import Timestamp
    r_batch.set_backend("cpu")
    r_vote_mod._VERIFIED.clear()
    r_vote_mod._REJECTED.clear()
    old = r_tracing.set_recorder(r_tracing.Recorder(buffer_size=65536))
    try:
        pvs = [new_mock_pv() for _ in range(4)]
        doc = GenesisDoc(
            chain_id="trace-net-jax", genesis_time=Timestamp(1700000000, 0),
            validators=[GenesisValidator(address=b"",
                                         pub_key=pv.get_pub_key(), power=10)
                        for pv in pvs])
        nodes = [RNode(doc, pv) for pv in pvs]

        async def go():
            for n in nodes:
                await n.start()
            try:
                await _mesh(nodes)
                await _wait_all_height(nodes, 3)
            finally:
                await _stop_all(nodes)
            return await r_core.routes(None)["trace"]()
        return run(go())
    finally:
        r_tracing.set_recorder(old)
        r_batch.set_backend("auto")


@pytest.fixture(scope="module")
def records():
    height2, port_run = _port_net_records()
    return {"synthetic": _synthetic(), "port_net": port_run,
            "port_net_h2": height2, "jax_net": _jax_net_record()}


# -- the port's tool gives the reference's rows --------------------------------

def _same(a, b, where="rows"):
    """a == b, floats to 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=0, abs_tol=1e-9), (where, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("height", [None, 2, 4])
@pytest.mark.parametrize("name", ["synthetic", "port_net", "port_net_h2",
                                  "jax_net"])
def test_rows_equal_the_reference_tools(records, name, height):
    record = records[name]
    mine = trace_report.analyze(record, height=height)
    theirs = R_TRACE.analyze(record, height=height)
    if name != "port_net_h2" or height in (None, 2):
        assert mine      # the height-2 body holds no other height
    _same(mine, theirs)
    assert trace_report.render_report(record, height=height) == \
        R_TRACE.render_report(record, height=height)


def test_the_synthetic_record_covers_every_column(records):
    rows = trace_report.analyze(records["synthetic"])
    assert sorted(rows) == [1, 2, 3, 4, 5, 6]
    for key in ("gossip_ms", "verify_ms", "execute_ms", "commit_ms",
                "pipeline_ms", "p2p_events", "p2p_bytes", "stalls"):
        assert all(r[key] > 0 for r in rows.values()), key
    assert any(r["markers"].get("compact_block_miss") for r in rows.values())
    text = trace_report.render_report(records["synthetic"])
    assert "conflicting-commit heights: [3]" in text
    assert "flight record: synthetic" in text


def test_the_port_net_record_holds_the_nested_verify_spans(records):
    """The port's prep_pack and prep_c sit inside host_prep, which sits
    inside batch_verify; verify_ms sums the reference's names only, which
    already count that time twice; adding the two would count it a third
    time."""
    events = records["port_net"]["events"]
    names = {e["name"] for e in events if e["category"] == "crypto"}
    assert {"batch_verify", "host_prep", "prep_pack", "prep_c",
            "kernel_execute"} <= names
    assert "prep_pack" not in trace_report._VERIFY_NAMES
    assert "prep_c" not in trace_report._VERIFY_NAMES
    spans = [(int(e["ts_ns"]), int(e["ts_ns"]) + int(e["dur_ns"]), e["name"])
             for e in events if e["category"] == "crypto"]
    preps = [s for s in spans if s[2] == "host_prep"]
    for lo, hi, name in spans:
        if name in ("prep_pack", "prep_c"):
            assert any(a <= lo and hi <= b for a, b, _ in preps), name
    leaf = sum(int(e["dur_ns"]) for e in events
               if e["name"] in ("prep_pack", "prep_c")) / 1e6
    rows = trace_report.analyze(records["port_net"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace_report, "_VERIFY_NAMES",
                   trace_report._VERIFY_NAMES | {"prep_pack", "prep_c"})
        wider = trace_report.analyze(records["port_net"])
    extra = sum(wider[h]["verify_ms"] - rows[h]["verify_ms"] for h in rows)
    assert leaf > 0
    assert extra == pytest.approx(leaf, abs=1e-6)


# -- tests/test_tracing.py's TestLiveNetTrace on the port ----------------------

def test_trace_height_timeline_on_live_port_net(records):
    """/trace?height=2 of a running 4-validator port net over real
    sockets: consensus step spans, a batch_verify dispatch of at least two
    signatures under the port's backend name, p2p send and recv, all
    ordered by monotonic timestamp; the report renders this height."""
    evs = records["port_net_h2"]["events"]
    names = [(e["category"], e["name"]) for e in evs]
    assert any(n.startswith("step:") for c, n in names
               if c == "consensus"), names
    batch = [e for e in evs if e["category"] == "crypto"
             and e["name"] == "batch_verify"]
    assert batch, names
    assert batch[0]["attrs"]["batch"] >= 2
    assert batch[0]["attrs"]["backend"] == "cpu"     # the device's type
    assert any(c == "p2p" and n == "send" for c, n in names)
    assert any(c == "p2p" and n == "recv" for c, n in names)
    ts = [int(e["ts_ns"]) for e in evs]
    assert ts == sorted(ts)
    report = trace_report.render_report(records["port_net"], height=2)
    assert "gossip_ms" in report


# -- the CLIs ------------------------------------------------------------------

def _cli(module, *args):
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_trace_report_cli_renders_a_saved_trace_body(records, tmp_path):
    path = tmp_path / "node0.json"
    path.write_text(json.dumps(records["port_net"]))
    record = json.loads(path.read_text())
    mod = "cometbft_tpu_torch.tools.trace_report"
    assert _cli(mod, str(path)) == R_TRACE.render_report(record)
    assert _cli(mod, str(path), "--height", "2") == \
        R_TRACE.render_report(record, height=2)
    got = json.loads(_cli(mod, str(path), "--json"))
    _same(got, json.loads(json.dumps(R_TRACE.analyze(record))))


def test_fleet_report_cli_renders_saved_trace_bodies(records, tmp_path):
    paths = []
    for name in ("port_net", "synthetic"):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(records[name]))
        paths.append(str(path))
    mod = "cometbft_tpu_torch.tools.fleet_report"
    for extra, height, powers in (([], None, None),
                                  (["--height", "2"], 2, None),
                                  (["--powers", "10,1,1,1"], None,
                                   [10.0, 1.0, 1.0, 1.0])):
        want = R_FLEET.render_report(R_FLEET.analyze(
            R_FLEET.load_inputs(paths), height=height, powers=powers))
        assert _cli(mod, *paths, *extra) == want
    text = _cli(mod, paths[0])
    assert text.startswith("fleet: 1 nodes (port_net)")
    got = json.loads(_cli(mod, paths[0], "--json"))
    want = json.loads(json.dumps(R_FLEET.analyze(
        R_FLEET.load_inputs(paths[:1]))))
    _same(got, want)
    mine = fleet_report.analyze(fleet_report.load_inputs(paths[:1]))
    assert fleet_report.render_report(mine) == text
