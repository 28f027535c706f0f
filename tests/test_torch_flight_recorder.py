"""The port's flight recorder black box (cometbft_tpu_torch/libs/
tracing.py) against the JAX package's (cometbft_tpu/libs/tracing.py):

  * for the same events both recorders dump a JSON record with the same
    keys and the same events once the clock fields are masked
    (``ts_ns`` / ``dur_ns`` of spans timed on the clock, ``wall_time``,
    ``monotonic_ns`` and the anchors' values); instants, ``note``,
    heights, categories, the node id and ``extra`` are exact;
  * ``anchors`` keeps the first pair and the newest ``ANCHORS_MAX - 1``;
  * where a dump lands: the recorder's ``dump_dir``, else
    ``$COMETBFT_TPU_TORCH_DUMP_DIR``, else the temp dir, never the
    working directory; a dump that cannot be written returns "" and
    never raises;
  * a supervisor that gives up (budget spent, or a fatal error) writes
    one and logs its path; ``/debug/pprof/trace?dump=1`` writes one and
    answers its ``dump_path``;
  * a Node points the recorder at its data dir, or at
    ``instrumentation.dump_dir``, with its anchor interval.
"""
import asyncio
import json
import os

import pytest
import torch

from cometbft_tpu.libs import supervisor as r_supervisor
from cometbft_tpu.libs import tracing as r_tracing
from cometbft_tpu_torch import config as p_config
from cometbft_tpu_torch.libs import pprof
from cometbft_tpu_torch.libs import supervisor
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.node import Node
from cometbft_tpu_torch.node import init_files
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _fresh_recorders(monkeypatch, tmp_path):
    monkeypatch.delenv(tracing.DUMP_DIR_ENV, raising=False)
    monkeypatch.delenv("COMETBFT_TPU_DUMP_DIR", raising=False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    tracing.configure()
    r_tracing.configure()
    yield
    tracing.configure()
    r_tracing.configure()


def _story(trc, node_id: str):
    """The same events on either package's process-global recorder."""
    trc.configure(buffer_size=4, node_id=node_id, anchor_interval_s=30.0)
    trc.set_height(5)
    trc.record_span(trc.CRYPTO, "kernel_execute", 1_000, 1_700, lanes=64)
    with trc.span(trc.CONSENSUS, "step", height=6, step="propose") as sp:
        sp.note(round=2)
    trc.instant(trc.P2P, "vote_recv", peer="ab")
    trc.instant(trc.SUPERVISOR, "giveup", height=3, task="t")
    for i in range(6):                       # the ring keeps 4
        trc.record_span(trc.MEMPOOL, f"m{i}", 2_000 + i, 2_010 + i)
    with trc.span("off-list", "x"):
        pass
    return trc.recorder()


def _masked(rec: dict) -> dict:
    out = dict(rec, wall_time="W", monotonic_ns=0,
               anchors=[[0, 0]] * len(rec["anchors"]))
    events = []
    for ev in rec["events"]:
        ev = dict(ev)
        if ev["name"] in ("step", "vote_recv", "giveup", "x"):
            ev["ts_ns"] = 0                  # timed on the clock
            if ev["name"] in ("step", "x"):
                ev["dur_ns"] = 0
        events.append(ev)
    out["events"] = sorted(events, key=lambda e: (e["category"],
                                                  e["name"]))
    return out


def test_dump_matches_reference(tmp_path):
    """Exact equality of the two records once the clock fields are
    masked."""
    mine = _story(tracing, "node-a")
    ref = _story(r_tracing, "node-a")
    extra = {"task": "t", "restarts": 2}
    p = mine.dump(reason="why not?", path=str(tmp_path / "p.json"),
                  extra=extra)
    q = ref.dump(reason="why not?", path=str(tmp_path / "q.json"),
                 extra=extra)
    assert (p, q) == (str(tmp_path / "p.json"), str(tmp_path / "q.json"))
    got, want = (json.loads(open(x).read()) for x in (p, q))
    assert list(got) == ["reason", "wall_time", "monotonic_ns", "pid",
                         "node", "anchors", "extra", "events"]
    assert list(got) == list(want)
    assert _masked(got) == _masked(want)
    assert [e["name"] for e in got["events"]
            if e["category"] == "mempool"] == ["m2", "m3", "m4", "m5"]
    step = next(e for e in got["events"] if e["name"] == "step")
    assert step["attrs"] == {"step": "propose", "round": 2}
    assert step["height"] == 6
    assert mine.last_dump_path == p
    assert not os.path.exists(p + ".tmp")


def test_default_path_names_pid_seq_and_reason(tmp_path):
    r = tracing.Recorder(dump_dir=str(tmp_path / "d"))
    first = r.dump(reason="supervisor giveup/x")
    second = r.dump()
    pid = os.getpid()
    assert first == str(tmp_path / "d" /
                        f"flight-{pid}-001-supervisor-giveup-x.json")
    assert second == str(tmp_path / "d" / f"flight-{pid}-002-flight.json")
    assert json.loads(open(second).read())["reason"] == ""


def test_anchors_keep_the_first_and_the_newest(monkeypatch):
    clock = iter(range(10**9, 10**12, 10**9))
    monkeypatch.setattr(tracing, "now_ns", lambda: next(clock))
    r = tracing.Recorder(anchor_interval_s=0.5)
    first = r.anchors[0]
    for _ in range(tracing.Recorder.ANCHORS_MAX + 10):
        r.record_instant(tracing.P2P, "tick", 0, None)
    assert len(r.anchors) == tracing.Recorder.ANCHORS_MAX
    assert r.anchors[0] == first
    monos = [a[0] for a in r.anchors]
    assert monos == sorted(monos)
    tracing.set_recorder(r)
    assert tracing.anchors() == r.anchors and tracing.anchors() is not \
        r.anchors


def test_set_recorder_swaps_and_returns_the_old():
    mine = tracing.Recorder(node_id="x")
    old = tracing.set_recorder(mine)
    try:
        tracing.instant(tracing.P2P, "e")
        assert [e["name"] for e in mine.snapshot()] == ["e"]
        assert old.snapshot() == []
    finally:
        assert tracing.set_recorder(old) is mine


def test_dump_dir_resolution(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = tracing.Recorder()
    assert r.resolved_dump_dir() == str(tmp_path / "tmp")
    monkeypatch.setenv(tracing.DUMP_DIR_ENV, str(tmp_path / "env"))
    assert r.resolved_dump_dir() == str(tmp_path / "env")
    path = r.dump(reason="env")
    assert os.path.dirname(path) == str(tmp_path / "env")
    # the JAX package's variable is not the port's
    monkeypatch.delenv(tracing.DUMP_DIR_ENV)
    monkeypatch.setenv("COMETBFT_TPU_DUMP_DIR", str(tmp_path / "jax"))
    assert r.resolved_dump_dir() == str(tmp_path / "tmp")
    r.dump_dir = str(tmp_path / "own")
    assert r.resolved_dump_dir() == str(tmp_path / "own")
    assert not [f for f in os.listdir(tmp_path) if f.startswith("flight")]


def test_a_dump_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    r = tracing.Recorder(dump_dir=str(blocker / "sub"))
    assert r.dump(reason="blocked") == ""
    assert r.last_dump_path == ""
    r = tracing.Recorder(dump_dir=str(tmp_path))
    r.record_instant(tracing.P2P, "bad", 0, {"raw": object()})
    assert r.dump(reason="unserialisable") == ""
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".json")]


# -- the supervisor's give-up ------------------------------------------------

def _giveup(mod, trc, fatal):
    """Run a loop that crashes until its supervisor gives up; returns
    the supervisor's error log lines."""
    lines = []

    class _Log:
        def __getattr__(self, name):
            return lambda msg, **kw: lines.append((name, msg, kw))

    async def go():
        sup = mod.Supervisor("node", logger=_Log(),
                             sleep=lambda s: asyncio.sleep(0))

        async def crash():
            trc.instant(trc.CRYPTO, "before_crash")
            raise RuntimeError("kernel launch failed")

        kw = {"fatal": lambda e: True} if fatal else {}
        st = sup.spawn(crash, name="verify", kind="verify_worker",
                       policy=mod.RestartPolicy(max_restarts=1), **kw)
        try:
            await st.wait()
        except RuntimeError:
            assert fatal
        await sup.stop()
    asyncio.run(go())
    return [ln for ln in lines if ln[0] == "error"]


@pytest.mark.parametrize("fatal", [False, True], ids=["budget", "fatal"])
def test_a_giveup_writes_a_flight_record(tmp_path, fatal):
    tracing.configure(dump_dir=str(tmp_path / "data"), node_id="n1")
    errors = _giveup(supervisor, tracing, fatal)
    dumped = [kw["path"] for lvl, msg, kw in errors
              if msg == "flight record dumped"]
    assert len(dumped) == 1
    (name,) = os.listdir(tmp_path / "data")
    assert dumped == [str(tmp_path / "data" / name)]
    assert name.endswith("-supervisor_giveup_node_verify_worker.json")
    rec = json.loads(open(dumped[0]).read())
    assert rec["node"] == "n1"
    assert rec["extra"] == {"supervisor": "node", "task": "verify",
                            "kind": "verify_worker",
                            "restarts": 0 if fatal else 1,
                            "error": "RuntimeError('kernel launch "
                                     "failed')"}
    names = [e["name"] for e in rec["events"]]
    assert names.count("before_crash") == (1 if fatal else 2)
    assert names[-1] == "giveup"


def test_giveup_record_matches_reference(tmp_path):
    """The budget give-up's record in both packages: the same reason,
    extra and event names (exact)."""
    recs = []
    for mod, trc, d in ((supervisor, tracing, "p"),
                        (r_supervisor, r_tracing, "r")):
        trc.configure(dump_dir=str(tmp_path / d))
        _giveup(mod, trc, fatal=False)
        (name,) = os.listdir(tmp_path / d)
        recs.append(json.loads(open(tmp_path / d / name).read()))
    mine, ref = recs
    for k in ("reason", "extra", "node"):
        assert mine[k] == ref[k]
    assert [(e["category"], e["name"], e.get("attrs"))
            for e in mine["events"]] == \
        [(e["category"], e["name"], e.get("attrs"))
         for e in ref["events"]]


# -- the node, /trace?dump=1 -------------------------------------------------

def _stand_in(mod):
    def verify_cols(a, r, s, k):
        mod.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    return verify_cols


def _node_cfg(home, **instrumentation):
    cfg = p_config.Config()
    cfg.base.home = str(home)
    cfg.base.log_level = "error"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    for k, v in instrumentation.items():
        setattr(cfg.instrumentation, k, v)
    init_files(cfg, chain_id="flight-chain")
    return cfg


@pytest.mark.parametrize("dump_dir", ["", "dumps", "ABS"])
def test_the_node_points_the_recorder(tmp_path, dump_dir):
    if dump_dir == "ABS":
        dump_dir = str(tmp_path / "abs")
    cfg = _node_cfg(tmp_path, dump_dir=dump_dir,
                    trace_anchor_interval_s=2.5)
    Node(cfg, device="cpu")
    r = tracing.recorder()
    want = cfg.base.path(dump_dir) if dump_dir else \
        cfg.base.path(cfg.base.db_dir)
    assert r.dump_dir == r.resolved_dump_dir() == want
    assert r.anchor_interval_ns == 2_500_000_000
    assert r.node_id and len(r.node_id) == 12


async def _http_get(port: int, target: str) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return raw.partition(b"\r\n\r\n")[2]


def test_node_giveup_and_trace_dump(tmp_path, monkeypatch):
    """A node's supervised task that gives up leaves a record in the data
    dir; ``/debug/pprof/trace?dump=1`` writes another and names it;
    without ``dump=1`` the route writes nothing."""
    monkeypatch.setattr(ek, "verify_cols", _stand_in(ek))
    monkeypatch.setattr(ek8, "verify_cols", _stand_in(ek8))
    cfg = _node_cfg(tmp_path, pprof_listen_addr="127.0.0.1:0")
    data = cfg.base.path(cfg.base.db_dir)

    async def go():
        node = Node(cfg, device="cpu")
        await node.start()
        try:
            async def crash():
                tracing.instant(tracing.CRYPTO, "crash_mark")
                raise RuntimeError("boom")
            st = node.supervisor.spawn(
                crash, name="crasher", kind="crasher",
                policy=supervisor.RestartPolicy(max_restarts=0))
            await st.wait()
            port = int(node._pprof_server.listen_addr.rsplit(":", 1)[1])
            plain = json.loads(await _http_get(port, "/debug/pprof/trace"))
            assert "dump_path" not in plain and plain["enabled"]
            body = json.loads(await _http_get(
                port, "/debug/pprof/trace?dump=1"))
        finally:
            await node.stop()
        return body

    body = asyncio.run(go())
    flights = sorted(f for f in os.listdir(data) if f.startswith("flight-"))
    assert len(flights) == 2
    assert flights[0].endswith("-supervisor_giveup_node_crasher.json")
    assert flights[1].endswith("-pprof_request.json")
    assert body["dump_path"] == os.path.join(data, flights[1])
    giveup = json.loads(open(os.path.join(data, flights[0])).read())
    assert giveup["node"] == tracing.recorder().node_id
    assert "crash_mark" in [e["name"] for e in giveup["events"]]
    assert pprof._trace_dump(False).startswith("{")
