"""The port's QA tool (cometbft_tpu_torch/tools/qa.py and
tools/fleet_report.py) against the JAX package's (cometbft_tpu/tools/
qa.py and the repository's tools/fleet_report.py) on the same inputs.

  * ``_setup_net``: names, zones, the peer graph through the latency
    relays (their count and delays), the 102-validator genesis with its
    powers, key types and consensus params, and each node's override
    file minus its ports, peers and keys (the log level is the port's
    declared departure);
  * the report's rules: ``_note_saturation``, ``_record_intervals``,
    ``_apply_dup_window``, ``_gate_dup_ratio``, ``_count_commit_sigs`` on
    seeded inputs; ``QAReport`` / ``LightserveReport`` keys;
  * the fleet analysis and its gate against the root
    ``tools/fleet_report.analyze`` on one fleet file;
  * the /proc sampler's keys and readings against psutil on a live
    child (the card's machine has no psutil; the CPU test machine has);
  * the spawn: ``cmd start`` with no CPU pin in its argv or environment,
    its log in ``<home>/node.log``; a child that exits on its own, or
    non-zero on SIGTERM, is a mismatch;
  * a process fleet whose full node runs under an unknown kernel name
    records it in ``mismatches`` (the children run a stub that installs
    the accept-all stand-in kernel and adds ``--device cpu``);
  * ``run_qa`` at the smallest depth on the accept-all stand-in kernel.
"""
import asyncio
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cometbft_tpu.tools import qa as r_qa
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.tools import fleet_report
from cometbft_tpu_torch.tools import qa
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]

# a node child for the CPU: the accept-all stand-in kernel, then the
# port's CLI with --device cpu added to start
STUB = """
import sys, torch
from cometbft_tpu_torch.ops import ed25519_kernel as ek, ed25519_kernel8 as ek8
def stand_in(mod):
    def verify_cols(a, r, s, k):
        mod.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    return verify_cols
ek.verify_cols = stand_in(ek)
ek8.verify_cols = stand_in(ek8)
from cometbft_tpu_torch.cmd.__main__ import main
argv = sys.argv[1:]
if "start" in argv:
    argv += ["--device", "cpu"]
sys.exit(main(argv))
"""


def _root_fleet_report():
    spec = importlib.util.spec_from_file_location(
        "root_fleet_report", REPO / "tools" / "fleet_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the net -----------------------------------------------------------------

def _net(mod, root, **kw):
    report = mod.QAReport()
    out = mod._setup_net(str(root), 4, 2, 10, report, **kw)
    return report, out


def _shape(mod, root, **kw):
    """What _setup_net decided, with keys and ports taken out."""
    report, (names, zones, cfgs, joiner_cfg, node_ids, p2p_port,
             relays) = _net(mod, root, **kw)
    by_id = {v: k for k, v in node_ids.items()}
    relay_to = {r.port: r for r in relays}
    peers = {}
    for name in names:
        row = []
        for entry in filter(None, cfgs[name].p2p.persistent_peers.split(",")):
            nid, addr = entry.split("@")
            port = int(addr.rsplit(":", 1)[1])
            if port in relay_to:
                r = relay_to[port]
                target = {v: k for k, v in p2p_port.items()}[r.target_port]
                row.append((by_id[nid], target, r.delay_s))
            else:
                row.append((by_id[nid], {v: k for k, v in p2p_port.items()}
                            [port], 0.0))
        peers[name] = row
    with open(cfgs[names[0]].base.path(cfgs[names[0]].base.genesis_file)) \
            as f:
        doc = json.load(f)
    vals = [(v["power"], v["pub_key"]["type"]) for v in doc["validators"]]
    cp = doc["consensus_params"]
    cfg = cfgs[names[0]]
    return {"names": names, "zones": zones, "peers": peers,
            "relays": sorted(r.delay_s for r in relays),
            "report": (report.validators_total, report.validators_live,
                       report.nodes),
            "validators": vals, "chain_id": doc["chain_id"],
            "params": (cp["block"]["max_bytes"], cp["evidence"]["max_bytes"],
                       cp["validator"]["pub_key_types"],
                       cp["feature"]["pbts_enable_height"]),
            "config": (cfg.base.db_backend, cfg.p2p.pex,
                       cfg.p2p.allow_duplicate_ip,
                       cfg.consensus.timeout_commit_ns,
                       cfg.consensus.adaptive_timeouts,
                       cfg.consensus.create_empty_blocks_interval_ns,
                       cfg.mempool.size,
                       cfg.p2p.max_packet_msg_payload_size),
            "joiner": joiner_cfg.base.moniker}


@pytest.mark.parametrize("kw", [{}, {"single_zone": True, "peer_degree": 3}],
                         ids=["zones", "ring"])
def test_setup_net_matches_the_jax_rig(tmp_path, kw):
    got = _shape(qa, tmp_path / "port", **kw)
    want = _shape(r_qa, tmp_path / "jax", **kw)
    assert got == want
    assert got["report"] == (4 + 10, 4, 7)
    assert got["validators"][:4] == [("100", "tendermint/PubKeyEd25519")] * 4
    # ghosts alternate ed25519 / secp256k1, power 1
    assert [t for _, t in got["validators"][4:6]] == [
        "tendermint/PubKeyEd25519", "tendermint/PubKeySecp256k1"]
    assert got["params"] == ("262144", "32768", ["ed25519", "secp256k1"],
                             "1")
    assert got["config"] == ("memdb", False, True, 200_000_000, True,
                             2_000_000_000, 20_000, 16384)
    if not kw:
        assert got["relays"] and set(got["relays"]) <= {0.05, 0.1, 0.15}


def test_node_overrides_match_the_jax_rig(tmp_path):
    files = {}
    for side, mod in (("port", qa), ("jax", r_qa)):
        _report, (names, _z, cfgs, joiner_cfg, *_rest) = _net(
            mod, tmp_path / side)
        mod._write_node_overrides(cfgs[names[1]])
        with open(os.path.join(cfgs[names[1]].base.home, "config",
                               "config.json")) as f:
            d = json.load(f)
        for section, key in (("p2p", "laddr"), ("p2p", "persistent_peers"),
                             ("rpc", "laddr")):
            assert d[section].pop(key)
        files[side] = d
    # a fleet's node logs its own info lines (the "Node stopped" line
    # with the launch counts) and every module's errors
    assert files["port"]["base"].pop("log_level") == "node:info,*:error"
    assert files["jax"]["base"].pop("log_level") == "error"
    assert files["port"] == files["jax"]


def test_zones_match_the_jax_rig():
    assert qa.ZONES == r_qa.ZONES
    assert qa.ZONE_LATENCY_MS == r_qa.ZONE_LATENCY_MS == {
        "zone-a:zone-b": 50, "zone-a:zone-c": 100, "zone-b:zone-c": 150}


# -- the report's rules ------------------------------------------------------

def _windows(mod, rng):
    out = []
    for _ in range(6):
        w = mod.WindowResult(rate=rng.choice([10, 25, 50, 100]),
                             duration_s=10.0)
        w.stalled = rng.random() < 0.2
        w.tx_per_s = rng.uniform(0, 120)
        out.append(w)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_report_rules_match(seed):
    got = {}
    for side, mod in (("port", qa), ("jax", r_qa)):
        rng = random.Random(seed)
        rep = mod.QAReport()
        for w in _windows(mod, rng):
            mod._note_saturation(rep, w, w.rate)
            before = (rng.uniform(0, 1e4), rng.uniform(0, 1e3))
            after = (before[0] + rng.choice([0, rng.uniform(0, 900)]),
                     before[1] + rng.uniform(0, 400))
            mod._apply_dup_window(w, before, after)
            rep.windows.append(w)
        mod._gate_dup_ratio(rep, (rng.uniform(0, 5e3), rng.uniform(0, 2e3)))
        secs = sorted(rng.uniform(0, 100) for _ in range(rng.randrange(0, 9)))
        mod._record_intervals(rep, secs)
        sigs = [None if rng.random() < 0.2 else
                {"block_id_flag": rng.choice([1, 2, 3])} for _ in range(102)]
        got[side] = (rep.to_dict(), mod._count_commit_sigs(sigs))
    port, jax = got["port"], got["jax"]
    for extra in ("node_launches", "first_block_s"):
        port[0].pop(extra)
    assert port == jax


def test_report_keys():
    port = set(qa.QAReport().to_dict())
    jax = set(r_qa.QAReport().to_dict())
    assert port - jax == {"node_launches", "first_block_s"}
    assert jax <= port
    assert set(qa.LightserveReport().to_dict()) == \
        set(r_qa.LightserveReport().to_dict())
    assert set(qa.WindowResult(1, 1.0).__dict__) == \
        set(r_qa.WindowResult(1, 1.0).__dict__)


# -- the fleet analysis --------------------------------------------------------

def _fleet_file(path, seed=5):
    """A fleet collection of three nodes over four heights: each node's
    clock offset and drift, a proposer's broadcast and propose span,
    proposal sightings, prevote and precommit arrivals by validator
    index, commits."""
    rng = random.Random(seed)
    nodes = {}
    for n in range(3):
        offset = rng.randrange(-10**9, 10**9)
        anchors = [[m, m + offset + m // 10**6]
                   for m in (10**9, 5 * 10**9, 9 * 10**9)]
        events = []
        for h in range(1, 5):
            t = 10**9 * h + rng.randrange(0, 10**8)
            if n == h % 3:
                events.append({"ts_ns": t, "category": "consensus",
                               "name": "proposal_broadcast", "height": h})
                events.append({"ts_ns": t - 10**7, "dur_ns": 10**7,
                               "category": "consensus",
                               "name": "step:Propose", "height": h})
            events.append({"ts_ns": t + rng.randrange(10**6, 10**8),
                           "category": "consensus",
                           "name": "proposal_recv", "height": h})
            for typ in (1, 2):
                for idx in rng.sample(range(4), 4):
                    events.append({"ts_ns": t + typ * 10**8 +
                                   rng.randrange(0, 10**8),
                                   "category": "consensus",
                                   "name": "vote_recv", "height": h,
                                   "attrs": {"index": idx, "type": typ}})
            events.append({"ts_ns": t + 4 * 10**8 + rng.randrange(0, 10**8),
                           "category": "consensus", "name": "commit",
                           "height": h})
            events.append({"ts_ns": t, "category": "p2p", "name": "dial",
                           "height": h})
        nodes[f"validator{n:02d}"] = {"node": f"id{n}", "anchors": anchors,
                                      "events": events}
    with open(path, "w") as f:
        json.dump({"nodes": nodes, "health": {}}, f)
    return str(path)


@pytest.mark.parametrize("opts", [{}, {"height": 3},
                                  {"powers": [10.0, 1.0, 1.0, 1.0]}],
                         ids=["all", "height", "powers"])
def test_fleet_analysis_matches_the_root_tool(tmp_path, opts):
    path = _fleet_file(tmp_path / "fleet.json")
    root = _root_fleet_report()
    got = fleet_report.analyze(fleet_report.load_inputs([path]), **opts)
    want = root.analyze(root.load_inputs([path]), **opts)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["heights"]


def test_fleet_gate_matches_the_jax_tool(tmp_path):
    path = _fleet_file(tmp_path / "fleet.json", seed=9)
    reps = {side: mod.QAReport() for side, mod in (("port", qa),
                                                   ("jax", r_qa))}
    qa._gate_fleet(reps["port"], path)
    r_qa._gate_fleet(reps["jax"], path)
    fields = ("prevote_t23_p95_s", "commit_skew_max_s", "degraded", "notes")
    assert [getattr(reps["port"], f) for f in fields] == \
        [getattr(reps["jax"], f) for f in fields]
    assert reps["port"].prevote_t23_p95_s > 0


# -- the /proc sampler ---------------------------------------------------------

def test_proc_sampler_reads_what_psutil_reads():
    psutil = pytest.importorskip("psutil")
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import time\nt = time.time()\nwhile time.time() - t < 0.6: pass\n"
         "time.sleep(30)"])
    try:
        sampler = qa._Sampler({"child": child})
        time.sleep(0.3)
        sampler.sample_once()
        time.sleep(0.2)
        sampler.sample_once()
        p = psutil.Process(child.pid)
        rss, _ticks, fds = qa._proc_sample(child.pid)
        assert abs(rss - p.memory_info().rss) < 4 * 2**20
        assert fds == p.num_fds()
        stats = sampler.window_stats(0.0, time.monotonic())
        assert set(stats) == {"rss_avg_mb", "rss_max_mb", "cpu_total_pct",
                              "fds_max"}
        assert stats["rss_max_mb"] > 1 and stats["fds_max"] >= 3
        # the busy loop: the first reading near one core
        assert sampler.samples[0][3] > 20
    finally:
        child.kill()
        child.wait()
    sampler.sample_once()           # a dead child is skipped
    assert len(sampler.samples) == 2


# -- the spawn -----------------------------------------------------------------

def test_a_child_runs_the_cli_on_the_card(tmp_path):
    home = str(tmp_path)
    argv = qa._node_argv(home)
    assert argv == [sys.executable, "-m", "cometbft_tpu_torch.cmd",
                    "--home", home, "start"]
    env = qa._node_env()
    assert "--device" not in argv
    assert "COMETBFT_TPU_CRYPTO_BACKEND" not in env or \
        env["COMETBFT_TPU_CRYPTO_BACKEND"] == \
        os.environ["COMETBFT_TPU_CRYPTO_BACKEND"]
    assert {k: v for k, v in env.items() if k != "PYTHONPATH"} == \
        {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(REPO)
    assert qa._node_env({"X": "1"})["X"] == "1"


def test_child_exits_are_mismatches(tmp_path, monkeypatch):
    """A child that exits on its own is a mismatch with its log's last
    line; one that exits non-zero on SIGTERM too; one that stops clean
    logs its launches."""
    script = (
        "import signal, sys, time\n"
        "mode = sys.argv[-1]\n"
        "print('starting', mode, flush=True)\n"
        "if mode == 'dies':\n"
        "    print('node stopped: ValueError: boom', file=sys.stderr)\n"
        "    sys.exit(1)\n"
        "def term(*a):\n"
        "    print('Node stopped b1_launches=7 b2_launches=2', flush=True)\n"
        "    sys.exit(2 if mode == 'unclean' else 0)\n"
        "signal.signal(signal.SIGTERM, term)\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n")
    procs = {}
    for mode in ("dies", "unclean", "clean"):
        home = tmp_path / mode
        home.mkdir()
        monkeypatch.setattr(qa, "NODE_CLI", [sys.executable, "-c", script])
        monkeypatch.setattr(qa, "_node_argv", lambda h, m=mode: [
            *qa.NODE_CLI, "--home", h, m])
        procs[mode] = qa._spawn_node(str(home))
        assert procs[mode].log_path == str(home / "node.log")
    procs["dies"].wait(30)
    for mode in ("unclean", "clean"):
        deadline = time.monotonic() + 30
        while "ready" not in Path(procs[mode].log_path).read_text():
            assert time.monotonic() < deadline
            time.sleep(0.05)
    rep, seen = qa.QAReport(), set()
    qa._note_exits(rep, procs, seen)
    assert rep.mismatches == [
        "dies: node process exited on its own with rc 1: node stopped: "
        "ValueError: boom"]
    qa._note_exits(rep, procs, seen)          # noted once
    asyncio.run(qa._stop_children(rep, procs, seen))
    assert rep.mismatches[1:] == [
        "unclean: node process exited with rc 2 on SIGTERM: Node stopped "
        "b1_launches=7 b2_launches=2"]
    assert rep.node_launches == {"unclean": {"b1": 7, "b2": 2},
                                 "clean": {"b1": 7, "b2": 2}}


def test_a_failing_child_fails_the_fleet(tmp_path, monkeypatch):
    """A 3-validator fleet (one full node, 20 ghosts, one window) whose
    full node runs under an unknown kernel name: the child exits 1 and
    the run records it; the others stop clean with B1 launches."""
    monkeypatch.setattr(qa, "NODE_CLI", [sys.executable, "-c", STUB])
    rep = asyncio.run(qa.run_qa_procs(
        str(tmp_path), n_validators=3, n_full=1, ghosts=20, rates=(25,),
        window_s=2.0, perturb=False, joiner=False, profile=False,
        device="cpu",
        child_env={"full00": {"COMETBFT_TPU_TORCH_KERNEL": "qa-test"}}))
    assert rep.mismatches == [
        "full00: node process exited on its own with rc 1: node stopped: "
        "ValueError: COMETBFT_TPU_TORCH_KERNEL='qa-test': expected one of "
        "['cuda', 'cuda8']"]
    assert len(rep.windows) == 1 and rep.windows[0].committed > 0
    assert rep.commit_sigs_min == 3        # 300 of 320 power: all three
    assert rep.first_block_s > 0
    live = {f"validator{i:02d}" for i in range(3)}
    assert live <= set(rep.node_launches)
    assert all(rep.node_launches[n]["b1"] > 0 for n in live)


# -- the in-process run ----------------------------------------------------------

def test_run_qa_at_the_smallest_depth(tmp_path, monkeypatch):
    """Two in-process validators on the CPU with the accept-all stand-in
    kernel, one 1 s load window, the state-sync joiner."""
    def stand_in(mod):
        def verify_cols(a, r, s, k):
            mod.launches += 1
            return torch.ones(a.shape[1], dtype=torch.bool)
        return verify_cols
    monkeypatch.setattr(ek, "verify_cols", stand_in(ek))
    monkeypatch.setattr(ek8, "verify_cols", stand_in(ek8))
    b1 = ek.launches
    rep = asyncio.run(qa.run_qa(str(tmp_path), n_validators=2, n_full=0,
                                ghosts=2, rates=(20,), window_s=1.0,
                                device="cpu"))
    assert rep.mismatches == []
    assert rep.nodes == 3 and rep.validators_total == 4
    assert len(rep.windows) == 1 and rep.windows[0].committed > 0
    assert rep.commit_sigs_heights > 0 and rep.commit_sigs_min == 2
    assert rep.final_height >= 2 and rep.block_interval_avg_s > 0
    assert ek.launches > b1
    assert rep.statesync_joiner_height > 0
    assert rep.degraded == []


def test_a_joiner_that_misses_its_target_is_a_mismatch(tmp_path,
                                                      monkeypatch):
    """A state-sync joiner that cannot reach the target fails the run:
    it lands in mismatches, not in degraded."""
    def stall(*_a, **_k):
        raise TimeoutError("the joiner stalled")
    monkeypatch.setattr(ek, "verify_cols",
                        lambda a, r, s, k: torch.ones(a.shape[1],
                                                      dtype=torch.bool))
    monkeypatch.setattr(qa, "_configure_joiner", stall)
    rep = asyncio.run(qa.run_qa(str(tmp_path), n_validators=2, n_full=0,
                                ghosts=0, rates=(10,), window_s=0.5,
                                device="cpu"))
    assert rep.mismatches == [
        "statesync_joiner: TimeoutError('the joiner stalled')"]
    assert rep.statesync_joiner_height == 0 and rep.degraded == []


def test_main_refuses_a_malformed_child_env():
    with pytest.raises(SystemExit, match="NAME:KEY=VALUE"):
        qa._child_env_arg(["full00=bad"])
    assert qa._child_env_arg(["a:K=v", "a:L=w=x", "b:K="]) == {
        "a": {"K": "v", "L": "w=x"}, "b": {"K": ""}}


def test_default_outputs_are_the_ports_own():
    src = (REPO / "cometbft_tpu_torch" / "tools" / "qa.py").read_text()
    for name in ("QA_r05.json", "QA_r06.json", "QA_quick.json",
                 "QA_sigscale.json"):
        assert f'"{name}"' not in src
    for name in ("QA_torch_quick.json", "QA_torch_sigscale.json",
                 "QA_torch_lightserve.json", "QA_torch.json"):
        assert f'"{name}"' in src


# -- chip_smoke.py's phase 20, rehearsed ---------------------------------------

@pytest.mark.slow
def test_phase_20_rehearsed_at_small_depth(monkeypatch):
    """Phase 20 as on the card, at small depth (~2.5 min here): the node
    processes run STUB, 20e's QA tool a stub that points its fleet at
    STUB and adds ``--device cpu``, "nvidia-smi" lists every live pid;
    20a and 20b run on the accept-all stand-in kernel, 20d on B1's plain
    version."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    qa_stub = (f"import sys\nfrom cometbft_tpu_torch.tools import qa\n"
               f"qa.NODE_CLI = [sys.executable, '-c', {STUB!r}]\n"
               f"sys.exit(qa.main(sys.argv[1:] + ['--device', 'cpu']))\n")
    monkeypatch.setattr(chip_smoke, "QA_CLI", [sys.executable, "-c", qa_stub])
    monkeypatch.setattr(qa, "NODE_CLI", [sys.executable, "-c", STUB])
    monkeypatch.setattr(chip_smoke, "_compute_apps", lambda: [
        int(d) for d in os.listdir("/proc") if d.isdigit()])
    for name, value in (("QA_VALIDATORS", 4), ("QA_FULL", 1),
                        ("QA_GHOSTS", 20), ("QA_RATES", (25, 25)),
                        ("QA_WINDOW_S", 3.0), ("QA_LS_CLIENTS", 40),
                        ("QA_FUZZ_S", 1.0), ("QA_MESH_LANES", 64),
                        ("QA_REPORT_LANES", 64),
                        ("QA_MESH_SPLIT_LANES", 50)):
        monkeypatch.setattr(chip_smoke, name, value)
    plain, real_mesh = ek.verify_cols, chip_smoke._qa_mesh

    def stand_in(a, r, s, k):
        ek.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)

    def mesh_on_plain(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(ek, "verify_cols", plain)
            return real_mesh(*args, **kw)
    monkeypatch.setattr(ek, "verify_cols", stand_in)
    monkeypatch.setattr(chip_smoke, "_qa_mesh", mesh_on_plain)
    b1 = chip_smoke._qa_phases(0, "CPU", device="cpu")
    assert set(b1) == {"qa_fleet_4+1", "qa_lightserve_4", "qa_mesh_64",
                       "qa_mesh_50x4"}
    assert b1["qa_fleet_4+1"] > 0 and b1["qa_lightserve_4"] > 0
