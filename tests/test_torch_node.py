"""The port's node (cometbft_tpu_torch/node/) against the JAX package's:

  * ``init_files`` with seeded keys and a fixed clock writes the JAX
    key, state, node-key and genesis bytes;
  * homes are interchangeable: a JAX node runs 5 heights with txs, the
    port's node starts on that home, handshakes and continues to 10, the
    JAX node continues on the port's home; the app hashes chain on;
  * a mixed net of two JAX and two port nodes commits with equal block
    ids and app hashes;
  * tests/test_node.py's single-node and two-node cases on the port;
  * the two leads settled before the node (ROADMAP.md section C): a
    validator that state-syncs over RPC names the net's proposer at its
    first consensus height, both when the net idles (one block to
    block-sync) and when it runs on (several); and a node whose socket app
    dies stops and raises from ``wait`` and ``stop``;
  * a library that fails to build surfaces from ``start``;
  * chip_smoke.py's phase 19 rehearsed at small depth, with ``cmd
    start`` processes on the CPU.

The port runs ``device="cpu"`` with the accept-all stand-in kernel (it
counts a launch), the JAX package its ``cpu`` backend.  Every node binds
127.0.0.1, is stopped in ``finally``, and every wait has a bound.
"""
import asyncio
import contextlib
import hashlib
import itertools
import os
import secrets
import shutil
import sys
import time

import pytest
import torch

import chip_smoke
from cometbft_tpu import config as r_config
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.node import Node as RNode
from cometbft_tpu.node import init_files as r_init_files
from cometbft_tpu.types import vote as r_vote_mod
from cometbft_tpu_torch import config as p_config
from cometbft_tpu_torch import confix as p_confix
from cometbft_tpu_torch.cmd.__main__ import main as p_main
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.node import Node, NodeError
from cometbft_tpu_torch.node import init_files as p_init_files
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.db import SQLiteDB
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types import vote as p_vote_mod
from torch_helpers import one_torch_thread  # noqa: F401

FIXED_NS = 1_700_000_000_123_456_789
FAST = {"timeout_propose_ns": 100_000_000,
        "timeout_propose_delta_ns": 10_000_000,
        "timeout_vote_ns": 50_000_000,
        "timeout_vote_delta_ns": 10_000_000}


def _stand_in(mod):
    def verify_cols(a, r, s, k):
        mod.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    return verify_cols


@pytest.fixture(autouse=True)
def _kernels(monkeypatch):
    """The accept-all stand-in for both kernels, the JAX package on its
    CPU backend, the memos and workers cleared around each test."""
    r_batch.set_backend("cpu")
    monkeypatch.setattr(ek, "verify_cols", _stand_in(ek))
    monkeypatch.setattr(ek8, "verify_cols", _stand_in(ek8))
    for mod in (p_vote_mod, r_vote_mod):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()
    yield
    r_batch.set_backend("auto")
    pipeline.reset_workers()


def run(coro, timeout=120.0):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


async def _until(pred, what, nodes=(), timeout=60.0):
    deadline = time.perf_counter() + timeout
    while not pred():
        for nd in nodes:
            if hasattr(nd, "raise_if_failed"):
                nd.raise_if_failed()
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: not reached in {timeout} s")
        await asyncio.sleep(0.01)


@contextlib.contextmanager
def _seeded(monkeypatch, seed):
    """Keys from ``seed`` (secrets.token_bytes) and a fixed clock."""
    ctr = itertools.count()
    with monkeypatch.context() as mp:
        mp.setattr(secrets, "token_bytes", lambda n=32: hashlib.sha512(
            b"%d/%d" % (seed, next(ctr))).digest()[:n])
        mp.setattr(time, "time_ns", lambda: FIXED_NS)
        yield


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


KEY_FILES = ("config/priv_validator_key.json",
             "data/priv_validator_state.json", "config/node_key.json",
             "config/genesis.json")


def test_init_files_write_the_jax_bytes(tmp_path, monkeypatch):
    out = {}
    for name, (cfg_mod, init) in {"port": (p_config, p_init_files),
                                  "jax": (r_config, r_init_files)}.items():
        cfg = cfg_mod.Config()
        cfg.base.home = str(tmp_path / name)
        with _seeded(monkeypatch, 7):
            doc = init(cfg, chain_id="init-chain")
            again = init(cfg, chain_id="other")   # files kept
        assert doc.chain_id == again.chain_id == "init-chain"
        out[name] = [_read(tmp_path / name / f) for f in KEY_FILES]
    assert out["port"] == out["jax"]


# -- homes and a mixed net ----------------------------------------------------

def _cfg(mod, home, **sections):
    """A package's config for ``home`` from its confix (the files ``cmd
    start`` reads), fast timeouts, quiet logs, RPC and p2p on free
    ports unless the home's config.json names them."""
    from cometbft_tpu import confix as r_confix
    cx = p_confix if mod is p_config else r_confix
    cfg = cx.effective_config(str(home))
    over = cx.load_overrides(str(home))
    cfg.base.log_level = "error"
    for k, v in FAST.items():
        setattr(cfg.consensus, k, v)
    if "p2p" not in over:
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
    if "rpc" not in over:
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
    for section, values in sections.items():
        for k, v in values.items():
            setattr(getattr(cfg, section), k, v)
    return cfg


def _make(pkg, cfg):
    return Node(cfg, device="cpu") if pkg == "port" else RNode(cfg)


async def _run_to(node, top, txs=()):
    """Start ``node``, feed ``txs`` through its mempool, run it to ``top``
    and stop it."""
    await node.start()
    try:
        for tx in txs:
            await node.mempool.check_tx(tx)
        await _until(lambda: node.height >= top, f"height {top}", [node])
    finally:
        await node.stop()


def test_homes_are_interchangeable(tmp_path):
    """JAX to 5, the port on that home to 10, the JAX node on the port's
    home to 13: every block's app hash is the previous height's result
    and its last block id the previous block, over both packages."""
    home = tmp_path / "home"
    cfg = _cfg(r_config, home)
    r_init_files(cfg, chain_id="swap-chain")
    run(_run_to(RNode(cfg), 5, [b"jax%d=v" % i for i in range(6)]))
    run(_run_to(Node(_cfg(p_config, home), device="cpu"), 10,
                [b"port%d=v" % i for i in range(6)]))
    run(_run_to(RNode(_cfg(r_config, home)), 13, [b"jax-again=v"]))
    blocks = BlockStore(SQLiteDB(str(home / "data" / "blockstore.db")))
    states = Store(SQLiteDB(str(home / "data" / "state.db")))
    top = blocks.height
    assert top >= 13
    txs = set()
    for h in range(1, top):
        nxt = blocks.load_block(h + 1)
        assert nxt.header.app_hash == \
            states.load_finalize_block_response(h).app_hash, h
        assert nxt.header.last_block_id.hash == blocks.load_block(h).hash()
        txs.update(blocks.load_block(h).data.txs)
    assert {b"jax0=v", b"port5=v", b"jax-again=v"} <= txs


def _testnet(tmp_path, n, chain_id):
    """``cmd testnet --v n`` on free ports: the homes."""
    out = str(tmp_path / "net")
    p2p, rpc = chip_smoke._free_port_base(n), chip_smoke._free_port_base(n)
    assert p_main(["testnet", "--v", str(n), "--o", out, "--chain-id",
                   chain_id, "--starting-p2p-port", str(p2p),
                   "--starting-rpc-port", str(rpc)]) == 0
    return [os.path.join(out, f"node{i}") for i in range(n)]


def test_mixed_net_commits_with_equal_ids_and_app_hashes(tmp_path, capsys):
    homes = _testnet(tmp_path, 4, "mixed-node-net")
    pkgs = ["jax", "port", "jax", "port"]

    async def go():
        nodes = [_make(pkg, _cfg(p_config if pkg == "port" else r_config,
                                 h)) for pkg, h in zip(pkgs, homes)]
        try:
            for nd in nodes:
                await nd.start()
            await _until(lambda: min(nd.height for nd in nodes) >= 2,
                         "height 2 everywhere", nodes)
            for i in range(8):
                await nodes[i % 4].mempool.check_tx(b"mixed%d=%d" % (i, i))
            await _until(lambda: min(nd.height for nd in nodes) >= 6,
                         "height 6 everywhere", nodes)
        finally:
            for nd in nodes:
                await nd.stop()
        return nodes
    nodes = run(go())
    txs = set()
    for h in range(1, 7):
        metas = [nd.block_store.load_block_meta(h) for nd in nodes]
        assert len({m.block_id.hash for m in metas}) == 1, h
        assert len({m.header.app_hash for m in metas}) == 1, h
        txs.update(nodes[1].block_store.load_block(h).data.txs)
    assert {b"mixed%d=%d" % (i, i) for i in range(8)} <= txs


# -- tests/test_node.py's cases on the port -----------------------------------

async def _rpc_call(port, method, params=None):
    """tests/test_node.py's raw JSON-RPC POST."""
    import json
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                       "params": params or {}}).encode()
    writer.write(b"POST / HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 b"Content-Length: " + str(len(body)).encode() +
                 b"\r\nConnection: close\r\n\r\n" + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.partition(b"\r\n\r\n")[2])


def test_init_start_rpc(tmp_path):
    """tests/test_node.py TestSingleNode.test_init_start_rpc on the port."""
    import base64

    async def go():
        cfg = _cfg(p_config, tmp_path)
        p_init_files(cfg, chain_id="rpc-chain")
        node = Node(cfg, device="cpu")
        await node.start()
        try:
            port = node._rpc_server.port
            await _until(lambda: node.height >= 2, "height 2", [node])
            st = await _rpc_call(port, "status")
            assert st["result"]["node_info"]["network"] == "rpc-chain"
            assert int(st["result"]["sync_info"]
                       ["latest_block_height"]) >= 2
            h = await _rpc_call(port, "health")
            assert h["result"]["status"] == "ok"
            assert int(h["result"]["height"]) >= 2
            assert h["result"]["catching_up"] is False
            assert h["result"]["n_peers"] == "0"
            ai = await _rpc_call(port, "abci_info")
            assert int(ai["result"]["response"]["last_block_height"]) >= 1
            tx = base64.b64encode(b"city=zion").decode()
            r = await _rpc_call(port, "broadcast_tx_commit", {"tx": tx})
            assert r["result"]["tx_result"]["code"] == 0
            committed_h = int(r["result"]["height"])
            q = await _rpc_call(port, "abci_query", {"data": "city"})
            assert base64.b64decode(
                q["result"]["response"]["value"]) == b"zion"
            blk = await _rpc_call(port, "block",
                                  {"height": str(committed_h)})
            assert tx in blk["result"]["block"]["data"]["txs"]
            br = await _rpc_call(port, "block_results",
                                 {"height": str(committed_h)})
            assert br["result"]["txs_results"][0]["code"] == 0
            vals = await _rpc_call(port, "validators")
            assert vals["result"]["total"] == "1"
            cm = await _rpc_call(port, "commit", {"height": "1"})
            assert cm["result"]["signed_header"]["header"][
                "chain_id"] == "rpc-chain"
            ni = await _rpc_call(port, "net_info")
            assert ni["result"]["n_peers"] == "0"
            bad = await _rpc_call(port, "no_such_method")
            assert bad["error"]["code"] == -32601
            # the node's own registry and the kernels' families at /metrics
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n"
                         b"Connection: close\r\n\r\n")
            raw = await asyncio.wait_for(reader.read(), 10)
            writer.close()
            assert b"cometbft_consensus_height" in raw
        finally:
            await node.stop()
    run(go())


def test_restart_continues(tmp_path):
    cfg = _cfg(p_config, tmp_path)
    p_init_files(cfg, chain_id="restart")
    run(_run_to(Node(cfg, device="cpu"), 3))
    first = Node(_cfg(p_config, tmp_path), device="cpu")
    h0 = first.height
    assert h0 >= 3
    run(_run_to(first, h0 + 3))


def test_double_sign_protection(tmp_path):
    """The FilePV state a node leaves refuses a vote below the height it
    last signed, across a reload (tests/test_node.py's height regression,
    on a node's own files)."""
    from cometbft_tpu_torch.privval import DoubleSignError, FilePV
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import Vote
    cfg = _cfg(p_config, tmp_path)
    p_init_files(cfg, chain_id="dsign")
    run(_run_to(Node(cfg, device="cpu"), 3))
    pv = FilePV.load(cfg.base.path(cfg.base.priv_validator_key_file),
                     cfg.base.path(cfg.base.priv_validator_state_file))
    lss = pv.last_sign_state
    assert lss.height >= 3
    v = Vote(type=canonical.PREVOTE_TYPE, height=lss.height - 1,
             round=0, block_id=BlockID(b"\x07" * 32, PartSetHeader(
                 1, b"\x08" * 32)), timestamp=Timestamp.now(),
             validator_address=pv.get_pub_key().address(), validator_index=0)
    with pytest.raises(DoubleSignError):
        pv.sign_vote("dsign", v, False)


def test_a_library_that_fails_to_build_surfaces_at_start(tmp_path,
                                                          monkeypatch):
    from cometbft_tpu_torch.ops import _build
    cfg = _cfg(p_config, tmp_path)
    p_init_files(cfg, chain_id="nobuild")

    def broken():
        raise RuntimeError("g++ failed: chacha20poly1305.cpp")
    monkeypatch.setattr(_build, "load_aead", broken)
    node = Node(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        run(node.start())
    assert node.consensus_state is None and node.height == 0


# -- the two leads ------------------------------------------------------------

def test_a_dead_socket_app_stops_the_node(tmp_path):
    """Lead 2: the app process killed under a running node.  The node's
    failure names the dead connection; ``wait`` and ``stop`` raise it;
    consensus commits no further height."""
    sock_dir = chip_smoke.tempfile.mkdtemp(prefix="tn-", dir="/tmp")
    app = chip_smoke._AppProc(sock_dir, "app").start()
    try:
        cfg = _cfg(p_config, tmp_path, base={"abci": "socket",
                                             "proxy_app": app.address})
        p_init_files(cfg, chain_id="dead-app")

        async def go():
            node = Node(cfg, device="cpu")
            await node.start()
            try:
                await _until(lambda: node.height >= 2, "height 2", [node])
                app.proc.kill()
                with pytest.raises(NodeError, match="ABCI client connection "
                                   "terminated"):
                    await asyncio.wait_for(node.wait(), 30)
                h = node.height
                await asyncio.sleep(0.3)
                assert node.height == h
            finally:
                with pytest.raises(NodeError, match="did the application "
                                   "crash"):
                    await node.stop()
        run(go())
    finally:
        app.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)


def _votes_of(node):
    """Record every vote ``node``'s FilePV signs: (height, round, type,
    block hash)."""
    pv, seen = node.priv_validator, []
    real = pv.sign_vote

    def sign_vote(chain_id, vote, sign_extension):
        seen.append((vote.height, vote.round, vote.type,
                     vote.block_id.hash))
        return real(chain_id, vote, sign_extension)
    pv.sign_vote = sign_vote
    return seen


def test_rpc_state_sync_joiner_names_the_nets_proposer(tmp_path):
    """Lead 1, at 5 validators of equal power with 4 live.  The fifth
    state-syncs over the RPC of two of them (the proposers of its sets
    by findPreviousProposer), block-syncs and joins.  Idle net (blocks
    only for txs, the tip two above the snapshot): one block to
    block-sync, its first consensus height the net's tip.  Then a net
    that runs on: several blocks to sync.  Either way the joiner names the
    net's proposer at its first consensus height (the round it commits
    at and the joiner's round-0 prevote are recorded: a height whose
    round-0 proposer is the absent fifth goes to round 1 in any case)."""
    homes = _testnet(tmp_path, 5, "lead-chain")
    live, joiner_home = homes[:4], homes[4]
    outcome = {}

    async def join(nodes, name, consensus):
        urls = [f"http://{nd._rpc_server.listen_addr}" for nd in nodes[:2]]
        from cometbft_tpu_torch.rpc.client import HTTPClient
        com = await HTTPClient(urls[0]).call("commit", height=2)
        peers = ",".join(f"{nd.node_key.id}@{nd.switch.listen_addr}"
                         for nd in nodes)
        cfg = _cfg(p_config, joiner_home, p2p={
            "laddr": "tcp://127.0.0.1:0", "persistent_peers": peers},
            statesync={"enable": True, "rpc_servers": urls,
                       "trust_height": 2,
                       "trust_hash": com["signed_header"]["commit"][
                           "block_id"]["hash"],
                       "discovery_time_ns": 500_000_000},
            consensus=consensus)
        joiner = Node(cfg, device="cpu")
        votes, trace = _votes_of(joiner), {}
        try:
            await chip_smoke._node_join_run(joiner, trace)
            await _until(lambda: "switch_state" in trace,
                         f"{name}: the switch", [joiner] + nodes)
            h0 = trace["switch_state"].last_block_height + 1
            await _until(lambda: joiner.height >= h0, f"{name}: {h0}",
                         [joiner] + nodes)
            # a height the joiner votes in
            await nodes[0].mempool.check_tx(b"%s=1" % name.encode())
            await _until(lambda: joiner.height >= h0 + 1 and min(
                nd.height for nd in nodes) >= h0 + 2,
                f"{name}: {h0 + 2}", [joiner] + nodes)
            at, mine, theirs, rounds = chip_smoke._node_join_outcome(
                joiner, nodes[0], trace)
            first_vote = min(h for h, _, _, _ in votes)
            prevote = [b for h, r, t, b in votes if (h, r, t) == (
                first_vote, 0, canonical.PREVOTE_TYPE)]
            outcome[name] = dict(h0=at, same=mine == theirs,
                                 rounds=rounds, first_vote=first_vote,
                                 nil=prevote == [b""],
                                 base=joiner.block_store.base)
        finally:
            await joiner.stop()
        return joiner

    async def go():
        nodes = [Node(_cfg(p_config, h, consensus={
            "create_empty_blocks": False}), device="cpu") for h in live]
        try:
            for nd in nodes:
                await nd.start()
            # an idle net: one block a tx, to two above the snapshot at 10
            for i in range(12):
                await nodes[i % 4].mempool.check_tx(b"idle%d=1" % i)
                await _until(lambda: min(nd.height for nd in nodes) >= i + 1,
                             f"idle height {i + 1}", nodes)
            await join(nodes, "idle", {"create_empty_blocks": False})
            # the net runs on: blocks without txs
            for nd in nodes:
                nd.consensus_state.config.create_empty_blocks = True
            await nodes[0].mempool.check_tx(b"wake=1")
            top = max(nd.height for nd in nodes)
            await _until(lambda: min(nd.height for nd in nodes) >= top + 12,
                         "the live net 12 heights on", nodes)
            # the same validator again, on a fresh home with its key files
            for sub in ("data", "config/addrbook.json"):
                path = os.path.join(joiner_home, sub)
                shutil.rmtree(path, ignore_errors=True)
            os.makedirs(os.path.join(joiner_home, "data"))
            await join(nodes, "live", {})
        finally:
            for nd in nodes:
                await nd.stop()
    run(go(), timeout=240.0)
    idle, live_ = outcome["idle"], outcome["live"]
    print(outcome)
    for o in (idle, live_):
        assert o["same"], o
    # idle: the snapshot at 10, block 11 synced, consensus at 12 = the
    # net's tip, decided before the joiner came; the first height it votes
    # in, it prevotes the block at round 0
    assert idle["h0"] == 12 and idle["base"] == 11, idle
    assert idle["first_vote"] >= 12 and not idle["nil"], idle
    # live: a later snapshot and several blocks synced.  Whether the
    # joiner's round-0 prevote at its first height is nil depends on
    # whether the proposal reached it before its propose timeout, not on
    # the proposer, which is the net's
    assert live_["h0"] > idle["h0"] + 10 and live_["base"] > 11, live_


# -- chip_smoke.py's phase 19, rehearsed on the CPU ---------------------------

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


def test_phase_19_rehearsed_at_small_depth(monkeypatch):
    """Phase 19 as on the card, at small depth: the ``cmd`` processes run
    a stub that installs the stand-in kernel and adds ``--device cpu`` to
    ``start``; "nvidia-smi" lists every live pid."""
    monkeypatch.setattr(chip_smoke, "NODE_CLI", [sys.executable, "-c", STUB])
    monkeypatch.setattr(chip_smoke, "_compute_apps", lambda: [
        int(d) for d in os.listdir("/proc") if d.isdigit()])
    for name, value in (("NODE_CLI_HEIGHTS", 4), ("NODE_LOAD_RATE", 20),
                        ("NODE_LOAD_SECONDS", 1.0),
                        ("NODE_INPROC_HEIGHTS", 4), ("NODE_JOIN_TRUST", 2),
                        ("NODE_JOIN_DISCOVERY_NS", 500_000_000),
                        ("MANIFEST_TARGET", 6), ("MANIFEST_TIMEOUT_S", 18.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    b1, b2 = chip_smoke._node_phases(0, "CPU", {}, device="cpu")
    assert set(b1) == {"node_4x4", "node_inproc_4x4", "node_rpc_join",
                       "manifest_e2e"}
    assert all(v > 0 for v in b1.values()), b1
    assert b2["node_inproc_4_cuda8"] > 0
