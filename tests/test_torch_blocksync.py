"""The port's block sync (blocksync/{pool,reactor,metrics}.py) against the
JAX package's, over the same seeded chain built in both packages
(tests/torch_chain.py):

  * tests/test_blocksync_evidence.py ``TestBlocksync`` (a fresh node syncs
    from a serving peer over sockets and calls ``on_caught_up``) run
    against the port;
  * one scripted sequence through both packages' ``BlockPool``s — peer
    ranges, adds (one from the wrong peer), a redo, a timeout on a fake
    clock and a removed peer — giving the same requests, redos, bans,
    peeks and caught-up verdicts;
  * the five block-sync messages byte-equal and cross-decoded, and
    ``convert.block_response``;
  * a port node syncing from a JAX server and a JAX node syncing from a
    port server over localhost sockets, their stores and states equal to
    the source's at the end;
  * chip_smoke.py's phase 14 (14a-14d) rehearsed at 12 validators, after
    phases 12 and 13 at their rehearsal sizes;
  * a kernel that raises in the sync routine: the sync stops, nothing
    restarts it, ``stop_sync`` raises it.

The port runs ``device="cpu"``; logic tests use the accept-all stand-in
kernel, the JAX package its ``cpu`` backend.  Every socket binds
``127.0.0.1:0``, every node is stopped in ``finally`` and every wait has
a bound.  Tolerance is byte equality.
"""
import asyncio
import os
from types import SimpleNamespace

import pytest
import torch

import cometbft_tpu.blocksync.metrics as r_bmetrics
import cometbft_tpu.blocksync.pool as r_pool
import cometbft_tpu.blocksync.reactor as r_bsync
from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.p2p.key import NodeKey as RNodeKey
from cometbft_tpu.p2p.switch import Switch as RSwitch
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types import vote as r_vote
from cometbft_tpu.wire import decode as r_decode
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.blocksync import metrics as p_bmetrics
from cometbft_tpu_torch.blocksync import pool as p_pool
from cometbft_tpu_torch.blocksync import reactor as p_bsync
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.p2p import NodeKey, Switch
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types import vote as p_vote
from cometbft_tpu_torch.wire import decode, encode
from torch_chain import RChain, accept_all, cs, port_chain, rows, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "bsync-parity"
STORE_STATE_KEY = b"\x06"
N, TOP = 5, 9


@pytest.fixture(autouse=True)
def _fresh():
    r_batch.set_backend("cpu")
    for mod in (p_vote, r_vote):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()
    yield
    r_batch.set_backend("auto")
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


@pytest.fixture
def stand_in(monkeypatch):
    return accept_all(monkeypatch)


@pytest.fixture(scope="module")
def chains():
    key_seeds = seeds(N, 151)
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        p = port_chain(CHAIN_ID, key_seeds)
        r = RChain(CHAIN_ID, key_seeds)
        p.states, r.states = {}, {}
        for h in range(1, TOP + 1):
            txs = [cs._load_tx(17, h, j) for j in range(4)]
            assert p.step(txs)[0].hash() == r.step(txs).hash()
            p.states[h], r.states[h] = p.state.bytes(), r.state.bytes()
    return {"port": p, "jax": r}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _until(pred, what, timeout=30.0, check=None):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if check is not None:
            check()
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


# -- nodes of either package ------------------------------------------------------

class _Fresh:
    """A fresh node from a chain's genesis: kvstore app after InitChain,
    MemDB stores, a block executor and a Switch with an active
    BlocksyncReactor that records the state it saves."""

    def __init__(self, name, doc, on_caught_up=None):
        self.name = name
        port = name == "port"
        self.app = (KVStoreApplication if port else RKVStore)()
        self.conns = (AppConns if port else RAppConns)(self.app)
        self.state_store = (Store if port else RStore)(
            (MemDB if port else RMemDB)())
        self.block_store = (BlockStore if port else RBlockStore)(
            (MemDB if port else RMemDB)())
        state = (make_genesis_state if port else r_make_genesis_state)(doc)
        self.state_store.save(state)
        self.doc, self.genesis = doc, state
        self.states = {}
        real = self.state_store.save

        def save(s):
            self.states[s.last_block_height] = s.bytes()
            real(s)
        self.state_store.save = save
        kw = {"device": "cpu"} if port else {}
        self.exec = (BlockExecutor if port else RBlockExecutor)(
            self.state_store, self.conns.consensus,
            block_store=self.block_store, **kw)
        self.reactor = (p_bsync if port else r_bsync).BlocksyncReactor(
            state, self.exec, self.block_store, active=True,
            on_caught_up=on_caught_up, **kw)
        self.switch = (Switch if port else RSwitch)(
            (NodeKey if port else RNodeKey).generate(), doc.chain_id,
            listen_addr="127.0.0.1:0")
        self.switch.add_reactor(self.reactor)

    async def start(self):
        if self.name == "port":
            await Handshaker(self.state_store, self.genesis,
                             self.block_store, self.doc,
                             device="cpu").handshake(self.conns)
        else:
            from cometbft_tpu.consensus.replay import Handshaker as RH
            await RH(self.state_store, self.genesis, self.block_store,
                     self.doc).handshake(self.conns)
        await self.switch.start()
        await self.reactor.start_sync()


async def _server(name, chain):
    port = name == "port"
    kw = {"device": "cpu"} if port else {}
    reactor = (p_bsync if port else r_bsync).BlocksyncReactor(
        chain.state, chain.exec, chain.block_store, active=False, **kw)
    sw = (Switch if port else RSwitch)(
        (NodeKey if port else RNodeKey).generate(), CHAIN_ID,
        listen_addr="127.0.0.1:0")
    sw.add_reactor(reactor)
    await sw.start()
    return sw


# -- tests/test_blocksync_evidence.py TestBlocksync, against the port -------------

def test_fresh_node_syncs_from_peer(chains, stand_in):
    src = chains["port"]

    async def go():
        caught_up = asyncio.Event()
        result = {}

        async def on_caught_up(state, height):
            result.update(state=state, height=height)
            caught_up.set()

        server = await _server("port", src)
        dst = _Fresh("port", src.doc, on_caught_up)
        await dst.start()
        try:
            await dst.switch.dial_peer(server.listen_addr)
            await asyncio.wait_for(caught_up.wait(), 30)
            assert dst.block_store.height >= TOP - 1
            for h in range(1, dst.block_store.height + 1):
                assert dst.block_store.load_block(h).hash() == \
                    src.block_store.load_block(h).hash()
            assert result["state"].last_block_height == \
                dst.block_store.height == result["height"]
            assert dst.reactor.pool is None
            assert dst.reactor.metrics.syncing.value == 0
            assert dst.reactor.metrics.latest_block_height.value == TOP - 1
        finally:
            await dst.reactor.stop_sync()
            await dst.switch.stop()
            await server.stop()
    run(go())


class _Growing:
    """The source chain seen up to a height that rises: what a block-sync
    server in a live net serves."""

    def __init__(self, chain, cap):
        import chip_smoke
        self.store = chip_smoke._CappedStore(chain.block_store, cap)
        self.state, self.exec = chain.state, chain.exec
        self.block_store = self.store


def test_joiner_switches_while_the_net_commits_faster_than_a_status_round(
        chains, stand_in):
    """A joiner syncing from a peer whose chain grows by a block every
    0.8 s (a status round is 2 s) switches to consensus once caught up,
    two status rounds after its sync began, while the peer still grows
    (reference: switchToConsensusTicker + IsCaughtUp).  The JAX reactor's
    rule, caught up held unbroken for two status rounds, never holds
    against such a peer: each round's StatusResponse reports a taller
    chain; the port's joiner switched only after the peer stopped at
    TOP (ROADMAP.md section C)."""
    src = chains["port"]

    async def go():
        caught = {}
        grow = _Growing(src, 2)

        async def on_caught_up(state, height):
            caught.update(height=height, cap=grow.store._cap,
                          t=asyncio.get_running_loop().time())

        server = await _server("port", grow)
        dst = _Fresh("port", src.doc, on_caught_up)
        await dst.start()
        t0 = asyncio.get_running_loop().time()
        try:
            await dst.switch.dial_peer(server.listen_addr)
            while grow.store._cap < TOP and "t" not in caught:
                await asyncio.sleep(0.8)
                grow.store._cap += 1
            await _until(lambda: "t" in caught, "the switch", timeout=15)
        finally:
            await dst.reactor.stop_sync()
            await dst.switch.stop()
            await server.stop()
        return caught, caught["t"] - t0
    caught, after_s = run(go())
    assert caught["cap"] < TOP, caught
    assert 2 * p_bsync._STATUS_UPDATE_INTERVAL_S <= after_s < 7.0, after_s
    assert caught["height"] >= 2


# -- the pools on one scripted sequence --------------------------------------------

def _script(pool_mod, monkeypatch):
    """Drive one BlockPool through peer ranges, adds, a redo, a timeout
    and a removed peer; return everything it did and said."""
    clock = [1000.0]
    monkeypatch.setattr(pool_mod, "time",
                        SimpleNamespace(monotonic=lambda: clock[0]))
    log = []

    def send(peer, height):
        log.append(("send", peer, height))
        return not (peer == "b" and height == 7)   # one full send queue

    def ban(peer, reason):
        log.append(("ban", peer, reason))

    def block(h):
        return SimpleNamespace(header=SimpleNamespace(height=h))

    async def go():
        p = pool_mod.BlockPool(3, send, ban)
        out = []

        def snap(tag):
            first, second, ext = p.peek_two_blocks()
            out.append((tag, p.height, p.max_peer_height(),
                        p.is_caught_up(), sorted(p.requesters),
                        sorted((r.height, r.peer_id, r.block is not None)
                               for r in p.requesters.values()),
                        sorted((q.peer_id, q.base, q.height, q.num_pending)
                               for q in p.peers.values()),
                        first and first.header.height,
                        second and second.header.height, ext))

        snap("empty")
        p._spawn_requesters()
        snap("no peers")
        p.set_peer_range("a", 1, 30)
        p.set_peer_range("b", 5, 50)
        p._spawn_requesters()
        snap("two peers")
        for h in (3, 4, 6):
            r = p.requesters[h]
            p.add_block(r.peer_id, block(h), None, 100)
        p.add_block("b", block(5), None, 100)          # not asked of b
        p.add_block(p.requesters[5].peer_id, block(5), None, 100)
        p.add_block("z", block(99), None, 100)         # no requester
        snap("adds")
        p.pop_request()
        p.pop_request()
        snap("popped")
        p.redo_request(5, "bad commit")
        snap("redo")
        p._spawn_requesters()
        snap("respawn")
        clock[0] += 11.0
        p._retry_timeouts()
        snap("timeout")
        p.remove_peer("a")
        p.set_peer_range("c", 1, 8)
        p._spawn_requesters()
        snap("peer c")
        for h in sorted(p.requesters):
            r = p.requesters[h]
            if r.peer_id and r.block is None:
                p.add_block(r.peer_id, block(h), None, 10)
        while p.requesters.get(p.height) is not None and \
                p.requesters[p.height].block is not None:
            p.pop_request()
        snap("drained")
        p.remove_peer("c")
        snap("no peers again")
        return out

    return run(go()), log


def test_both_pools_run_the_same_script(monkeypatch):
    ours = _script(p_pool, monkeypatch)
    theirs = _script(r_pool, monkeypatch)
    assert ours == theirs
    out, log = ours
    bans = [e for e in log if e[0] == "ban"]
    assert bans == [("ban", "a", "bad commit"),
                    ("ban", "b", "block request timed out")]
    assert [e for e in log if e[0] == "send" and e[1] == "c"] == \
        [("send", "c", 5), ("send", "c", 7), ("send", "c", 8)]
    # caught up only once c's range is drained, never without peers
    assert [tag for tag, _, _, caught, *_ in out if caught] == ["drained"]
    assert p_pool.MAX_PENDING_REQUESTS_PER_PEER == \
        r_pool.MAX_PENDING_REQUESTS_PER_PEER == 20


def test_wait_apply_wakes_on_add_and_times_out():
    async def go():
        p = p_pool.BlockPool(1, lambda *a: True, lambda *a: None)
        t = asyncio.get_running_loop().time()
        await p.wait_apply(timeout=0.05)
        assert asyncio.get_running_loop().time() - t >= 0.04
        p.set_peer_range("a", 1, 3)
        p._spawn_requesters()
        waiter = asyncio.ensure_future(p.wait_apply(timeout=5))
        await asyncio.sleep(0)
        p.add_block("a", SimpleNamespace(header=SimpleNamespace(height=1)),
                    None, 1)
        await asyncio.wait_for(waiter, 1)
    run(go())


# -- the five messages -------------------------------------------------------------

def test_messages_byte_equal_and_cross_decoded(chains):
    p, r = chains["port"], chains["jax"]
    h = 4
    msgs = [
        ({"block_request": {"height": 7}}, {"block_request": {"height": 7}}),
        ({"no_block_response": {"height": 9}},
         {"no_block_response": {"height": 9}}),
        ({"status_request": {}}, {"status_request": {}}),
        ({"status_response": {"height": TOP, "base": 1}},
         {"status_response": {"height": TOP, "base": 1}}),
        ({"block_response": {
            "block": p.block_store.load_block(h).to_proto(),
            "ext_commit": p.block_store.load_seen_commit(h)
            .wrapped_extended_commit().to_proto()}},
         {"block_response": {
             "block": r.block_store.load_block(h).to_proto(),
             "ext_commit": r.block_store.load_seen_commit(h)
             .wrapped_extended_commit().to_proto()}}),
        ({"block_response": {"block": p.block_store.load_block(h)
                             .to_proto()}},
         {"block_response": {"block": r.block_store.load_block(h)
                             .to_proto()}}),
    ]
    for ours, theirs in msgs:
        raw = encode(p_bsync.MESSAGE, ours)
        assert raw == r_encode(r_bsync.MESSAGE, theirs)
        assert encode(p_bsync.MESSAGE, r_decode(r_bsync.MESSAGE, raw)) == raw
        assert r_encode(r_bsync.MESSAGE, decode(p_bsync.MESSAGE, raw)) == raw
    assert p_bsync.BLOCKSYNC_CHANNEL == r_bsync.BLOCKSYNC_CHANNEL == 0x40
    theirs = msgs[4][1]["block_response"]
    block, ext = convert.block_response(
        r_encode(r_bsync.BLOCK_RESPONSE, theirs))
    assert block.hash() == p.block_store.load_block(h).hash()
    assert ext.to_commit().hash() == p.block_store.load_seen_commit(h).hash()
    block, ext = convert.block_response(msgs[5][1]["block_response"])
    assert ext is None and block.hash() == p.applied[h]


def test_channels_and_metrics_equal():
    ours = p_bsync.BlocksyncReactor(None, None, None, active=False,
                                    device="cpu")
    theirs = r_bsync.BlocksyncReactor(None, None, None, active=False)
    assert [(d.id, d.priority, d.send_queue_capacity)
            for d in ours.get_channels()] == \
        [(d.id, d.priority, d.send_queue_capacity)
         for d in theirs.get_channels()]
    pm, rm = p_bmetrics.Metrics(), r_bmetrics.Metrics()
    assert sorted(vars(pm)) == sorted(vars(rm))
    for k in vars(pm):
        assert getattr(pm, k).name == getattr(rm, k).name
        assert getattr(pm, k).help == getattr(rm, k).help


# -- mixed syncs over sockets ---------------------------------------------------------

@pytest.mark.parametrize("joiner,source", [("port", "jax"), ("jax", "port")])
def test_mixed_sync_over_sockets(chains, stand_in, joiner, source):
    """A node of one package syncs from a server of the other: the same
    blocks, seen commits, states and app hash as the source chain."""
    src = chains[source]

    async def go():
        server = await _server(source, src)
        dst = _Fresh(joiner, chains[joiner].doc)
        await dst.start()
        try:
            await dst.switch.dial_peer(server.listen_addr)
            await _until(lambda: dst.block_store.height >= TOP - 1,
                         "the mixed sync",
                         check=getattr(dst.reactor, "raise_if_failed", None))
        finally:
            await dst.reactor.stop_sync()
            await dst.switch.stop()
            await server.stop()
        return dst

    dst = run(go())
    ref_chain = chains[joiner]
    for h in range(1, TOP - 1):
        assert dst.block_store.load_block(h).hash() == \
            ref_chain.block_store.load_block(h).hash()
        assert dst.block_store.load_seen_commit(h).hash() == \
            ref_chain.block_store.load_seen_commit(h).hash()
        assert dst.states[h] == ref_chain.states[h]
    # every block store row of the synced heights is a row of the chain
    # the joiner's own package built, byte for byte; only the store's
    # state row (base and height) differs
    want = set(rows(ref_chain.dbs["block"]))
    got = rows(dst.block_store._db)
    extra = [kv for kv in got if kv not in want]
    assert len(got) > 4 * (TOP - 1)
    assert [k for k, _ in extra] == [STORE_STATE_KEY]


# -- the raising kernel ------------------------------------------------------------

def test_raising_kernel_stops_the_sync(chains, monkeypatch):
    def raising(*a, **kw):
        raise RuntimeError("stand-in kernel failure")

    monkeypatch.setattr(ek, "verify_cols", raising)
    src = chains["port"]

    async def go():
        server = await _server("port", src)
        dst = _Fresh("port", src.doc)
        await dst.start()
        task = dst.reactor._tasks[0]
        try:
            await dst.switch.dial_peer(server.listen_addr)
            await _until(lambda: dst.reactor.failure is not None,
                         "the kernel failure")
            await asyncio.sleep(0.3)
            assert not dst.reactor.pool.is_running
            with pytest.raises(RuntimeError, match="stand-in kernel"):
                dst.reactor.raise_if_failed()
            with pytest.raises(RuntimeError, match="stand-in kernel"):
                await dst.reactor.stop_sync()
        finally:
            await dst.switch.stop()
            await server.stop()
        return dst, task

    dst, task = run(go())
    assert task.restarts == 0 and task.gave_up
    assert dst.block_store.height == 0


def test_invalid_commit_is_redone_not_fatal(chains):
    """A VerificationError from B1's plain version (a flipped signature
    bit, no stand-in) is a redo of both heights with the JAX ban reason,
    never a failure of the sync."""
    src = chains["port"]
    from cometbft_tpu_torch.blocksync.reactor import BLOCKSYNC_CHANNEL, MESSAGE

    async def go():
        reactor = p_bsync.BlocksyncReactor(
            src.state, src.exec, src.block_store, active=False,
            device="cpu")

        def respond(peer, height):
            block = src.block_store.load_block(height)
            if height == 3:
                sig = block.last_commit.signatures[1]
                sig.signature = bytes([sig.signature[0] ^ 1]) + \
                    sig.signature[1:]
            peer.send(BLOCKSYNC_CHANNEL, encode(MESSAGE, {
                "block_response": {"block": block.to_proto()}}))
        reactor._respond_to_block_request = respond
        server = Switch(NodeKey.generate(), CHAIN_ID,
                        listen_addr="127.0.0.1:0")
        server.add_reactor(reactor)
        await server.start()
        dst = _Fresh("port", src.doc)
        bans = []
        dst.reactor._ban_peer = lambda peer, reason: bans.append(reason)
        await dst.start()
        try:
            await dst.switch.dial_peer(server.listen_addr)
            await _until(lambda: bans, "the ban", timeout=60,
                         check=dst.reactor.raise_if_failed)
        finally:
            await dst.reactor.stop_sync()
            await dst.switch.stop()
            await server.stop()
        return dst, bans

    dst, bans = run(go())
    assert dst.block_store.height == 1
    assert bans[0].startswith("wrong signature (#1): ")
    assert dst.reactor.failure is None


# -- chip_smoke.py's phase 14, rehearsed -------------------------------------------------

def test_phase_14_rehearsed_at_12_validators(monkeypatch):
    """Phases 12 and 13 at their rehearsal sizes with the accept-all
    stand-in kernel, then phase 14 with B1 replaced by a golden-model
    check that counts a launch a tile (so 14d's flipped signature is
    refused) and calls a kernel named ``raising`` when 14d installs one:
    a 6-height block sync at 12 validators, a 4-node evidence net, a
    lunatic attack of 5 of 12, a 4-node mempool net at 40 tx/s for 1 s
    and 5-height 14d syncs."""
    class SerialPool:
        def map(self, fn, items, chunksize=None):
            return [fn(x) for x in items]

    def stand_in(mod):
        def verify_cols(a, r, s, k):
            mod.launches += 1
            return torch.ones(a.shape[1], dtype=torch.bool)
        return verify_cols

    monkeypatch.setattr(ek, "verify_cols", stand_in(ek))
    monkeypatch.setattr(ek8, "verify_cols", stand_in(ek8))
    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    monkeypatch.setattr(cs, "_edge_items",
                        lambda seed, pool: [(bytes(32), b"m", bytes(64))])
    for name, value in (("EXEC_VALIDATORS", 12), ("CS_HEIGHTS", 6),
                        ("EXEC_UPDATES", (2, 3, 4)), ("CS_TRACED", 2),
                        ("NET_HEIGHTS", 3), ("HOST_INPUTS", 10),
                        ("HOST_TIMED", 3), ("SOCK_HEIGHTS", 5),
                        ("CATCHUP_HEIGHTS", 6), ("AEAD_INPUTS", 30),
                        ("LCA_COMMON", 2), ("LCA_CONFLICT", 4),
                        ("LOAD_RATE", 40), ("LOAD_SECONDS", 1.0),
                        ("MEMPOOL_HEIGHTS", 5), ("BSYNC_REJECT_HEIGHTS", 5),
                        ("BSYNC_BAD_HEIGHT", 2)):
        monkeypatch.setattr(cs, name, value)
    keep = {}
    cs._cs_phases(0, "CPU", SerialPool(), device="cpu", keep=keep)
    cs._p2p_phases(0, "CPU", keep, device="cpu")
    assert len(keep["catchup_ms"]) == 5

    memo = {}

    def verify_batch(items, device=None, **kw):
        mod = ek8 if os.environ.get(oe.KERNEL_ENV) == "cuda8" else ek
        if mod.verify_cols.__name__ == "raising":
            mod.verify_cols()
        mod.launches += len(tile_plan(len(items), DEFAULT_TILE))
        mask = []
        for item in items:
            if item not in memo:
                memo[item] = ref.verify(*item)
            mask.append(memo[item])
        return all(mask), mask

    monkeypatch.setattr(oe, "verify_batch", verify_batch)
    launches, launches8 = cs._sync_phases(0, "CPU", keep, device="cpu")
    assert set(launches) == {"blocksync_12x6", "evidence_dup_4",
                             "evidence_lca_12", "mempool_4x5",
                             "bsync_reject"}
    assert launches8 == {"bsync_5_cuda8": 9}
    # 14a: two launches a synced height, one for the switch's LastCommit
    assert launches["blocksync_12x6"] == 2 * 6 - 1 + 1
    assert launches["evidence_lca_12"] == 2
    assert launches["mempool_4x5"] > 0 and launches["evidence_dup_4"] > 0
    assert launches["bsync_reject"] > 0


def test_reactor_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_bsync.BlocksyncReactor(None, None, None, active=True)
