"""The port's state sync (statesync/{syncer,reactor,metrics}.py) against
the JAX package's, over the same seeded chain built in both packages
(tests/torch_chain.py, with the kvstore taking a snapshot every
``INTERVAL`` heights):

  * tests/test_statesync_pex.py ``TestStatesync`` (a fresh app restores a
    single validator's snapshot over sockets while its chain goes on) run
    against the port;
  * a twin state sync at 12 validators over sockets in each package and
    across them (a port joiner from a JAX server and the other way):
    sync_any through a light client over the chain's stores, the state
    store's bootstrap and the seen commit, then block sync of the tail —
    the same state-store, block-store and app rows at the bootstrap and
    after the tail in every pairing;
  * the four statesync messages byte-equal and cross-decoded, and what
    each package's reactor answers to the same requests;
  * ``ChunkQueue``'s discard and sender tracking, and a Syncer whose app
    bans a sender and asks for a chunk again, step for step in both;
  * each of chip_smoke.py's 15c outcomes with the JAX text: a format the
    app refuses, a chunk off its hash and a chunk never served (each
    rejected, then the good snapshot), a snapshot at the tip, a flipped
    signature bit in light block H+1 (the golden model in B1's place), a
    raising stand-in kernel (port only: it surfaces with nothing
    bootstrapped);
  * chip_smoke.py's phase 15 rehearsed at 12 validators.

The port runs ``device="cpu"``; logic tests use the accept-all stand-in
kernel, the JAX package its ``cpu`` backend.  Every socket binds
``127.0.0.1:0``, every node is stopped in ``finally`` and every wait has
a bound.  Equality is exact.
"""
import asyncio
import os
import sys
from types import SimpleNamespace

import pytest

import cometbft_tpu.statesync.metrics as r_smetrics
import cometbft_tpu.statesync.reactor as r_reactor
import cometbft_tpu.statesync.syncer as r_syncer
from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.blocksync import reactor as r_bsync
from cometbft_tpu.consensus.replay import Handshaker as RHandshaker
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.light import client as r_light
from cometbft_tpu.light.provider import NodeProvider as RNodeProvider
from cometbft_tpu.light.store import TrustedStore as RTrustedStore
from cometbft_tpu.p2p.key import NodeKey as RNodeKey
from cometbft_tpu.p2p.switch import Switch as RSwitch
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types import vote as r_vote
from cometbft_tpu.wire import decode as r_decode
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.blocksync import reactor as p_bsync
from cometbft_tpu_torch.config import test_config as _test_config
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.light import client as p_light
from cometbft_tpu_torch.light.provider import NodeProvider
from cometbft_tpu_torch.light.store import TrustedStore
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.p2p import NodeKey, Switch
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.statesync import StateProvider, StatesyncReactor
from cometbft_tpu_torch.statesync import metrics as p_smetrics
from cometbft_tpu_torch.statesync import reactor as p_reactor
from cometbft_tpu_torch.statesync import syncer as p_syncer
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types import vote as p_vote
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.priv_validator import new_mock_pv
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.wire import decode, encode
from torch_chain import RChain, accept_all, cs, port_chain, rows, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "ss-parity"
N, TOP = 12, 14
INTERVAL = 5          # snapshots at 5 and 10; the sync restores 10
SNAP = 10
TRUST = 6
PERIOD_NS = 10 * 365 * 24 * 3600 * 10**9   # the chain is stamped in 2023

P = SimpleNamespace(
    name="port", abci=abci, AppConns=AppConns, KVStore=KVStoreApplication,
    MemDB=MemDB, Store=Store, BlockStore=BlockStore, genesis=make_genesis_state,
    Executor=BlockExecutor, bsync=p_bsync, syncer=p_syncer,
    reactor=p_reactor, light=p_light, NodeProvider=NodeProvider,
    TrustedStore=TrustedStore, Switch=Switch, NodeKey=NodeKey,
    kw={"device": "cpu"})
R = SimpleNamespace(
    name="jax", abci=r_abci, AppConns=RAppConns, KVStore=RKVStore,
    MemDB=RMemDB, Store=RStore, BlockStore=RBlockStore,
    genesis=r_make_genesis_state, Executor=RBlockExecutor, bsync=r_bsync,
    syncer=r_syncer, reactor=r_reactor, light=r_light,
    NodeProvider=RNodeProvider, TrustedStore=RTrustedStore, Switch=RSwitch,
    NodeKey=RNodeKey, kw={})
SIDES = {"port": P, "jax": R}


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


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _until(pred, what, timeout=30.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


@pytest.fixture(scope="module")
def chains():
    key_seeds = seeds(N, 181)
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        p = port_chain(CHAIN_ID, key_seeds)
        r = RChain(CHAIN_ID, key_seeds)
        for chain in (p, r):
            chain.app.snapshot_interval = INTERVAL
        p.states, r.states = {}, {}
        for h in range(1, TOP + 1):
            txs = [cs._keyed_tx(19, h, j) for j in range(4)]
            assert p.step(txs)[0].hash() == r.step(txs).hash()
            p.states[h], r.states[h] = p.state.bytes(), r.state.bytes()
    return {"port": p, "jax": r}


def _light_client(side, chain, primary=None):
    """A light client of ``side`` over ``chain``'s stores (the chain of the
    same package), trust root at TRUST, one witness."""
    s = SIDES[side]
    trust_hash = chain.block_store.load_block_meta(TRUST).block_id.hash
    primary = primary or s.NodeProvider(chain.block_store, chain.state_store,
                                        CHAIN_ID)
    witness = s.NodeProvider(chain.block_store, chain.state_store, CHAIN_ID)
    return s.light.Client(
        CHAIN_ID, s.light.TrustOptions(period_ns=PERIOD_NS, height=TRUST,
                                       header_hash=trust_hash),
        primary, [witness], s.TrustedStore(s.MemDB()), **s.kw)


class _Joiner:
    """A fresh node of one package: kvstore app after InitChain, MemDB
    stores, a Switch with an active BlocksyncReactor and a StatesyncReactor
    with a Syncer, wired as the JAX node wires them."""

    def __init__(self, side, doc, sp, chunk_timeout_s=2.0, logger=None):
        s = self.s = SIDES[side]
        self.side, self.doc = side, doc
        self.app = s.KVStore()
        self.conns = s.AppConns(self.app)
        self.dbs = {"state": s.MemDB(), "block": s.MemDB()}
        self.state_store = s.Store(self.dbs["state"])
        self.block_store = s.BlockStore(self.dbs["block"])
        self.genesis = s.genesis(doc)
        self.state_store.save(self.genesis)
        self.exec = s.Executor(self.state_store, self.conns.consensus,
                               block_store=self.block_store, **s.kw)
        self.bsync = s.bsync.BlocksyncReactor(
            self.genesis, self.exec, self.block_store, active=True, **s.kw)
        self.syncer = s.syncer.Syncer(
            self.conns, sp, request_chunk=lambda snap, i:
            self.ss.request_chunk(snap, i), chunk_timeout_s=chunk_timeout_s,
            logger=logger)
        self.ss = s.reactor.StatesyncReactor(self.conns, self.syncer)
        self.switch = s.Switch(s.NodeKey.generate(), doc.chain_id,
                               listen_addr="127.0.0.1:0")
        self.switch.add_reactor(self.bsync)
        self.switch.add_reactor(self.ss)

    async def start(self):
        if self.side == "port":
            await Handshaker(self.state_store, self.genesis,
                             self.block_store, self.doc,
                             device="cpu").handshake(self.conns)
        else:
            await RHandshaker(self.state_store, self.genesis,
                              self.block_store, self.doc
                              ).handshake(self.conns)
        await self.switch.start()

    async def sync(self, discovery_s=0.3):
        state, commit = await self.syncer.sync_any(discovery_s)
        self.state_store.bootstrap(state)
        self.block_store.save_seen_commit_standalone(commit)
        self.bsync.state = state
        self.ss.metrics.syncing.set(0)
        return state, commit

    def rows(self):
        return {"state": rows(self.dbs["state"]),
                "block": rows(self.dbs["block"]), "app": rows(self.app.db)}


async def _server(side, chain):
    """A Switch serving ``chain``'s snapshots and blocks: a StatesyncReactor
    with no syncer and a passive BlocksyncReactor."""
    s = SIDES[side]
    sw = s.Switch(s.NodeKey.generate(), CHAIN_ID, listen_addr="127.0.0.1:0")
    sw.add_reactor(s.bsync.BlocksyncReactor(
        chain.state, chain.exec, chain.block_store, active=False, **s.kw))
    sw.add_reactor(s.reactor.StatesyncReactor(chain.conns))
    await sw.start()
    return sw


# -- tests/test_statesync_pex.py TestStatesync, against the port -----------------

def test_snapshot_bootstrap(stand_in):
    class PacedKVStore(KVStoreApplication):
        """The kvstore with the JAX test's 100 ms block cadence
        (next_block_delay_ns), so the snapshot window outlives a chunk's
        round trip."""

        async def finalize_block(self, req):
            resp = await super().finalize_block(req)
            resp.next_block_delay_ns = 100_000_000
            return resp

    async def go():
        pv = new_mock_pv()
        doc = GenesisDoc(chain_id="ss-chain",
                         genesis_time=Timestamp(1700000000, 0),
                         validators=[GenesisValidator(
                             b"", pv.get_pub_key(), 10)])
        src_app = PacedKVStore(snapshot_interval=4)
        src_conns = AppConns(src_app)
        src_ss, src_bs = Store(MemDB()), BlockStore(MemDB())
        state = make_genesis_state(doc)
        src_ss.save(state)
        ex = BlockExecutor(src_ss, src_conns.consensus, block_store=src_bs,
                           device="cpu")
        cons = ConsensusState(_test_config().consensus, state, ex, src_bs,
                              priv_validator=pv, device="cpu")
        await cons.start()
        src_switch = dst_switch = None
        try:
            await _until(lambda: src_bs.height >= 10, "the source's blocks")
            snaps = (await src_app.list_snapshots(None)).snapshots
            assert snaps, "source must have taken snapshots"
            src_switch = Switch(NodeKey.generate(), doc.chain_id,
                                listen_addr="127.0.0.1:0")
            src_switch.add_reactor(StatesyncReactor(src_conns))
            await src_switch.start()
            dst_conns = AppConns(KVStoreApplication())
            provider = NodeProvider(src_bs, src_ss, doc.chain_id)
            root = await provider.light_block(1)
            lc = p_light.Client(
                doc.chain_id, p_light.TrustOptions(
                    period_ns=PERIOD_NS, height=1,
                    header_hash=root.signed_header.header.hash()),
                provider, [], TrustedStore(MemDB()),
                verification_mode=p_light.SKIPPING, device="cpu")
            await lc.initialize()
            sp = StateProvider(lc, doc.chain_id, doc)
            dst_switch = Switch(NodeKey.generate(), doc.chain_id,
                                listen_addr="127.0.0.1:0")
            syncer = p_syncer.Syncer(dst_conns, sp, request_chunk=None,
                                     chunk_timeout_s=2.0)
            dst_reactor = StatesyncReactor(dst_conns, syncer=syncer)
            syncer.request_chunk = dst_reactor.request_chunk
            dst_switch.add_reactor(dst_reactor)
            await dst_switch.start()
            await dst_switch.dial_peer(src_switch.listen_addr)
            new_state, commit = await asyncio.wait_for(
                syncer.sync_any(discovery_time_s=0.3), 30)
            snap_h = new_state.last_block_height
            assert snap_h % 4 == 0 and snap_h >= 4
            assert commit.height == snap_h
            info = await dst_conns.query.info(abci.InfoRequest())
            assert info.last_block_height == snap_h
            dst_ss = Store(MemDB())
            dst_ss.bootstrap(new_state)
            assert dst_ss.load().last_block_height == snap_h
            assert dst_reactor.metrics.syncing.value == 1
        finally:
            await cons.stop()
            for sw in (dst_switch, src_switch):
                if sw is not None:
                    await sw.stop()
    run(go())


# -- the twin state sync ---------------------------------------------------------

def _twin_sync(chains, joiner, source):
    """A ``joiner`` node state-syncs from a ``source`` server, bootstraps
    and block-syncs the tail; returns (rows at the bootstrap, rows after
    the tail, the bootstrapped State's bytes, the restored Info)."""
    chain = chains[source]

    async def go():
        lc = _light_client(joiner, chains[joiner])
        await lc.initialize()
        sp = SIDES[joiner].syncer.StateProvider(lc, CHAIN_ID,
                                                chains[joiner].doc)
        server = await _server(source, chain)
        dst = _Joiner(joiner, chains[joiner].doc, sp)
        await dst.start()
        try:
            await dst.switch.dial_peer(server.listen_addr)
            state, commit = await asyncio.wait_for(dst.sync(), 30)
            at_bootstrap = dst.rows()
            info = await dst.conns.query.info(SIDES[joiner].abci.InfoRequest())
            await dst.bsync.start_sync()
            await _until(lambda: dst.block_store.height >= TOP - 1,
                         "the block-synced tail")
            await dst.bsync.stop_sync()
        finally:
            await dst.switch.stop()
            await server.stop()
        return (at_bootstrap, dst.rows(), state.bytes(),
                (info.last_block_height, info.last_block_app_hash),
                commit.height)
    return run(go())


@pytest.fixture(scope="module")
def jax_twin(chains):
    r_batch.set_backend("cpu")
    return _twin_sync(chains, "jax", "jax")


@pytest.mark.parametrize("joiner,source", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_twin_state_sync_rows_equal(chains, jax_twin, stand_in, joiner,
                                    source):
    got = _twin_sync(chains, joiner, source)
    assert got == jax_twin
    at_bootstrap, after, state, info, commit_h = got
    assert commit_h == SNAP
    assert info == (SNAP, chains["port"].block_store.load_block_meta(
        SNAP + 1).header.app_hash)
    # the bootstrapped State is built from light blocks: not the source's
    # own State at SNAP (the validators changed height is SNAP)
    assert state != chains["port"].states[SNAP]
    # after the tail, the synced heights' block rows are the source's
    src = dict(rows(chains["port"].dbs["block"]))
    synced = [kv for kv in after["block"] if kv[0] != b"\x06"]
    assert len(synced) > 3 * (TOP - 1 - SNAP)
    assert all(src.get(k) == v for k, v in synced)
    assert after["app"] != at_bootstrap["app"]


# -- messages and the reactors' answers ------------------------------------------

def test_messages_byte_equal_and_cross_decoded():
    msgs = [{"snapshots_request": {}},
            {"snapshots_response": {"height": 10, "format": 1, "chunks": 1,
                                    "hash": b"h" * 32, "metadata": b"m"}},
            {"snapshots_response": {"height": 3}},
            {"chunk_request": {"height": 10, "format": 1, "index": 2}},
            {"chunk_request": {}},
            {"chunk_response": {"height": 10, "format": 1, "index": 0,
                                "chunk": b"c" * 3000}},
            {"chunk_response": {"height": 10, "missing": True}}]
    for d in msgs:
        raw = encode(p_reactor.MESSAGE, d)
        assert raw == r_encode(r_reactor.MESSAGE, d)
        assert encode(p_reactor.MESSAGE, r_decode(r_reactor.MESSAGE, raw)) \
            == raw
        assert r_encode(r_reactor.MESSAGE, decode(p_reactor.MESSAGE, raw)) \
            == raw
    assert (p_reactor.SNAPSHOT_CHANNEL, p_reactor.CHUNK_CHANNEL) == \
        (r_reactor.SNAPSHOT_CHANNEL, r_reactor.CHUNK_CHANNEL) == (0x60, 0x61)


class _Peer:
    def __init__(self, pid="peer-a"):
        self.id = pid
        self.sent = []

    def send(self, ch, raw):
        self.sent.append((ch, raw))
        return True


def test_reactors_answer_the_same_bytes(chains):
    """Each package's serving reactor over its twin chain's app answers the
    same requests with the same bytes; a syncing reactor asks a new peer
    for snapshots and records what it is offered."""
    def answers(side):
        s = SIDES[side]
        reactor = s.reactor.StatesyncReactor(chains[side].conns)
        peer = _Peer()

        async def go():
            for d in ({"snapshots_request": {}},
                      {"chunk_request": {"height": SNAP, "format": 1}},
                      {"chunk_request": {"height": 7, "format": 1,
                                         "index": 1}}):
                await reactor.receive(p_reactor.SNAPSHOT_CHANNEL, peer,
                                      encode(p_reactor.MESSAGE, d))
        run(go())
        chans = [(c.id, c.priority, c.send_queue_capacity)
                 for c in reactor.get_channels()]
        return peer.sent, chans, reactor.metrics.syncing.value

    got, want = answers("port"), answers("jax")
    assert got == want
    assert [ch for ch, _ in got[0]] == [0x60, 0x60, 0x61, 0x61]
    assert got[2] == 0

    def offered(side):
        s = SIDES[side]
        syncer = s.syncer.Syncer(None, None, request_chunk=None)
        reactor = s.reactor.StatesyncReactor(None, syncer)
        peer = _Peer("peer-b")

        async def go():
            await reactor.add_peer(peer)
            for raw in got[0][:2]:
                await reactor.receive(0x60, peer, raw[1])
        run(go())
        return peer.sent, sorted((k.height, k.format, k.chunks, k.hash,
                                  sorted(v)) for k, v in
                                 syncer.snapshots.items()), \
            reactor.metrics.syncing.value
    assert offered("port") == offered("jax")
    assert offered("port")[1][-1][0] == SNAP


def test_metrics_equal_the_jax_ones():
    p, r = p_smetrics.Metrics(), r_smetrics.Metrics()
    assert (p.syncing.name, p.syncing.help) == \
        (r.syncing.name, r.syncing.help)


# -- ChunkQueue and the sender bans -----------------------------------------------

def test_chunk_queue_discard_and_senders(tmp_path):
    def drive(side):
        s = SIDES[side]
        snap = s.syncer.SnapshotKey(height=5, format=1, chunks=3, hash=b"h")
        q = s.syncer.ChunkQueue(snap, str(tmp_path / side / "q"))
        out = [q.add(0, b"a", "p1"), q.add(0, b"x", "p2"), q.add(3, b"c"),
               q.add(-1, b"c"), q.add(1, b"b", "p2"), q.add(2, b"d", "p1")]
        out += [q.has(i) for i in range(3)] + [q.load(1), q.sender(2),
                                               q.sender(7)]
        out.append(q.discard_from_sender("p1"))
        out += [q.has(i) for i in range(3)]
        q.discard(1)
        q.discard(1)
        out += [q.has(1), q.add(1, b"e", "p3"), q.load(1), q.sender(1),
                q.event.is_set()]
        q.close()
        out.append(os.path.exists(str(tmp_path / side / "q")))
        return out
    got = drive("port")
    assert got == drive("jax")
    assert got[:6] == [True, False, False, False, True, True]
    assert got[12] == [0, 2]


class _StubProvider:
    def __init__(self, s, app_hash):
        self.s, self.hash = s, app_hash

    async def app_hash(self, height):
        return self.hash

    async def state(self, height):
        return ("state", height)

    async def commit(self, height):
        return ("commit", height)


class _StubApp:
    """A snapshot/query connection whose first apply of chunk 0 bans
    sender "bad" and asks for a retry, and whose second refetches chunk
    1; it records every call."""

    def __init__(self, s, app_hash):
        self.s, self.hash, self.calls, self.applies = s, app_hash, [], 0

    async def offer_snapshot(self, req):
        self.calls.append(("offer", req.snapshot.height, req.app_hash))
        return self.s.abci.OfferSnapshotResponse(
            result=self.s.abci.OFFER_SNAPSHOT_RESULT_ACCEPT)

    async def apply_snapshot_chunk(self, req):
        self.calls.append(("apply", req.index, req.chunk, req.sender))
        self.applies += 1
        a = self.s.abci
        if self.applies == 1:
            return a.ApplySnapshotChunkResponse(
                result=a.APPLY_SNAPSHOT_CHUNK_RESULT_RETRY,
                reject_senders=["bad"])
        if self.applies == 2:
            return a.ApplySnapshotChunkResponse(
                result=a.APPLY_SNAPSHOT_CHUNK_RESULT_ACCEPT,
                refetch_chunks=[1])
        return a.ApplySnapshotChunkResponse(
            result=a.APPLY_SNAPSHOT_CHUNK_RESULT_ACCEPT)

    async def info(self, req):
        return self.s.abci.InfoResponse(last_block_height=5,
                                        last_block_app_hash=self.hash)


def test_syncer_bans_senders_and_refetches(tmp_path):
    def drive(side):
        s = SIDES[side]
        app = _StubApp(s, b"A" * 32)
        conns = SimpleNamespace(snapshot=app, query=app)
        requests = []
        syncer = None

        def request_chunk(snap, i):
            requests.append(i)
            # the banned sender answers too; only the good one counts
            sender = "bad" if len(requests) == 1 else "good"
            chunk = b"chunk-%d-%d" % (i, len(requests))
            asyncio.get_running_loop().call_soon(
                syncer.add_chunk, snap.height, snap.format, i, chunk, sender)
            if sender == "good":
                asyncio.get_running_loop().call_soon(
                    syncer.add_chunk, snap.height, snap.format, i, b"late",
                    "bad")

        syncer = s.syncer.Syncer(conns, _StubProvider(s, b"A" * 32),
                                 request_chunk, chunk_timeout_s=1.0,
                                 chunk_dir=str(tmp_path / side))
        syncer.add_snapshot("p", s.syncer.SnapshotKey(5, 1, 2, b"h"))
        res = run(syncer.sync_any(discovery_time_s=0.0))
        return res, requests, app.calls, sorted(syncer.banned_senders)

    got = drive("port")
    assert got == drive("jax")
    assert got[0] == (("state", 5), ("commit", 5))
    assert got[3] == ["bad"]


# -- chip_smoke.py's 15c outcomes, with the JAX texts -----------------------------

class _Liar:
    """A snapshot source that advertises ``snaps`` [(SnapshotKey, chunk or
    None)] to a Syncer and answers its chunk requests on the loop (a None
    chunk never arrives)."""

    def __init__(self, snaps):
        self.snaps = snaps

    def attach(self, syncer, peer="liar"):
        for key, _ in self.snaps:
            syncer.add_snapshot(peer, key)

    def serve(self, syncer, snap, index, peer="liar"):
        for key, chunk in self.snaps:
            if key == snap and chunk is not None:
                asyncio.get_running_loop().call_soon(
                    syncer.add_chunk, snap.height, snap.format, index, chunk,
                    peer)


def _outcome(chains, side, liars, primary=None, tmp=None):
    """A fresh app of ``side`` state-syncs from the liars' snapshots (and
    the source chain's good one when ``liars`` holds "good") with no
    sockets; returns (the outcome, the rejections logged, the app's Info
    height)."""
    s = SIDES[side]
    chain = chains[side]

    async def go():
        lc = _light_client(side, chain, primary=primary)
        await lc.initialize()
        sp = s.syncer.StateProvider(lc, CHAIN_ID, chain.doc)
        conns = s.AppConns(s.KVStore())
        logger = cs._LogRecorder()
        sources = []
        syncer = s.syncer.Syncer(
            conns, sp, request_chunk=lambda snap, i: [
                src.serve(syncer, snap, i, peer) for peer, src in sources],
            chunk_timeout_s=0.05, chunk_dir=tmp, logger=logger)
        for peer, src in liars:
            if src in ("good", "good@SNAP"):
                good = await chain.app.list_snapshots(
                    s.abci.ListSnapshotsRequest())
                src = _Liar([(s.syncer.SnapshotKey(
                    sn.height, sn.format, sn.chunks, sn.hash),
                    (await chain.app.load_snapshot_chunk(
                        s.abci.LoadSnapshotChunkRequest(
                            height=sn.height, format=sn.format, chunk=0))
                     ).chunk) for sn in good.snapshots
                    if src == "good" or sn.height == SNAP])
            src.attach(syncer, peer)
            sources.append((peer, src))
        try:
            state, commit = await syncer.sync_any(discovery_time_s=0.01)
            res = ("ok", state.bytes(), commit.height)
        except Exception as e:  # noqa: BLE001 — compared across packages
            res = (type(e).__name__, str(e))
        info = await conns.query.info(s.abci.InfoRequest())
        return res, [(kv.get("height"), kv.get("err"))
                     for msg, kv in logger.lines
                     if msg == "snapshot rejected; trying next"], \
            info.last_block_height
    return run(go())


def _key(side, h, fmt=1, chunk=b"advertised"):
    s = SIDES[side]
    from cometbft_tpu_torch.crypto import tmhash
    return s.syncer.SnapshotKey(height=h, format=fmt, chunks=1,
                                hash=tmhash.sum(chunk))


def test_rejected_snapshots_then_the_good_one(chains, stand_in, tmp_path):
    out = []
    for side in ("port", "jax"):
        # every liar's H + 2 <= TOP, so each reaches the app (C.10)
        liar = _Liar([(_key(side, SNAP + 2, fmt=2), b"x"),
                      (_key(side, SNAP + 2), b"not the advertised chunk"),
                      (_key(side, SNAP + 1), None)])
        out.append(_outcome(chains, side, [("liar", liar), ("src", "good")],
                            tmp=str(tmp_path / side)))
    assert out[0] == out[1]
    res, rejected, height = out[0]
    assert rejected == [(SNAP + 2, "chunk apply failed: 5"),
                        (SNAP + 2, "app rejected snapshot: 4"),
                        (SNAP + 1, "timed out waiting for chunks (4 rounds)")]
    assert res[0] == "ok" and res[2] == SNAP and height == SNAP


def test_snapshot_at_the_tip_ends_the_sync(chains, stand_in):
    """A snapshot at the tip, whose light block TOP + 1 no provider has
    yet: the JAX syncer ends the sync with the provider's error; the
    port passes the snapshot over (syncer.go Sync, "failed to fetch and
    verify app hash"), tries it again once a discovery round, as the
    light block may come (C.10), and, with the net stopped at TOP, ends
    when discovery runs out (ROADMAP.md section C, C.8)."""
    out = [_outcome(chains, side, [("liar", _Liar([(_key(side, TOP), b"x")]))])
           for side in ("port", "jax")]
    assert out[1] == (("LightBlockNotFoundError",
                       f"no light block at height {TOP + 1}"), [], 0)
    assert out[0] == (
        ("StatesyncError", "no viable snapshots (discovered 1)"),
        [(TOP, "failed to fetch and verify app hash: no light block at "
               f"height {TOP + 1}")] * p_syncer.MAX_DISCOVERY_ROUNDS, 0)


def test_a_tip_snapshot_is_dropped_for_the_next_one(chains, stand_in,
                                                    tmp_path):
    """The tip snapshot first, the source's good one second: the port
    drops the first and restores the second (C.8); the JAX syncer stops
    at the first."""
    out = {side: _outcome(chains, side,
                          [("liar", _Liar([(_key(side, TOP), b"x")])),
                           ("src", "good")], tmp=str(tmp_path / side))
           for side in ("port", "jax")}
    res, rejected, height = out["port"]
    assert res[0] == "ok" and res[2] == SNAP and height == SNAP
    assert rejected == [(TOP, "failed to fetch and verify app hash: no "
                              f"light block at height {TOP + 1}")]
    assert out["jax"][0] == ("LightBlockNotFoundError",
                             f"no light block at height {TOP + 1}")


def _behind(side, chain, top, step=0):
    """A provider of ``side`` whose net has reached only ``top``: a light
    block above it is not found yet (a provider that is slow to serve
    the blocks above a snapshot).  Each refusal lets the net go ``step``
    heights further."""
    s = SIDES[side]
    not_found = sys.modules[s.NodeProvider.__module__].LightBlockNotFoundError

    class Behind(s.NodeProvider):
        async def light_block(self, height):
            nonlocal top
            if height > top:
                top += step
                raise not_found(f"no light block at height {height}")
            return await super().light_block(height)
    return Behind(chain.block_store, chain.state_store, CHAIN_ID)


def test_a_snapshot_next_to_the_tip_is_dropped_before_its_chunks(
        chains, stand_in, tmp_path):
    """C.10: the source's snapshots at 5 and SNAP, its providers at SNAP +
    1, so light block SNAP + 2, which ``state`` needs, is not out yet.
    The port refuses SNAP at the app-hash step, before a chunk is
    applied (stateprovider.go AppHash fetches H+2), and restores 5; the
    JAX syncer (as the port's did) applies SNAP's chunk and then ends
    the sync on the missing light block, the app left at SNAP."""
    out = {}
    for side in ("port", "jax"):
        chain = chains[side]
        out[side] = _outcome(chains, side, [("src", "good")],
                             primary=_behind(side, chain, SNAP + 1),
                             tmp=str(tmp_path / side))
    res, rejected, height = out["port"]
    assert res[0] == "ok" and res[2] == INTERVAL and height == INTERVAL
    assert rejected == [(SNAP, "failed to fetch and verify app hash: no "
                               f"light block at height {SNAP + 2}")]
    assert out["jax"] == (("LightBlockNotFoundError",
                           f"no light block at height {SNAP + 2}"), [], SNAP)


def test_a_snapshot_not_ready_yet_is_tried_again(chains, stand_in,
                                                 tmp_path):
    """C.10, the QA joiner's case: the only snapshot, SNAP, is discovered
    while the net is at SNAP + 1; the next block lands after the first
    refusal.  The port passes SNAP over, rediscovers and restores it
    (one rejection logged); the JAX syncer applies its chunk and ends on
    the missing light block SNAP + 2."""
    out = {}
    for side in ("port", "jax"):
        chain = chains[side]
        out[side] = _outcome(chains, side, [("src", "good@SNAP")],
                             primary=_behind(side, chain, SNAP + 1, step=1),
                             tmp=str(tmp_path / side))
    res, rejected, height = out["port"]
    assert res[0] == "ok" and res[2] == SNAP and height == SNAP
    assert rejected == [(SNAP, "failed to fetch and verify app hash: no "
                               f"light block at height {SNAP + 2}")]
    assert out["jax"] == (("LightBlockNotFoundError",
                           f"no light block at height {SNAP + 2}"), [], SNAP)


def test_flipped_signature_in_light_block_h1(chains, monkeypatch):
    """One signature bit of light block SNAP + 1 flipped at the primary:
    the golden model in B1's place refuses it and the sync ends with the
    light client's text, as the JAX package's does."""
    def verify_batch(items, device=None, **kw):
        ek.launches += len(tile_plan(len(items), DEFAULT_TILE))
        mask = [ref.verify(*item) for item in items]
        return all(mask), mask
    monkeypatch.setattr(oe, "verify_batch", verify_batch)

    def flipped(side):
        s = SIDES[side]

        class Flipped(s.NodeProvider):
            async def light_block(self, height):
                lb = await super().light_block(height)
                if height == SNAP + 1:
                    sig = lb.signed_header.commit.signatures[0]
                    sig.signature = bytes([sig.signature[0] ^ 1]) + \
                        sig.signature[1:]
                return lb
        chain = chains[side]
        return Flipped(chain.block_store, chain.state_store, CHAIN_ID)

    out = [_outcome(chains, side, [("src", "good")], primary=flipped(side))
           for side in ("port", "jax")]
    assert out[0] == out[1]
    (kind, text), rejected, height = out[0]
    assert kind == "InvalidHeaderError" and text.startswith(
        "wrong signature (#0): ")
    assert rejected == [] and height == 0


def test_raising_kernel_surfaces_with_nothing_bootstrapped(chains,
                                                            monkeypatch):
    def raising(*a, **kw):
        raise RuntimeError("stand-in kernel failure")
    monkeypatch.setattr(ek, "verify_cols", raising)
    res, rejected, height = _outcome(chains, "port", [("src", "good")])
    assert res == ("RuntimeError", "stand-in kernel failure")
    assert rejected == [] and height == 0


def test_rpc_state_provider_waits_for_the_http_provider():
    """No server: the JAX text.  A server that refuses the connection:
    the HttpProvider's error at the trust root, as the JAX package's (the
    provider itself is held to the JAX one in test_torch_rpc.py)."""
    with pytest.raises(p_syncer.StatesyncError) as got:
        run(p_syncer.new_rpc_state_provider("c", None, [], 1, b"h"))
    with pytest.raises(r_syncer.StatesyncError) as want:
        run(r_syncer.new_rpc_state_provider("c", None, [], 1, b"h"))
    assert str(got.value) == str(want.value)
    outs = []
    for call in (lambda: p_syncer.new_rpc_state_provider(
            "c", None, ["http://127.0.0.1:1"], 1, b"h", device="cpu"),
            lambda: r_syncer.new_rpc_state_provider(
                "c", None, ["http://127.0.0.1:1"], 1, b"h")):
        with pytest.raises(Exception) as e:
            run(call())
        outs.append((type(e.value).__name__, str(e.value)))
    assert outs[0] == outs[1] and outs[0][0] == "ProviderError"


# -- chip_smoke.py's phase 15, rehearsed ------------------------------------------

def test_phase_15_rehearsed_at_12_validators(monkeypatch):
    """Phase 15 at 12 validators with B1 replaced by a memoised golden-model
    check that counts a launch a tile (so 15c's flipped bit is refused) and
    calls a kernel named ``raising`` when 15c installs one: a 17-height
    source with snapshots every 6 heights and retain_blocks 8, a trust root
    at 10, the snapshot at 12 restored and 13-16 block-synced, then 17 by
    catch-up; the prune gates and rollback; the 15c outcomes and the cuda8
    sync."""
    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    for name, value in (("EXEC_VALIDATORS", 12), ("EXEC_UPDATES", (2, 3, 4)),
                        ("EXEC_TXS", 5), ("SS_HEIGHTS", 17),
                        ("SS_INTERVAL", 6), ("SS_RETAIN", 8),
                        ("SS_TRUST", 10)):
        monkeypatch.setattr(cs, name, value)
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
    launches, launches8 = cs._statesync_phases(0, "CPU", {}, device="cpu")
    assert set(launches) == {"statesync_source_12x17", "statesync_12x17",
                             "statesync_reject"}
    # validate_block's one launch a height after the first
    assert launches["statesync_source_12x17"] == 16
    # the light blocks (H+1 from the root: 2; H from the root: 2; H+2: 1),
    # two a block-synced height, one for the switch's LastCommit, two for
    # the catch-up of 17 (its precommits' burst, its block's LastCommit)
    assert launches["statesync_12x17"] == 5 + 2 * 4 + 1 + 2
    assert launches["statesync_reject"] > 0
    assert launches8 == {"statesync_12_cuda8": 5}

