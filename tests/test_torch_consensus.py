"""The port's consensus state machine (consensus/state.py with its round
state, ticker, timeouts and supervisor, the WAL, catchup_replay, the
EventBus) against the JAX package's.

  * tests/test_consensus.py, run against the port: one validator makes
    blocks and writes its WAL, four make the same chain, three of four
    still commit, a burst pre-verification fills the memo;
  * tests/test_pipeline.py ``TestPipelinedCommit`` and the adaptive cases
    that need a machine, and tests/test_replay.py ``TestWALCatchup``,
    run against the port;
  * a scripted full node in both packages: the same pre-built chain (a
    port twin executor's blocks, proposals and votes, carried to the JAX
    package as wire bytes) is fed message by message, and the two nodes
    store the same block-store rows, ``State.bytes()`` and WAL bytes;
  * a mixed net of two JAX and two port validators over the wire codec
    commits one chain;
  * an aggregate-commit chain of BLS validators whose port proposers
    aggregate each last commit (``AggregateCommit.from_commit``, equal to
    the JAX package's);
  * the no-fallback supervisor: a kernel that raises inside the receive
    routine stops consensus and surfaces, not restarted; a protocol
    error is restarted, as the JAX package restarts it;
  * chip_smoke.py's phase 12 rehearsed at 12 validators.

The port runs ``device="cpu"`` with the accept-all stand-in kernel, the
JAX package on its ``cpu`` backend.
"""
import asyncio
import os

import pytest

from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.config import ConsensusConfig as RConsensusConfig
from cometbft_tpu.config import test_config as r_test_config
from cometbft_tpu.consensus import messages as rm
from cometbft_tpu.consensus.round_state import TimeoutInfo as RTimeoutInfo
from cometbft_tpu.consensus.state import ConsensusState as RConsensusState
from cometbft_tpu.consensus.wal import WAL as RWAL
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import bls12381 as r_bls
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.libs.supervisor import Supervisor as RSupervisor
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types import vote as r_vote_mod
from cometbft_tpu.types.commit import AggregateCommit as RAggregateCommit
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.events import EventBus as REventBus
from cometbft_tpu.types.genesis import GenesisDoc as RGenesisDoc
from cometbft_tpu.types.genesis import GenesisValidator as RGenesisValidator
from cometbft_tpu.types.priv_validator import MockPV as RMockPV
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import (
    KVStoreApplication, make_val_set_change_tx)
from cometbft_tpu_torch.config import test_config as _test_config
from cometbft_tpu_torch.consensus import messages as pm
from cometbft_tpu_torch.consensus import state as cs_state
from cometbft_tpu_torch.consensus.replay import Handshaker, catchup_replay
from cometbft_tpu_torch.consensus.round_state import (
    STEP_NEW_HEIGHT, TimeoutInfo)
from cometbft_tpu_torch.consensus.state import ConsensusError, ConsensusState
from cometbft_tpu_torch.consensus.wal import WAL
from cometbft_tpu_torch.crypto import bls12381 as p_bls
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB, SQLiteDB
from cometbft_tpu_torch.libs.supervisor import Supervisor
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types import vote as vote_mod
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import AggregateCommit, Commit
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.params import (
    ConsensusParams, FeatureParams, ValidatorParams)
from cometbft_tpu_torch.types.priv_validator import MockPV, new_mock_pv
from cometbft_tpu_torch.types.timestamp import Timestamp
from torch_chain import RChain, accept_all, cs, port_chain, rows, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

GOSSIP = (pm.ProposalMessage, pm.BlockPartMessage, pm.VoteMessage)
R_GOSSIP = (rm.ProposalMessage, rm.BlockPartMessage, rm.VoteMessage)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    r_batch.set_backend("cpu")
    accept_all(monkeypatch)
    for mod in (vote_mod, r_vote_mod):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()
    yield
    r_batch.set_backend("auto")
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _make_genesis(n_vals, chain_id="cs-test", params=None, keys=None):
    pvs = [MockPV(k) for k in keys] if keys else \
        [new_mock_pv() for _ in range(n_vals)]
    doc = GenesisDoc(
        chain_id=chain_id, genesis_time=Timestamp(1700000000, 0),
        validators=[GenesisValidator(address=b"", pub_key=pv.get_pub_key(),
                                     power=10) for pv in pvs],
        **({"consensus_params": params} if params else {}))
    return doc, pvs


class _ListMempool:
    """A mempool stand-in (the mempool is ROADMAP A.7e-3): reaps the txs
    it holds in order and drops the committed ones on update."""

    def __init__(self, txs=()):
        self.txs = list(txs)

    def lock(self):
        pass

    def unlock(self):
        pass

    def pre_update(self):
        pass

    async def flush_app_conn(self):
        pass

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return list(self.txs[:8])

    async def update(self, height, txs, tx_results, pre_check=None,
                     post_check=None):
        done = set(txs)
        self.txs = [t for t in self.txs if t not in done]

    def size(self):
        return len(self.txs)

    def get_tx_by_hash(self, tx_hash):
        return None


def _make_node(doc, pv, wal=None, pipeline_commit=True, adaptive=False,
               mempool=None, dbs=None):
    state = make_genesis_state(doc)
    dbs = dbs or {"app": MemDB(), "state": MemDB(), "block": MemDB()}
    app = KVStoreApplication(db=dbs["app"])
    conns = AppConns(app)
    state_store = Store(dbs["state"])
    block_store = BlockStore(dbs["block"])
    state_store.save(state)
    exec_ = BlockExecutor(state_store, conns.consensus, mempool=mempool,
                          block_store=block_store, device="cpu")
    cfg = _test_config().consensus
    cfg.pipeline_commit = pipeline_commit
    cfg.adaptive_timeouts = adaptive
    node = ConsensusState(cfg, state, exec_, block_store,
                          priv_validator=pv, event_bus=EventBus(), wal=wal,
                          device="cpu")
    return node, app, block_store


def _wire(nodes):
    """Full-mesh in-process gossip through the wire codec."""
    for i, node in enumerate(nodes):
        def hook(msg, i=i):
            if not isinstance(msg, GOSSIP):
                return
            raw = pm.encode_p2p(msg)
            for j, other in enumerate(nodes):
                if j != i:
                    other.send_peer(pm.decode_p2p(raw), f"node{i}")
        node.broadcast_hooks.append(hook)


async def _wait_for_height(nodes, height, timeout=30.0):
    async def waiter():
        while True:
            for node in nodes:
                node.raise_if_failed()
            if all(node.block_store.height >= height for node in nodes):
                return
            await asyncio.sleep(0.01)
    await asyncio.wait_for(waiter(), timeout)


# -- tests/test_consensus.py, against the port --------------------------------

class TestSingleValidator:
    def test_produces_blocks(self):
        async def go():
            doc, pvs = _make_genesis(1)
            node, app, bs = _make_node(doc, pvs[0])
            await node.start()
            try:
                await _wait_for_height([node], 3)
            finally:
                await node.stop()
            assert bs.height >= 3
            assert bs.load_block(1).header.chain_id == "cs-test"
            b2 = bs.load_block(2)
            assert b2.last_commit.size() == 1
            assert b2.last_commit.signatures[0].for_block()
            assert node.sm_state.last_block_height >= 3
        run(go())

    def test_wal_written(self, tmp_path):
        async def go():
            doc, pvs = _make_genesis(1)
            node, app, bs = _make_node(doc, pvs[0],
                                       wal=WAL(str(tmp_path / "wal")))
            await node.start()
            try:
                await _wait_for_height([node], 2)
            finally:
                await node.stop()
            msgs = list(WAL.iter_messages(str(tmp_path / "wal")))
            types = [m.get("type") for m in msgs]
            assert {"proposal", "vote", "end_height", "timeout",
                    "round_state", "block_part"} <= set(types)
            assert 1 in [m["height"] for m in msgs
                         if m.get("type") == "end_height"]
            assert WAL.search_for_end_height(str(tmp_path / "wal"), 1) \
                is not None
            # the JAX package reads the port's WAL back record for record
            assert list(RWAL.iter_messages(str(tmp_path / "wal"))) == msgs
        run(go())


class TestFourValidators:
    def test_network_produces_blocks(self):
        async def go():
            doc, pvs = _make_genesis(4)
            nodes = [_make_node(doc, pv)[0] for pv in pvs]
            _wire(nodes)
            for node in nodes:
                await node.start()
            try:
                await _wait_for_height(nodes, 3)
            finally:
                for node in nodes:
                    await node.stop()
            for h in (1, 2, 3):
                assert len({n.block_store.load_block(h).hash()
                            for n in nodes}) == 1
            assert nodes[0].block_store.load_block(3).last_commit.size() == 4
        run(go())

    def test_one_node_down_still_commits(self):
        async def go():
            doc, pvs = _make_genesis(4)
            nodes = [_make_node(doc, pv)[0] for pv in pvs[:3]]
            _wire(nodes)
            for node in nodes:
                await node.start()
            try:
                await _wait_for_height(nodes, 2, timeout=30.0)
            finally:
                for node in nodes:
                    await node.stop()
            b2 = nodes[0].block_store.load_block(2)
            flags = [s.for_block() for s in b2.last_commit.signatures]
            assert flags.count(True) >= 3
        run(go())


class TestBurstPreverification:
    def test_preverify_burst_fills_memo_from_real_votes(self):
        from cometbft_tpu_torch.types import canonical
        from cometbft_tpu_torch.types.vote import Vote
        doc, pvs = _make_genesis(4)
        node, _, _ = _make_node(doc, pvs[0])
        vals = node.rs.validators
        burst = []
        for i, pv in enumerate(pvs):
            idx, val = vals.get_by_address(pv.get_pub_key().address())
            v = Vote(type=canonical.PREVOTE_TYPE, height=node.rs.height,
                     round=0, block_id=BlockID(),
                     timestamp=Timestamp(1700000001 + i, 0),
                     validator_address=val.address, validator_index=idx)
            v.signature = pv.priv_key.sign(v.sign_bytes(
                node.sm_state.chain_id))
            burst.append(("peer", pm.VoteMessage(vote=v), f"n{i}"))
        run(node._preverify_burst(burst))
        assert len(vote_mod._VERIFIED) == len(pvs)
        for _, msg, _ in burst:
            v = msg.vote
            val = vals.validators[v.validator_index]
            assert vote_mod._memo_key(
                val.pub_key, v.sign_bytes(node.sm_state.chain_id),
                v.signature) in vote_mod._VERIFIED

    def test_append_vote_entries_covers_extension_signatures(self):
        from cometbft_tpu_torch.types import canonical
        from cometbft_tpu_torch.types.part_set import PartSetHeader
        from cometbft_tpu_torch.types.vote import Vote
        pk = p_ed.gen_priv_key().pub_key()
        bid = BlockID(hash=b"\x21" * 32,
                      part_set_header=PartSetHeader(1, b"\x43" * 32))
        v = Vote(type=canonical.PRECOMMIT_TYPE, height=9, round=0,
                 block_id=bid, timestamp=Timestamp(1700000900, 0),
                 validator_address=pk.address(), validator_index=0,
                 signature=b"\x01" * 64, extension=b"ext",
                 extension_signature=b"\x02" * 64, non_rp_extension=b"nrp",
                 non_rp_extension_signature=b"\x03" * 64)
        entries = []
        cs_state.append_vote_entries(entries, v, pk, "x-chain")
        assert [e[2] for e in entries] == [b"\x01" * 64, b"\x02" * 64,
                                           b"\x03" * 64]
        prevote = Vote(type=canonical.PREVOTE_TYPE, height=9, round=0,
                       block_id=bid, timestamp=Timestamp(1700000901, 0),
                       validator_address=pk.address(), validator_index=0,
                       signature=b"\x04" * 64)
        entries = []
        cs_state.append_vote_entries(entries, prevote, pk, "x-chain")
        assert len(entries) == 1


# -- tests/test_pipeline.py TestPipelinedCommit, against the port -------------

async def _replay_all(node, wal_path):
    """From-genesis serial replay of a whole WAL (catchup_replay's loop
    without its in-flight-tail scoping)."""
    n = 0
    node.replay_mode = True
    try:
        for record in WAL.iter_group(wal_path):
            t = record.get("type")
            if t in ("round_state", "end_height"):
                continue
            if t == "timeout":
                await node._handle_timeout(TimeoutInfo(
                    duration_ns=0, height=record.get("height", 0),
                    round=record.get("round", 0),
                    step=record.get("step", 0)))
            else:
                await node._handle_msg(pm.message_from_wal(record), "",
                                       internal=False)
            n += 1
    finally:
        node.replay_mode = False
        node.ticker.stop()
    return n


class TestPipelinedCommit:
    def test_pipelined_net_agrees_and_overlaps(self):
        async def go():
            doc, pvs = _make_genesis(4)
            txs = [b"px%03d=v" % i for i in range(24)]
            nodes = [_make_node(doc, pv, mempool=_ListMempool(txs))[0]
                     for pv in pvs]
            _wire(nodes)
            for node in nodes:
                await node.start()
            try:
                await _wait_for_height(nodes, 4)
            finally:
                for node in nodes:
                    await node.stop()
            for h in range(1, 5):
                assert len({n.block_store.load_block(h).hash()
                            for n in nodes}) == 1, f"fork at {h}"
                assert len({n.block_store.load_block_meta(h).header.app_hash
                            for n in nodes}) == 1, f"app fork at {h}"
            committed = sum(
                len(nodes[0].block_store.load_block(h).data.txs)
                for h in range(1, nodes[0].block_store.height + 1))
            assert committed > 0
            assert sum(n.metrics.pipeline_apply_seconds.count
                       for n in nodes) > 0
        run(go())

    def test_wal_replay_matches_pipelined_execution(self, tmp_path):
        async def go():
            doc, pvs = _make_genesis(4)
            wal_path = str(tmp_path / "wal0")
            txs = [b"wr%03d=v" % i for i in range(16)]
            nodes = [_make_node(doc, pv, mempool=_ListMempool(txs),
                                wal=WAL(wal_path) if i == 0 else None)[0]
                     for i, pv in enumerate(pvs)]
            _wire(nodes)
            for node in nodes:
                await node.start()
            try:
                await _wait_for_height(nodes, 4)
            finally:
                for node in nodes:
                    await node.stop()
            bs1 = nodes[0].block_store
            assert nodes[0].metrics.pipeline_apply_seconds.count > 0
            node2, _, bs2 = _make_node(doc, pvs[0], pipeline_commit=False,
                                       mempool=_ListMempool(txs))
            assert await _replay_all(node2, wal_path) > 0
            assert bs2.height >= bs1.height - 1
            for h in range(1, bs2.height + 1):
                assert bs2.load_block_meta(h).block_id.hash == \
                    bs1.load_block_meta(h).block_id.hash
                assert bs2.load_block_meta(h).header.app_hash == \
                    bs1.load_block_meta(h).header.app_hash
            if bs1.height > bs2.height:
                assert node2.sm_state.app_hash == \
                    bs1.load_block_meta(bs2.height + 1).header.app_hash
        run(go())

    def test_serial_mode_still_works(self):
        async def go():
            doc, pvs = _make_genesis(1)
            node, _, bs = _make_node(doc, pvs[0], pipeline_commit=False)
            await node.start()
            try:
                await _wait_for_height([node], 3)
            finally:
                await node.stop()
            assert bs.height >= 3
            assert node.metrics.pipeline_apply_seconds.count == 0
        run(go())


class TestAdaptiveOnAMachine:
    def test_cs_uses_static_until_measured(self):
        doc, pvs = _make_genesis(1)
        node, _, _ = _make_node(doc, pvs[0], adaptive=True)
        static = node.config.propose_timeout_ns(0)
        assert node._adaptive is not None
        assert node._propose_timeout_ns(0) == static
        assert node._vote_wait_timeout_ns(1) == \
            node.config.prevote_timeout_ns(1)
        for _ in range(8):
            node._adaptive.observe(0.05)
        assert node._propose_timeout_ns(0) != static
        assert node._propose_timeout_ns(0) >= 200 * 1_000_000

    def test_replay_does_not_feed_adaptive(self, tmp_path):
        async def go():
            doc, pvs = _make_genesis(1)
            wal_path = str(tmp_path / "wal")
            node, _, _ = _make_node(doc, pvs[0], wal=WAL(wal_path))
            await node.start()
            try:
                await _wait_for_height([node], 3)
            finally:
                await node.stop()
            node2, _, _ = _make_node(doc, pvs[0], adaptive=True)
            await _replay_all(node2, wal_path)
            assert node2._adaptive.samples == 0
            assert node2._adaptive.propose_timeout_ns() is None
        run(go())


# -- tests/test_replay.py TestWALCatchup, against the port --------------------

class TestWALCatchup:
    def test_restart_resumes_chain(self, tmp_path):
        async def go():
            doc, pvs = _make_genesis(1)
            wal_path = str(tmp_path / "wal")
            state = make_genesis_state(doc)
            app_db = SQLiteDB(str(tmp_path / "app.db"))
            ss = Store(SQLiteDB(str(tmp_path / "state.db")))
            bs = BlockStore(SQLiteDB(str(tmp_path / "blocks.db")))
            conns = AppConns(KVStoreApplication(db=app_db))
            ss.save(state)
            cfg = _test_config().consensus
            exec_ = BlockExecutor(ss, conns.consensus, block_store=bs,
                                  device="cpu")
            node = ConsensusState(cfg, state, exec_, bs,
                                  priv_validator=pvs[0], wal=WAL(wal_path),
                                  device="cpu")
            await node.start()
            try:
                await _wait_for_height([node], 3)
            finally:
                await node.stop()
            stopped = bs.height
            state2 = ss.load()
            conns2 = AppConns(KVStoreApplication(db=app_db))
            await Handshaker(ss, state2, bs, doc,
                             device="cpu").handshake(conns2)
            exec2 = BlockExecutor(ss, conns2.consensus, block_store=bs,
                                  device="cpu")
            node2 = ConsensusState(cfg, state2, exec2, bs,
                                   priv_validator=pvs[0], wal=WAL(wal_path),
                                   device="cpu")
            assert await catchup_replay(node2, wal_path) >= 0
            await node2.start()
            try:
                await _wait_for_height([node2], stopped + 2)
            finally:
                await node2.stop()
            for h in range(2, bs.height + 1):
                assert bs.load_block(h).header.last_block_id.hash == \
                    bs.load_block(h - 1).hash()
        run(go())


# -- a scripted full node in both packages ------------------------------------

N, TOP, UPDATE_AT = 4, 5, 2


@pytest.fixture(scope="module")
def twin():
    """A port twin chain of TOP heights (a validator joins by a val= tx at
    UPDATE_AT, signing from UPDATE_AT + 2) and its feed as wire bytes."""
    key_seeds = seeds(N, 401)
    new_seed = seeds(1, 402)[0]
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        chain = port_chain("scripted", key_seeds)
        new_pub = p_ed.Ed25519PrivKey(new_seed).pub_key()
        chain.seed_of[new_pub.address()] = new_seed
        for h in range(1, TOP + 1):
            txs = [b"s%d=v%d" % (h, j) for j in range(3)]
            if h == UPDATE_AT:
                txs.append(make_val_set_change_tx("ed25519",
                                                  new_pub.bytes(), 10))
            chain.step(txs)
        feed = cs._cs_feed(chain, range(1, TOP + 1), cs._Signer())
        pipeline.reset_workers()
    raw = {h: [pm.encode_p2p(m) for m in msgs] for h, msgs in feed.items()}
    return chain, key_seeds, raw


async def _script(node, raw, decode, timeout_info, supervisor):
    """Feed the node each height: its NewHeight timeout, then every
    message in order, then wait out the pipelined apply."""
    node.supervisor = supervisor("consensus")
    for h in sorted(raw):
        await node._handle_timeout(timeout_info(0, h, 0, STEP_NEW_HEIGHT))
        for msg in raw[h]:
            await node._handle_msg(decode(msg), "twin", internal=False)
        await node._sync_pipeline()
    node.ticker.stop()
    node.wal.close()


@pytest.fixture(scope="module")
def scripted(twin, tmp_path_factory):
    chain, key_seeds, raw = twin
    tmp = tmp_path_factory.mktemp("scripted")
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        port = run(cs._CsNode.make(chain.doc, "cpu",
                                   wal_path=str(tmp / "p" / "wal")))
        run(_script(port.cs, raw, pm.decode_p2p, TimeoutInfo, Supervisor))
        r = RChain("scripted", key_seeds)
        jax = RConsensusState(
            RConsensusConfig(), r.state,
            RBlockExecutor(r.state_store, r.conns.consensus,
                           block_store=r.block_store),
            r.block_store, wal=RWAL(str(tmp / "r" / "wal")))
        run(_script(jax, raw, rm.decode_p2p, RTimeoutInfo, RSupervisor))
        r_batch.set_backend("auto")
        pipeline.reset_workers()
    return chain, port, r, jax, tmp


def test_scripted_nodes_store_the_same_rows(scripted):
    chain, port, r, jax, _ = scripted
    assert port.block_store.height == r.block_store.height == TOP
    for db in ("block", "state", "app"):
        got, want = rows(port.dbs[db]), rows(r.dbs[db])
        assert len(got) == len(want) > 0
        assert got == want, db


def test_scripted_nodes_store_the_twins_blocks_and_state(scripted):
    chain, port, r, jax, _ = scripted
    for h in range(1, TOP + 1):
        assert port.block_store.load_block(h).hash() == \
            chain.block_store.load_block(h).hash()
    assert port.state_store.load().bytes() == \
        r.state_store.load().bytes()
    assert port.cs.sm_state.bytes() == jax.sm_state.bytes()
    assert port.cs.sm_state.validators.size() == N + 1


def test_scripted_nodes_write_the_same_wal(scripted):
    chain, port, r, jax, tmp = scripted
    mine = list(WAL.iter_messages(str(tmp / "p" / "wal")))
    theirs = list(RWAL.iter_messages(str(tmp / "r" / "wal")))
    assert [m["type"] for m in mine] == [m["type"] for m in theirs]
    assert mine == theirs
    assert (tmp / "p" / "wal").read_bytes() == \
        (tmp / "r" / "wal").read_bytes()
    assert sum(m["type"] == "end_height" for m in mine) == TOP


# -- a mixed net: two JAX and two port validators -----------------------------

def _jax_node(doc, pv):
    state = r_make_genesis_state(doc)
    app = RKVStore(db=RMemDB())
    conns = RAppConns(app)
    ss, bs = RStore(RMemDB()), RBlockStore(RMemDB())
    ss.save(state)
    return state, conns, ss, bs


def test_mixed_net_commits_one_chain():
    key_seeds = seeds(4, 403)
    p_keys = [p_ed.Ed25519PrivKey(s) for s in key_seeds]
    r_keys = [r_ed.Ed25519PrivKey(s) for s in key_seeds]
    doc, _ = _make_genesis(4, "mixed", keys=p_keys)
    r_doc = RGenesisDoc(
        chain_id="mixed", genesis_time=RTimestamp(1700000000, 0),
        validators=[RGenesisValidator(address=b"", pub_key=k.pub_key(),
                                      power=10) for k in r_keys])

    async def go():
        nodes = [_make_node(doc, MockPV(k))[0] for k in p_keys[:2]]
        for k in r_keys[2:]:
            state, conns, ss, bs = _jax_node(r_doc, None)
            nodes.append(RConsensusState(
                r_test_config().consensus, state,
                RBlockExecutor(ss, conns.consensus, block_store=bs), bs,
                priv_validator=RMockPV(k), event_bus=REventBus()))
        codecs = [pm] * 2 + [rm] * 2
        for i, node in enumerate(nodes):
            def hook(msg, i=i):
                if not isinstance(msg, GOSSIP + R_GOSSIP):
                    return
                raw = codecs[i].encode_p2p(msg)
                for j, other in enumerate(nodes):
                    if j != i:
                        other.send_peer(codecs[j].decode_p2p(raw),
                                        f"node{i}")
            node.broadcast_hooks.append(hook)
        for node in nodes:
            await node.start()
        try:
            async def waiter():
                while not all(n.block_store.height >= 4 for n in nodes):
                    for n in nodes[:2]:
                        n.raise_if_failed()
                    await asyncio.sleep(0.01)
            await asyncio.wait_for(waiter(), 60)
        finally:
            for node in nodes:
                await node.stop()
        return nodes

    nodes = run(go())
    for h in range(1, 5):
        assert len({n.block_store.load_block(h).hash() for n in nodes}) == 1
        assert len({n.block_store.load_block_meta(h).header.app_hash
                    for n in nodes}) == 1
    proposers = {nodes[0].block_store.load_block(h).header.proposer_address
                 for h in range(1, 5)}
    assert len(proposers) == 4   # every validator proposed a block


# -- an aggregate-commit chain ------------------------------------------------

def test_from_commit_equals_the_jax_packages():
    keys = [p_bls.gen_priv_key_from_secret(b"agg-%d" % i) for i in range(5)]
    doc, _ = _make_genesis(5, "agg", keys=keys)
    from cometbft_tpu_torch.types.commit import CommitSig
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.vote import (
        BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL)
    bid = BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32))
    sigs = []
    for i, k in enumerate(keys):
        flag = BLOCK_ID_FLAG_NIL if i == 3 else BLOCK_ID_FLAG_COMMIT
        sigs.append(CommitSig(flag, k.pub_key().address(),
                              Timestamp.zero(), k.sign(b"m-%d" % i)))
    sigs[4] = CommitSig.absent()
    commit = Commit(9, 0, bid, sigs)
    mine = AggregateCommit.from_commit(commit)
    theirs = RAggregateCommit.from_commit(RCommit.from_proto(
        commit.to_proto()))
    assert mine.to_proto() == theirs.to_proto()
    assert mine.signers.true_indices() == [0, 1, 2]
    assert r_bls.aggregate([s.signature for s in sigs[:3]]) == \
        mine.signature
    bad = Commit(9, 0, bid, [CommitSig(BLOCK_ID_FLAG_COMMIT, b"a" * 20,
                                       Timestamp.zero(), b"s" * 64)])
    with pytest.raises(Exception) as e1:
        AggregateCommit.from_commit(bad)
    with pytest.raises(Exception) as e2:
        RAggregateCommit.from_commit(RCommit.from_proto(bad.to_proto()))
    assert str(e1.value) == str(e2.value) == \
        "commit sig #0 is not a BLS signature (64 bytes)"


def test_aggregate_commit_chain_port_proposers_aggregate():
    keys = [p_bls.gen_priv_key_from_secret(b"bls-%d" % i) for i in range(4)]
    params = ConsensusParams(
        validator=ValidatorParams(pub_key_types=["bls12_381"]),
        feature=FeatureParams(pbts_enable_height=1,
                              aggregate_commit_enable_height=1))
    doc, pvs = _make_genesis(4, "agg-chain", params=params, keys=keys)

    async def go():
        nodes = [_make_node(doc, pv)[0] for pv in pvs]
        _wire(nodes)
        for node in nodes:
            await node.start()
        try:
            await _wait_for_height(nodes, 4, timeout=60.0)
        finally:
            for node in nodes:
                await node.stop()
        return nodes

    nodes = run(go())
    store = nodes[0].block_store
    for h in range(2, 5):
        assert len({n.block_store.load_block(h).hash() for n in nodes}) == 1
        last = store.load_block(h).last_commit
        assert isinstance(last, AggregateCommit)
        assert len(last.signers.true_indices()) >= 3
    proposers = {store.load_block(h).header.proposer_address
                 for h in range(2, 5)}
    assert len(proposers) >= 2


# -- the no-fallback supervisor ------------------------------------------------

def _fed_node(twin):
    chain, _, raw = twin
    node = run(cs._CsNode.make(chain.doc, "cpu"))
    return node, raw


def test_raising_kernel_stops_consensus_and_is_not_restarted(monkeypatch,
                                                             twin):
    node, raw = _fed_node(twin)
    calls = []

    def raising(*a, **kw):
        calls.append(1)
        raise RuntimeError("kernel launch failed (stand-in)")

    monkeypatch.setattr(ek, "verify_cols", raising)

    async def go():
        await node.cs.start()
        for msg in raw[1]:
            node.cs.send_peer(pm.decode_p2p(msg), "twin")
        for _ in range(500):
            if node.cs.failure is not None:
                break
            await asyncio.sleep(0.01)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            await node.cs.stop()

    run(go())
    task = node.cs._task
    assert calls == [1]
    assert task.restarts == 0 and task.gave_up
    assert isinstance(node.cs.failure, RuntimeError)
    assert node.block_store.height == 0
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        node.cs.raise_if_failed()
    assert node.cs.supervisor.metrics.giveups.with_labels(
        "consensus", "consensus_receive").value == 1


def test_protocol_error_is_restarted(monkeypatch, twin):
    node, raw = _fed_node(twin)
    real = node.cs._handle_msg
    raised = []

    async def flaky(msg, peer_id, internal):
        if not raised:
            raised.append(1)
            raise ConsensusError("a protocol error (stand-in)")
        return await real(msg, peer_id, internal)

    node.cs._handle_msg = flaky
    sub = node.bus.subscribe("t", "tm.event = 'NewBlock'")

    async def go():
        await node.cs.start()
        node.cs.send_peer(pm.decode_p2p(raw[1][0]), "twin")
        await asyncio.sleep(0.3)                   # the restart's backoff
        for msg in raw[1]:
            node.cs.send_peer(pm.decode_p2p(msg), "twin")
        await cs._cs_new_block(node, sub, 1, timeout_s=30)
        await node.cs.stop()

    run(go())
    assert node.cs._task.restarts == 1
    assert node.cs.failure is None
    assert node.block_store.height == 1
    assert cs_state.is_fatal(RuntimeError("x"))
    assert not cs_state.is_fatal(ConsensusError("x"))


def test_supervisor_backoff_equals_the_jax_packages():
    import random

    def story(mod):
        slept = []

        async def sleep(d):
            slept.append(d)

        async def go():
            sup = mod.Supervisor("t", sleep=sleep, rng=random.Random(5),
                                 monotonic=lambda: 0.0)
            n = []

            async def crash():
                n.append(1)
                raise ValueError("boom")

            st = sup.spawn(crash, name="c", kind="c",
                           policy=mod.RestartPolicy(max_restarts=3))
            await st.wait()
            return st.restarts, st.gave_up, len(n), slept
        return run(go())

    from cometbft_tpu.libs import supervisor as r_sup
    from cometbft_tpu_torch.libs import supervisor as p_sup
    assert story(p_sup) == story(r_sup)
    assert story(p_sup)[:3] == (3, True, 4)


# -- chip_smoke.py's phase 12, rehearsed on the CPU ---------------------------

def test_phase_12_rehearsed_at_12_validators(monkeypatch):
    """The phases run as on the card, B1 replaced by a golden-model check
    that counts a launch a tile (and calls a kernel the phase installs in
    the wrapper's place), at 12 validators for 6 heights, a 3-height net
    and 10 host inputs."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8

    def verify_batch(items, device=None, **kw):
        mod = ek8 if os.environ.get(oe.KERNEL_ENV) == "cuda8" else ek
        if mod.verify_cols.__name__ == "raising":
            mod.verify_cols(None, None, None, None)
        mod.launches += len(tile_plan(len(items), DEFAULT_TILE))
        mask = [ref.verify(p, m, s) for p, m, s in items]
        return all(mask), mask

    class SerialPool:
        def map(self, fn, items, chunksize=None):
            return [fn(x) for x in items]

    monkeypatch.setattr(oe, "verify_batch", verify_batch)
    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    monkeypatch.setattr(cs, "_edge_items",
                        lambda seed, pool: [(bytes(32), b"m", bytes(64))])
    for name, value in (("EXEC_VALIDATORS", 12), ("CS_HEIGHTS", 6),
                        ("EXEC_UPDATES", (2, 3, 4)), ("CS_TRACED", 2),
                        ("NET_HEIGHTS", 3), ("HOST_INPUTS", 10),
                        ("HOST_TIMED", 3)):
        monkeypatch.setattr(cs, name, value)
    launches, launches8 = cs._cs_phases(0, "CPU", SerialPool(), device="cpu")
    # 12a: a burst and the prevote's validate_block a height, the first
    # height without a LastCommit; 12b: the restore and the replay's
    # prevote; 12e: no launch (the stand-in raises first)
    assert launches["cs_12x6"] == 11
    assert launches["wal_replay_12"] == 2
    assert launches["cs_reject"] == 0
    assert launches["net_4x3"] > 3
    assert launches8 == {"wal_replay_12_cuda8": 2}
