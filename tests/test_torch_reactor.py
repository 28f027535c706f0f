"""The port's consensus reactor (consensus/reactor.py) over its p2p stack
against the JAX package's.

  * tests/test_testnet.py's three cases, run against the port: four
    validators over real sockets commit blocks, txs flow into blocks (the
    mempool stand-in of tests/test_torch_consensus.py), a late joiner
    catches up by gossip;
  * PeerState fed one seeded message sequence in both packages (the
    JAX side gets the port's wire bytes), ending in equal round states
    and bit arrays after every message;
  * the channels and the features equal;
  * tests/test_aggregate_commit.py ``TestPeerRefusalActivation`` and
    tests/test_recon_gossip.py ``TestVoteGossipUntrackedSet`` against the
    port;
  * a mixed net over real sockets: two JAX and two port validators, full
    mesh, each package dialing the other, commit one chain;
  * chip_smoke.py's phase 13 rehearsed at 12 validators.

The port runs ``device="cpu"`` with a stand-in kernel that accepts every
lane, the JAX package on its ``cpu`` backend.  Every socket binds
``127.0.0.1:0``, every node is stopped in ``finally`` and every wait has
a bound.
"""
import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import DEFAULT_LANES
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.config import ConsensusConfig as RConsensusConfig
from cometbft_tpu.config import MempoolConfig as RMempoolConfig
from cometbft_tpu.config import test_config as r_test_config
from cometbft_tpu.consensus import messages as rm
from cometbft_tpu.consensus import reactor as r_reactor
from cometbft_tpu.consensus.metrics import Metrics as RMetrics
from cometbft_tpu.consensus.state import ConsensusState as RConsensusState
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.libs.bits import BitArray as RBitArray
from cometbft_tpu.mempool import CListMempool as RCListMempool
from cometbft_tpu.p2p.key import NodeKey as RNodeKey
from cometbft_tpu.p2p.switch import Switch as RSwitch
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types import vote as r_vote_mod
from cometbft_tpu.types.genesis import GenesisDoc as RGenesisDoc
from cometbft_tpu.types.genesis import GenesisValidator as RGenesisValidator
from cometbft_tpu.types.priv_validator import MockPV as RMockPV
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import ConsensusConfig
from cometbft_tpu_torch.config import test_config as _test_config
from cometbft_tpu_torch.consensus import messages as pm
from cometbft_tpu_torch.consensus import reactor as p_reactor
from cometbft_tpu_torch.consensus.metrics import Metrics
from cometbft_tpu_torch.consensus.reactor import (
    ConsensusReactor, PeerState)
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.p2p import NodeKey, Switch
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types import vote as vote_mod
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.types.priv_validator import MockPV, new_mock_pv
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote
from test_torch_consensus import _ListMempool
from torch_chain import RChain, cs, port_chain, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _stand_in(mod):
    """A kernel that accepts every lane and counts a launch."""
    def verify_cols(a, r, s, k):
        mod.launches += 1
        return torch.ones(a.shape[1], dtype=torch.bool)
    return verify_cols


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    r_batch.set_backend("cpu")
    monkeypatch.setattr(ek, "verify_cols", _stand_in(ek))
    monkeypatch.setattr(ek8, "verify_cols", _stand_in(ek8))
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


# -- nodes of either package over real sockets --------------------------------

class PNode:
    """A port validator: ConsensusState over the kvstore app, a Switch on
    127.0.0.1 and a ConsensusReactor."""

    def __init__(self, doc, pv, mempool=None):
        self.app = KVStoreApplication(db=MemDB())
        self.conns = AppConns(self.app)
        self.state_store = Store(MemDB())
        self.block_store = BlockStore(MemDB())
        state = make_genesis_state(doc)
        self.state_store.save(state)
        self.exec = BlockExecutor(self.state_store, self.conns.consensus,
                                  mempool=mempool,
                                  block_store=self.block_store,
                                  device="cpu")
        self.cs = ConsensusState(_test_config().consensus, state, self.exec,
                                 self.block_store, priv_validator=pv,
                                 device="cpu")
        self.switch = Switch(NodeKey.generate(), doc.chain_id,
                             listen_addr="127.0.0.1:0")
        self.reactor = ConsensusReactor(self.cs)
        self.switch.add_reactor(self.reactor)

    async def start(self):
        await self.switch.start()
        await self.cs.start()

    async def stop(self):
        try:
            await self.cs.stop()
        finally:
            await self.switch.stop()


class RNode:
    """The same node in the JAX package (tests/test_testnet.py's Node)."""

    def __init__(self, doc, pv):
        self.app = RKVStore()
        self.conns = RAppConns(self.app)
        self.state_store = RStore(RMemDB())
        self.block_store = RBlockStore(RMemDB())
        state = r_make_genesis_state(doc)
        self.state_store.save(state)
        self.mempool = RCListMempool(
            RMempoolConfig(), self.conns.mempool, lanes=DEFAULT_LANES,
            default_lane="default")
        self.exec = RBlockExecutor(self.state_store, self.conns.consensus,
                                   mempool=self.mempool,
                                   block_store=self.block_store)
        self.cs = RConsensusState(r_test_config().consensus, state,
                                  self.exec, self.block_store,
                                  priv_validator=pv)
        self.switch = RSwitch(RNodeKey.generate(), doc.chain_id,
                              listen_addr="127.0.0.1:0")
        self.reactor = r_reactor.ConsensusReactor(self.cs)
        self.switch.add_reactor(self.reactor)

    start = PNode.start
    stop = PNode.stop


def _doc(n, chain_id="testnet", keys=None):
    pvs = [MockPV(k) for k in keys] if keys else \
        [new_mock_pv() for _ in range(n)]
    doc = GenesisDoc(chain_id=chain_id, genesis_time=Timestamp(1700000000, 0),
                     validators=[GenesisValidator(address=b"",
                                                  pub_key=pv.get_pub_key(),
                                                  power=10) for pv in pvs])
    return doc, pvs


async def _mesh(nodes, timeout=20.0):
    for i, node in enumerate(nodes):
        for other in nodes[i + 1:]:
            await asyncio.wait_for(
                node.switch.dial_peer(other.switch.listen_addr), timeout)

    async def meshed():
        while not all(n.switch.num_peers() == len(nodes) - 1
                      for n in nodes):
            await asyncio.sleep(0.01)
    await asyncio.wait_for(meshed(), timeout)


async def _wait_all_height(nodes, h, timeout=30.0):
    async def waiter():
        while not all(n.block_store.height >= h for n in nodes):
            for n in nodes:
                if isinstance(n, PNode):
                    n.cs.raise_if_failed()
            await asyncio.sleep(0.02)
    await asyncio.wait_for(waiter(), timeout)


async def _wait_all_applied(nodes, h, timeout=30.0):
    """A store holds a block before the pipelined apply has committed it
    to the app: wait until every node's state is at ``h``."""
    async def waiter():
        while not all(n.state_store.load().last_block_height >= h
                      for n in nodes):
            await asyncio.sleep(0.02)
    await asyncio.wait_for(waiter(), timeout)


async def _stop_all(nodes):
    for n in nodes:
        await n.stop()


# -- tests/test_testnet.py against the port -----------------------------------

class TestSocketTestnet:
    def test_four_validators_commit_blocks(self):
        async def go():
            doc, pvs = _doc(4)
            nodes = [PNode(doc, pv) for pv in pvs]
            try:
                for n in nodes:
                    await n.start()
                await _mesh(nodes)
                await _wait_all_height(nodes, 3)
                hashes = {n.block_store.load_block(3).hash() for n in nodes}
                assert len(hashes) == 1
                b3 = nodes[0].block_store.load_block(3)
                assert b3.last_commit.size() == 4
                signed = sum(1 for s in b3.last_commit.signatures
                             if s.for_block())
                assert signed >= 3
            finally:
                await _stop_all(nodes)
        run(go())

    def test_txs_flow_through_mempool_to_blocks(self):
        async def go():
            doc, pvs = _doc(4)
            pools = [_ListMempool() for _ in pvs]
            nodes = [PNode(doc, pv, pool) for pv, pool in zip(pvs, pools)]
            try:
                for n in nodes:
                    await n.start()
                await _mesh(nodes)
                await _wait_all_height(nodes, 1)
                # no mempool reactor: every node holds the txs
                for pool in pools:
                    pool.txs += [b"alpha=1", b"beta=2"]
                top = nodes[0].block_store.height + 2
                await _wait_all_height(nodes, top)
                await _wait_all_applied(nodes, top)
                found = set()
                for h in range(1, nodes[0].block_store.height + 1):
                    b = nodes[0].block_store.load_block(h)
                    if b:
                        found.update(b.data.txs)
                assert b"alpha=1" in found
                assert b"beta=2" in found
                q = await nodes[2].app.query(
                    abci.QueryRequest(data=b"alpha"))
                assert q.value == b"1"
            finally:
                await _stop_all(nodes)
        run(go())

    def test_late_joiner_catches_up(self):
        async def go():
            doc, pvs = _doc(4)
            nodes = [PNode(doc, pv) for pv in pvs[:3]]
            late = PNode(doc, pvs[3])
            try:
                for n in nodes:
                    await n.start()
                await _mesh(nodes)
                await _wait_all_height(nodes, 3)
                # the 4th validator joins late and catches up by gossip
                await late.start()
                for o in nodes:
                    await asyncio.wait_for(
                        late.switch.dial_peer(o.switch.listen_addr), 20)
                target = nodes[0].block_store.height + 2
                await _wait_all_height([late], target, timeout=45.0)
                assert late.block_store.height >= target
                assert late.block_store.load_block(2).hash() == \
                    nodes[0].block_store.load_block(2).hash()
            finally:
                await _stop_all(nodes + [late])
        run(go())


# -- PeerState in both packages -----------------------------------------------

class _Peer:
    """A peer stand-in: an id, advertised features, the sends."""

    def __init__(self, pid="aa" * 20, features=()):
        self.id = pid
        self.sent = []
        self.node_info = SimpleNamespace(features=tuple(features))
        self.data = {}

    def has_feature(self, name):
        return name in self.node_info.features

    def send(self, chan_id, payload):
        self.sent.append((chan_id, payload))
        return True


def _bits(rng, n):
    return BitArray.from_indices(n, [i for i in range(n) if rng.random() < .4])


def _bid(rng):
    return BlockID(rng.bytes(32), PartSetHeader(int(rng.integers(1, 5)),
                                                rng.bytes(32)))


def _peer_sequence(seed, n_vals, length=400):
    """A seeded sequence of (kind, port message or args) that moves a peer
    across heights 1-4 and rounds 0-2."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(length):
        h, r = int(rng.integers(1, 5)), int(rng.integers(0, 3))
        kind = int(rng.integers(0, 11))
        t = canonical.PREVOTE_TYPE if rng.random() < .5 else \
            canonical.PRECOMMIT_TYPE
        if kind == 0:
            out.append(("msg", pm.NewRoundStepMessage(
                height=h, round=r, step=int(rng.integers(1, 9)),
                seconds_since_start_time=3,
                last_commit_round=int(rng.integers(-1, 3)))))
        elif kind == 1:
            psh = PartSetHeader(int(rng.integers(1, 6)), rng.bytes(32))
            out.append(("msg", pm.NewValidBlockMessage(
                height=h, round=r, block_part_set_header=psh,
                block_parts=_bits(rng, psh.total),
                is_commit=bool(rng.random() < .3))))
        elif kind == 2:
            out.append(("msg", pm.HasVoteMessage(
                height=h, round=r, type=t,
                index=int(rng.integers(0, n_vals)))))
        elif kind == 3:
            out.append(("msg", pm.HasProposalBlockPartMessage(
                height=h, round=r, index=int(rng.integers(0, 5)))))
        elif kind == 4:
            out.append(("msg", pm.ProposalMessage(Proposal(
                height=h, round=r, pol_round=int(rng.integers(-1, r + 1)),
                block_id=_bid(rng), timestamp=Timestamp(1700000000, 5),
                signature=rng.bytes(64)))))
        elif kind == 5:
            out.append(("msg", pm.ProposalPOLMessage(
                height=h, proposal_pol_round=int(rng.integers(-1, 3)),
                proposal_pol=_bits(rng, n_vals))))
        elif kind == 6:
            out.append(("part", (h, r, int(rng.integers(0, 5)))))
        elif kind == 7:
            out.append(("vote", (h, r, t, int(rng.integers(0, n_vals)))))
        elif kind == 8:
            ours = _bits(rng, n_vals) if rng.random() < .5 else None
            out.append(("bits", (pm.VoteSetBitsMessage(
                height=h, round=r, type=t, block_id=_bid(rng),
                votes=_bits(rng, n_vals)), ours)))
        elif kind == 9:
            out.append(("catchup", (h, r, n_vals)))
        else:
            out.append(("catchup_parts", (h, PartSetHeader(
                int(rng.integers(1, 6)), rng.bytes(32)))))
    return out


def _snap(prs):
    def ba(b):
        return None if b is None else (b.size(), tuple(b.true_indices()))
    psh = prs.proposal_block_parts_header
    return (prs.height, prs.round, prs.step, prs.proposal,
            (psh.total, psh.hash), ba(prs.proposal_block_parts),
            prs.proposal_pol_round, ba(prs.proposal_pol), ba(prs.prevotes),
            ba(prs.precommits), prs.last_commit_round, ba(prs.last_commit),
            prs.catchup_commit_round, ba(prs.catchup_commit))


def _apply(mod, ps, kind, item, n_vals, to_r):
    """Feed one step to a PeerState of ``mod`` (reactor.py of either
    package); ``to_r`` carries a port message over the wire."""
    if kind == "msg":
        msg = to_r(item)
        if isinstance(msg, (pm.NewRoundStepMessage, rm.NewRoundStepMessage)):
            ps.apply_new_round_step(msg, n_vals)
        elif isinstance(msg, (pm.NewValidBlockMessage,
                              rm.NewValidBlockMessage)):
            ps.apply_new_valid_block(msg)
        elif isinstance(msg, (pm.HasVoteMessage, rm.HasVoteMessage)):
            ps.apply_has_vote(msg)
        elif isinstance(msg, (pm.HasProposalBlockPartMessage,
                              rm.HasProposalBlockPartMessage)):
            ps.apply_has_proposal_block_part(msg)
        elif isinstance(msg, (pm.ProposalMessage, rm.ProposalMessage)):
            ps.apply_proposal(msg)
        else:
            ps.apply_proposal_pol(msg)
    elif kind == "part":
        ps.set_has_proposal_block_part(*item)
    elif kind == "vote":
        ps.set_has_vote(*item)
    elif kind == "bits":
        msg, ours = item
        bits_mod = BitArray if mod is p_reactor else RBitArray
        ours = None if ours is None else \
            bits_mod.from_proto(ours.to_proto())
        ps.apply_vote_set_bits(to_r(msg), ours)
    elif kind == "catchup":
        ps.ensure_catchup_commit_round(*item)
    else:
        h, psh = item
        if mod is r_reactor:
            from cometbft_tpu.types.part_set import PartSetHeader as RPSH
            psh = RPSH(psh.total, psh.hash)
        ps.init_catchup_parts(h, psh)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_peer_state_follows_the_same_messages(seed):
    n_vals = 7
    mine, theirs = PeerState(_Peer()), r_reactor.PeerState(_Peer())
    seq = _peer_sequence(seed, n_vals)
    kinds = set()
    for kind, item in seq:
        _apply(p_reactor, mine, kind, item, n_vals, lambda m: m)
        _apply(r_reactor, theirs, kind, item, n_vals,
               lambda m: rm.decode_p2p(pm.encode_p2p(m)))
        assert _snap(mine.prs) == _snap(theirs.prs), (kind, item)
        kinds.add(kind)
    assert len(kinds) == 6
    assert mine.prs.height > 0


def test_channels_and_features_equal():
    def reactor(mod, cfg):
        cs_ = SimpleNamespace(config=cfg, broadcast_hooks=[], on_new_step=[])
        return mod.ConsensusReactor(cs_)

    for kw in ({}, {"compact_blocks": False}, {"vote_batch_max": 0},
               {"aggregate_commits_wire": False},
               {"compact_blocks": False, "vote_batch_max": 0,
                "aggregate_commits_wire": False}):
        mine = reactor(p_reactor, ConsensusConfig(**kw))
        theirs = reactor(r_reactor, RConsensusConfig(**kw))
        assert [(d.id, d.priority, d.send_queue_capacity,
                 d.recv_message_capacity) for d in mine.get_channels()] == \
            [(d.id, d.priority, d.send_queue_capacity,
              d.recv_message_capacity) for d in theirs.get_channels()] == \
            [(0x20, 6, 200, 22 * 1024 * 1024), (0x21, 10, 100,
                                                  22 * 1024 * 1024),
             (0x22, 7, 800, 22 * 1024 * 1024), (0x23, 1, 2,
                                                 22 * 1024 * 1024)]
        assert mine.get_features() == theirs.get_features()
    assert p_reactor._GOSSIP_RESTART_POLICY == \
        p_reactor.RestartPolicy(**vars(r_reactor._GOSSIP_RESTART_POLICY))


def test_store_catchup_gossip_sends_the_same_bytes():
    """The catch-up arms of the data and votes routines on one stored
    chain in both packages: the parts and the precommits a lagging peer is
    sent, in order, byte for byte."""
    key_seeds = seeds(5, 414)
    mine, theirs = port_chain("gossip", key_seeds), RChain("gossip",
                                                         key_seeds)
    for h in range(1, 4):
        txs = [cs._load_tx(9, h, j) for j in range(300)]   # two parts
        mine.step(txs)
        theirs.step(txs)

    def drive(mod, chain, h):
        cs_ = SimpleNamespace(config=ConsensusConfig(),
                              block_store=chain.block_store)
        reactor = mod.ConsensusReactor.__new__(mod.ConsensusReactor)
        reactor.cs = cs_
        peer = _Peer()
        ps = mod.PeerState(peer)
        ps.prs.height, ps.prs.round = h, 0
        while run(reactor._gossip_catchup(ps)):
            pass
        commit = chain.block_store.load_block_commit(h)
        while reactor._pick_send_commit_vote(ps, commit):
            pass
        return peer.sent, _snap(ps.prs)

    for h in (1, 2):
        got, want = drive(p_reactor, mine, h), drive(r_reactor, theirs, h)
        assert got == want
        kinds = [type(pm.decode_p2p(raw)).__name__ for _, raw in got[0]]
        assert kinds == ["BlockPartMessage"] * 2 + ["VoteMessage"] * 5


def test_state_machine_broadcasts_route_alike():
    """What the reactor puts on which channel for each broadcast of the
    state machine and for a new step, byte for byte in both packages."""
    from cometbft_tpu.types.part_set import PartSet as RPartSet
    from cometbft_tpu_torch.consensus.round_state import STEP_COMMIT
    from cometbft_tpu_torch.types.part_set import PartSet
    rng = np.random.default_rng(23)
    data = rng.bytes(70_000)                 # two parts
    vote = Vote(type=canonical.PRECOMMIT_TYPE, height=3, round=1,
                block_id=_bid(rng), timestamp=Timestamp(1700000003, 9),
                validator_address=rng.bytes(20), validator_index=2,
                signature=rng.bytes(64))
    proposal = Proposal(height=3, round=1, pol_round=0, block_id=_bid(rng),
                        timestamp=Timestamp(1700000003, 1),
                        signature=rng.bytes(64))
    part = PartSet.from_data(data).get_part(1)
    msgs = [pm.ProposalMessage(proposal),
            pm.BlockPartMessage(height=3, round=1, part=part),
            pm.VoteMessage(vote), ("has_vote", vote), ("valid_block",),
            "new_step"]

    def to_r(msg):
        if isinstance(msg, tuple) and msg[0] == "has_vote":
            return ("has_vote", rm.decode_p2p(pm.encode_p2p(
                pm.VoteMessage(msg[1]))).vote)
        if isinstance(msg, (tuple, str)):
            return msg
        return rm.decode_p2p(pm.encode_p2p(msg))

    def route(mod, msg, parts):
        sent = []
        peer = _Peer()
        peer.send = lambda ch, raw: sent.append(("send", ch, raw)) or True
        rs = SimpleNamespace(height=3, round=1, step=STEP_COMMIT,
                             proposal_block_parts=parts, last_commit=None)
        reactor = mod.ConsensusReactor.__new__(mod.ConsensusReactor)
        reactor.cs = SimpleNamespace(config=ConsensusConfig(), rs=rs,
                                     seconds_since_start=lambda: 5)
        reactor._peer_states = {}
        reactor.switch = SimpleNamespace(
            peers={peer.id: peer},
            broadcast=lambda ch, raw: sent.append(("all", ch, raw)))
        if msg == "new_step":
            reactor._on_new_step(rs)
        else:
            reactor._on_cs_broadcast(msg)
        return sent

    for msg in msgs:
        mine = route(p_reactor, msg, PartSet.from_data(data))
        theirs = route(r_reactor, to_r(msg), RPartSet.from_data(data))
        assert mine == theirs and mine, msg
    chans = [[c for _, c, _ in route(p_reactor, m, PartSet.from_data(data))]
             for m in msgs]
    assert chans == [[0x21], [0x21], [0x22, 0x20], [0x20], [0x20], [0x20]]


# -- tests/test_aggregate_commit.py TestPeerRefusalActivation ----------------

class TestPeerRefusalActivation:
    @staticmethod
    def _reactor_at(last_block_height, enable_height):
        sm = SimpleNamespace(
            last_block_height=last_block_height,
            consensus_params=SimpleNamespace(feature=SimpleNamespace(
                aggregate_commit_enable_height=enable_height)))
        fake = SimpleNamespace(cs=SimpleNamespace(sm_state=sm))
        return ConsensusReactor._chain_uses_aggregate_commits(fake)

    def test_inactive_before_enable_height(self):
        assert self._reactor_at(10, 500_000) is False
        assert self._reactor_at(0, 0) is False      # ed25519 chain
        assert self._reactor_at(10**6, 0) is False  # never enabled

    def test_active_at_and_past_enable_height(self):
        assert self._reactor_at(99, 100) is True
        assert self._reactor_at(100, 100) is True
        assert self._reactor_at(10**6, 100) is True
        assert self._reactor_at(0, 1) is True

    def test_add_peer_refuses_a_peer_without_aggcommit(self):
        async def go():
            sm = SimpleNamespace(
                last_block_height=9, consensus_params=SimpleNamespace(
                    feature=SimpleNamespace(
                        aggregate_commit_enable_height=5)))
            cs_ = SimpleNamespace(config=ConsensusConfig(), sm_state=sm,
                                  broadcast_hooks=[], on_new_step=[])
            reactor = ConsensusReactor(cs_)
            stopped = []

            async def stop_peer(peer, reason):
                stopped.append((peer.id, reason))

            reactor.switch = SimpleNamespace(stop_peer=stop_peer,
                                             supervisor=reactor.supervisor)
            await reactor.add_peer(_Peer("bb" * 20, ("votebatch/1",)))
            await asyncio.sleep(0.01)
            assert stopped == [("bb" * 20, "incompatible: no aggcommit/1")]
            assert reactor._peer_states == {}
            await reactor.supervisor.stop()
        run(go())


# -- tests/test_recon_gossip.py TestVoteGossipUntrackedSet --------------------

class TestVoteGossipUntrackedSet:
    def _mk_reactor_and_ps(self, vote_batch_max=16):
        cfg = ConsensusConfig(vote_batch_max=vote_batch_max)
        cs_ = SimpleNamespace(config=cfg, metrics=Metrics(),
                              broadcast_hooks=[], on_new_step=[], rs=None)
        reactor = ConsensusReactor.__new__(ConsensusReactor)
        reactor.cs = cs_
        peer = _Peer(features=("votebatch/1",))
        return reactor, PeerState(peer), peer

    def _mk_vote_set(self, height=5, round_=0, n=4):
        ours = BitArray(n)
        ours.set_index(0, True)
        votes = {0: Vote(type=canonical.PREVOTE_TYPE, height=height,
                         round=round_, block_id=BlockID(),
                         timestamp=Timestamp(1700000000, 0),
                         validator_address=b"v" * 20,
                         validator_index=0, signature=b"s" * 64)}
        return SimpleNamespace(
            height=height, round=round_,
            signed_msg_type=canonical.PREVOTE_TYPE,
            bit_array=lambda: ours, is_commit=lambda: False,
            size=lambda: n, get_by_index=lambda i: votes.get(i))

    def test_untracked_set_sends_nothing(self):
        reactor, ps, peer = self._mk_reactor_and_ps()
        vs = self._mk_vote_set(height=5)
        assert reactor._pick_send_vote(ps, vs) is False
        assert peer.sent == []

    def test_tracked_set_sends_and_marks(self):
        reactor, ps, peer = self._mk_reactor_and_ps()
        vs = self._mk_vote_set(height=5)
        ps.prs.height = 5
        ps.prs.round = 0
        ps.prs.prevotes = BitArray(4)
        assert reactor._pick_send_vote(ps, vs) is True
        assert len(peer.sent) == 1
        # the batch went out as a VoteBatchMessage, byte-equal in JAX
        chan, raw = peer.sent[0]
        assert chan == p_reactor.VOTE_CHANNEL
        assert isinstance(pm.decode_p2p(raw), pm.VoteBatchMessage)
        assert rm.encode_p2p(rm.decode_p2p(raw)) == raw
        assert ps.prs.prevotes.get_index(0)
        assert reactor._pick_send_vote(ps, vs) is False
        assert len(peer.sent) == 1

    def test_last_commit_of_another_round_reaches_a_peer_behind(self):
        """C.6: a peer one height behind, at round 0 of that height, and
        our last commit made at round 1.  The commit is tracked as the
        peer's catch-up commit and its votes go out (reference:
        PickVoteToSend's ensureCatchupCommitRound); the JAX reactor sends
        nothing, and such a peer waits for txs at that height forever on
        a net that makes no empty blocks."""
        n = 4
        ours = BitArray.from_indices(n, [0, 1, 2])
        votes = {i: Vote(type=canonical.PRECOMMIT_TYPE, height=5, round=1,
                         block_id=BlockID(b"\x05" * 32,
                                          PartSetHeader(1, b"\x06" * 32)),
                         timestamp=Timestamp(1700000000, 0),
                         validator_address=bytes([i]) * 20,
                         validator_index=i, signature=b"s" * 64)
                 for i in range(3)}
        commit = SimpleNamespace(
            height=5, round=1, signed_msg_type=canonical.PRECOMMIT_TYPE,
            bit_array=lambda: ours, is_commit=lambda: True,
            size=lambda: n, get_by_index=lambda i: votes.get(i))
        sent = {}
        for mod in (p_reactor, r_reactor):
            reactor = mod.ConsensusReactor.__new__(mod.ConsensusReactor)
            reactor.cs = SimpleNamespace(
                config=ConsensusConfig(vote_batch_max=0), metrics=Metrics())
            peer = _Peer()
            ps = mod.PeerState(peer)
            ps.prs.height, ps.prs.round = 5, 0
            ps.prs.step = p_reactor.STEP_NEW_HEIGHT
            ps.prs.precommits = BitArray(n)
            while reactor._pick_send_vote(ps, commit):
                pass
            sent[mod] = [pm.decode_p2p(raw).vote.validator_index
                         for _, raw in peer.sent]
        assert sorted(sent[p_reactor]) == [0, 1, 2]
        assert sent[r_reactor] == []


# -- a mixed net over real sockets --------------------------------------------

def test_mixed_net_over_sockets_commits_one_chain():
    key_seeds = seeds(4, 412)
    p_keys = [p_ed.Ed25519PrivKey(s) for s in key_seeds]
    r_keys = [r_ed.Ed25519PrivKey(s) for s in key_seeds]
    doc, _ = _doc(4, "mixed-sock", keys=p_keys)
    r_doc = RGenesisDoc(
        chain_id="mixed-sock", genesis_time=RTimestamp(1700000000, 0),
        validators=[RGenesisValidator(address=b"", pub_key=k.pub_key(),
                                      power=10) for k in r_keys])

    async def go():
        # order: port, JAX, port, JAX — each package dials the other
        nodes = [PNode(doc, MockPV(p_keys[0])),
                 RNode(r_doc, RMockPV(r_keys[1])),
                 PNode(doc, MockPV(p_keys[2])),
                 RNode(r_doc, RMockPV(r_keys[3]))]
        try:
            for n in nodes:
                await n.switch.start()
            await _mesh(nodes)
            for n in nodes:
                await n.cs.start()
            await _wait_all_height(nodes, 5, timeout=60.0)
        finally:
            await _stop_all(nodes)
        return nodes

    nodes = run(go())
    for h in range(1, 6):
        assert len({n.block_store.load_block(h).hash() for n in nodes}) == 1
        assert len({n.block_store.load_block_meta(h).header.app_hash
                    for n in nodes}) == 1
    proposers = {nodes[0].block_store.load_block(h).header.proposer_address
                 for h in range(1, 6)}
    # blocks of both packages' proposers, each carried to the other
    assert proposers & {k.pub_key().address() for k in p_keys[::2]}
    assert proposers & {k.pub_key().address() for k in p_keys[1::2]}


# -- chip_smoke.py's phase 13, rehearsed on the CPU ---------------------------

def test_phase_13_rehearsed_at_12_validators(monkeypatch):
    """Phases 12 and 13 run as on the card, the kernels replaced by the
    stand-in that accepts every lane and counts a launch, at 12 validators
    for 6 heights (phase 12 leaves the chain phase 13's server serves),
    a 5-height socket net and 30 AEAD inputs."""
    class SerialPool:
        def map(self, fn, items, chunksize=None):
            return [fn(x) for x in items]

    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    monkeypatch.setattr(cs, "_edge_items",
                        lambda seed, pool: [(bytes(32), b"m", bytes(64))])
    for name, value in (("EXEC_VALIDATORS", 12), ("CS_HEIGHTS", 6),
                        ("EXEC_UPDATES", (2, 3, 4)), ("CS_TRACED", 2),
                        ("NET_HEIGHTS", 3), ("HOST_INPUTS", 10),
                        ("HOST_TIMED", 3), ("SOCK_HEIGHTS", 5),
                        ("CATCHUP_HEIGHTS", 6), ("AEAD_INPUTS", 30)):
        monkeypatch.setattr(cs, name, value)
    keep = {}
    cs._cs_phases(0, "CPU", SerialPool(), device="cpu", keep=keep)
    assert set(keep) == {"chain", "dbs", "net_ms"}
    assert keep["chain"].states[7] == keep["chain"].state.bytes()
    launches = cs._p2p_phases(0, "CPU", keep, device="cpu")
    assert set(launches) == {"sock_4x5", "catchup_12x6", "p2p_reject"}
    # 13a: each node's validate_block a height after the first, and the
    # bursts; 13b: the joiner's validate_block a height and its bursts
    assert launches["sock_4x5"] >= 4 * 4
    assert launches["catchup_12x6"] >= 6
    assert launches["p2p_reject"] > 0
