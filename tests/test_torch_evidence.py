"""The port's evidence pool and reactor (evidence/{pool,reactor}.py) and
NodeProvider (light/provider.py) against the JAX package's, over the
same seeded chain built in both packages (tests/torch_chain.py):

  * tests/test_blocksync_evidence.py ``TestEvidencePool`` (conflicting
    votes become evidence, committed evidence refused, tampered evidence
    refused) and tests/test_lc_attack.py's two cases (a forged witness's
    light-client attack found by the light client and admitted by a
    peer's pool; a tampered byzantine attribution refused), each run in
    both packages, with the same verdicts and texts;
  * every refusal of ``verify`` and ``check_evidence`` the pools share,
    with the same error type and text in both;
  * both pools' db rows byte-equal after the same operations;
  * the evidence list message byte-equal and cross-decoded, and the
    reactor's receive and broadcast paths;
  * ``convert.evidence`` round trips for both kinds;
  * ``NodeProvider`` returning the same light blocks as the JAX one over
    the same stores;
  * the light-client attack verified by B1's plain version (no stand-in
    kernel), and a kernel that raises inside verification surfacing as
    itself from the pool, the reactor and the block executor.

The port runs ``device="cpu"``; logic tests use the accept-all stand-in
kernel, the JAX package its ``cpu`` backend.  Tolerance is byte equality.
"""
import asyncio
import dataclasses
from types import SimpleNamespace

import pytest
import torch

import cometbft_tpu.evidence.pool as r_pool
import cometbft_tpu.evidence.reactor as r_ev_reactor
import cometbft_tpu.light.client as r_client
import cometbft_tpu.light.provider as r_provider
import cometbft_tpu.light.store as r_store
import cometbft_tpu.types.block as r_block
import cometbft_tpu.types.block_id as r_block_id
import cometbft_tpu.types.canonical as r_canonical
import cometbft_tpu.types.commit as r_commit
import cometbft_tpu.types.evidence as r_evidence
import cometbft_tpu.types.part_set as r_part_set
import cometbft_tpu.types.timestamp as r_timestamp
import cometbft_tpu.types.vote as r_vote
import cometbft_tpu_torch.evidence.pool as p_pool
import cometbft_tpu_torch.evidence.reactor as p_ev_reactor
import cometbft_tpu_torch.light.client as p_client
import cometbft_tpu_torch.light.provider as p_provider
import cometbft_tpu_torch.light.store as p_store
import cometbft_tpu_torch.types.block as p_block
import cometbft_tpu_torch.types.block_id as p_block_id
import cometbft_tpu_torch.types.canonical as p_canonical
import cometbft_tpu_torch.types.commit as p_commit
import cometbft_tpu_torch.types.evidence as p_evidence
import cometbft_tpu_torch.types.part_set as p_part_set
import cometbft_tpu_torch.types.timestamp as p_timestamp
import cometbft_tpu_torch.types.vote as p_vote
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu.wire import pb as r_pb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.validation import BlockValidationError
from cometbft_tpu_torch.wire import encode, pb
from torch_chain import RChain, accept_all, cs, port_chain, rows, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "evidence-parity"
N, TOP, FORGE_H = 4, 8, 6
TRUST_PERIOD_NS = 10 * 365 * 24 * 3600 * 10**9


def _ns(pool, reactor, client, provider, store, block, block_id,
        canonical, commit, evidence, part_set, timestamp, vote, ed, memdb):
    return SimpleNamespace(
        EvidencePool=pool.EvidencePool, EvidenceError=pool.EvidenceError,
        reactor=reactor, Client=client.Client,
        DivergenceError=client.DivergenceError,
        TrustOptions=client.TrustOptions,
        NodeProvider=provider.NodeProvider,
        LightBlockNotFoundError=provider.LightBlockNotFoundError,
        TrustedStore=store.TrustedStore, LightBlock=block.LightBlock,
        SignedHeader=block.SignedHeader, BlockID=block_id.BlockID,
        PartSetHeader=part_set.PartSetHeader, canonical=canonical,
        Commit=commit.Commit, CommitSig=commit.CommitSig,
        DuplicateVoteEvidence=evidence.DuplicateVoteEvidence,
        LightClientAttackEvidence=evidence.LightClientAttackEvidence,
        Timestamp=timestamp.Timestamp, Vote=vote.Vote,
        FLAG_COMMIT=vote.BLOCK_ID_FLAG_COMMIT, Priv=ed.Ed25519PrivKey,
        MemDB=memdb)


PKGS = {
    "jax": _ns(r_pool, r_ev_reactor, r_client, r_provider, r_store, r_block,
               r_block_id, r_canonical, r_commit, r_evidence, r_part_set,
               r_timestamp, r_vote, r_ed, RMemDB),
    "port": _ns(p_pool, p_ev_reactor, p_client, p_provider, p_store,
                p_block, p_block_id, p_canonical, p_commit, p_evidence,
                p_part_set, p_timestamp, p_vote, p_ed, MemDB),
}
KW = {"jax": {}, "port": {"device": "cpu"}}


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
    key_seeds = seeds(N, 131)
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        p = port_chain(CHAIN_ID, key_seeds)
        r = RChain(CHAIN_ID, key_seeds)
        for h in range(1, TOP + 1):
            txs = [cs._load_tx(13, h, j) for j in range(3)]
            assert p.step(txs)[0].hash() == r.step(txs).hash()
    seed_of = {addr: s for addr, s in p.seed_of.items()}
    return {"port": p, "jax": r, "seed_of": seed_of}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _pool(name, chains, db=None):
    pk, chain = PKGS[name], chains[name]
    return pk.EvidencePool(db if db is not None else pk.MemDB(),
                           chain.state_store, chain.block_store, **KW[name])


def _dup_votes(name, chains, height=2, index=0, stamp=1_700_000_050):
    """Two prevotes of validator ``index`` at ``height`` for two block ids
    (test_blocksync_evidence.py _make_duplicate_votes), signed with the
    chain's seeded key."""
    pk, chain = PKGS[name], chains[name]
    val = chain.state_store.load_validators(height).validators[index]
    priv = pk.Priv(chains["seed_of"][val.address])
    votes = []
    for i in (1, 2):
        bid = pk.BlockID(hash=bytes([i]) * 32,
                         part_set_header=pk.PartSetHeader(
                             1, bytes([i + 10]) * 32))
        v = pk.Vote(type=pk.canonical.PREVOTE_TYPE, height=height, round=0,
                    block_id=bid, timestamp=pk.Timestamp(stamp, 0),
                    validator_address=val.address, validator_index=index)
        v.signature = priv.sign(v.sign_bytes(CHAIN_ID))
        votes.append(v)
    return votes


def _dup_evidence(name, chains, **kw):
    pk, chain = PKGS[name], chains[name]
    v1, v2 = _dup_votes(name, chains, **kw)
    h = v1.height
    return pk.DuplicateVoteEvidence.new(
        v1, v2, chain.block_store.load_block_meta(h).header.time,
        chain.state_store.load_validators(h))


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the verdict is compared
        return type(e).__name__, str(e)
    return None


# -- TestEvidencePool ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PKGS))
def test_conflicting_votes_become_evidence(name, chains, stand_in):
    chain = chains[name]
    pool = _pool(name, chains)
    v1, v2 = _dup_votes(name, chains)
    pool.report_conflicting_votes(v1, v2)
    pool.update(chain.state_store.load(), [])
    pending, size = pool.pending_evidence(1 << 20)
    assert len(pending) == 1 and size > 0
    assert pending[0].height == 2 and pending[0].time == \
        chain.block_store.load_block_meta(2).header.time
    pool2 = _pool(name, chains)
    pool2.add_evidence(pending[0])
    assert len(pool2.all_pending()) == 1
    assert pool.version == pool2.version == 1


@pytest.mark.parametrize("name", sorted(PKGS))
def test_check_evidence_rejects_committed(name, chains, stand_in):
    pk, chain = PKGS[name], chains[name]
    pool = _pool(name, chains)
    ev = _dup_evidence(name, chains)
    pool.add_evidence(ev)
    pool.check_evidence([ev])
    with pytest.raises(pk.EvidenceError, match="duplicate evidence in block"):
        pool.check_evidence([ev, ev])
    pool.update(chain.state_store.load(), [ev])
    with pytest.raises(pk.EvidenceError,
                       match="evidence was already committed"):
        pool.check_evidence([ev])
    assert pool.all_pending() == []
    pool.add_evidence(ev)                       # committed: a no-op
    assert pool.all_pending() == []


@pytest.mark.parametrize("name", sorted(PKGS))
def test_tampered_evidence_rejected(name, chains):
    pk, chain = PKGS[name], chains[name]
    pool = _pool(name, chains)
    v1, v2 = _dup_votes(name, chains)
    v2.signature = bytes(64)
    ev = pk.DuplicateVoteEvidence.new(
        v1, v2, chain.block_store.load_block_meta(2).header.time,
        chain.state_store.load_validators(2))
    with pytest.raises(Exception, match="invalid"):
        pool.add_evidence(ev)
    assert pool.all_pending() == []


def _tamper(name, chains, case):
    """Evidence made invalid in one way, and the pool to judge it."""
    pk, chain = PKGS[name], chains[name]
    pool = _pool(name, chains)
    ev = _dup_evidence(name, chains)
    if case == "total_power":
        ev.total_voting_power += 1
    elif case == "validator_power":
        ev.validator_power += 1
    elif case == "time":
        ev.timestamp = pk.Timestamp(1, 0)
    elif case == "no_header":
        ev.vote_a.height = ev.vote_b.height = TOP + 5
    elif case == "order":
        ev.vote_a, ev.vote_b = ev.vote_b, ev.vote_a
    elif case == "other_validator":
        v = _dup_votes(name, chains, index=1)[1]
        ev.vote_b = v
    elif case == "expired":
        state = chain.state_store.load()
        params = dataclasses.replace(
            state.consensus_params, evidence=dataclasses.replace(
                state.consensus_params.evidence, max_age_num_blocks=1,
                max_age_duration_ns=1))
        pool.state = dataclasses.replace(state, consensus_params=params)
    return pool, ev


@pytest.mark.parametrize("case", ["total_power", "validator_power", "time",
                                  "no_header", "order", "other_validator",
                                  "expired"])
def test_verify_refusals_equal(case, chains, stand_in):
    got = {}
    for name in PKGS:
        pool, ev = _tamper(name, chains, case)
        got[name] = _error(lambda: pool.add_evidence(ev))
        assert pool.all_pending() == []
    assert got["port"] is not None
    assert got["port"] == got["jax"]
    if case == "expired":
        assert got["port"] == ("EvidenceError",
                               "evidence from height 2 is too old")
    if case == "total_power":
        assert got["port"][1].startswith("total voting power mismatch")


def test_db_rows_byte_equal(chains, stand_in):
    dbs = {}
    for name in PKGS:
        chain = chains[name]
        pool = _pool(name, chains)
        evs = [_dup_evidence(name, chains, height=h, index=i)
               for h, i in ((2, 0), (3, 1), (5, 2))]
        for ev in evs[:2]:
            pool.add_evidence(ev)
        v1, v2 = _dup_votes(name, chains, height=4, index=3)
        pool.report_conflicting_votes(v1, v2)
        pool.update(chain.state_store.load(), [evs[0], evs[2]])
        dbs[name] = rows(pool._db)
        assert len(pool.all_pending()) == 2
        assert len(pool.pending_evidence(10)[0]) == 0
    assert dbs["port"] == dbs["jax"] and len(dbs["port"]) == 4


# -- tests/test_lc_attack.py ----------------------------------------------------

def _forge_lunatic_block(name, chains, height):
    """A lunatic header at ``height``: the real header with a forged app
    hash, committed by every validator (test_lc_attack.py
    _forge_lunatic_block)."""
    pk, chain = PKGS[name], chains[name]
    meta = chain.block_store.load_block_meta(height)
    header = dataclasses.replace(meta.header, app_hash=b"\xEE" * 32)
    vals = chain.state_store.load_validators(height)
    forged_id = pk.BlockID(hash=header.hash(),
                           part_set_header=pk.PartSetHeader(1, b"\xAB" * 32))
    sigs = []
    for i, val in enumerate(vals.validators):
        ts = pk.Timestamp(1_700_000_100 + i, 0)
        v = pk.Vote(type=pk.canonical.PRECOMMIT_TYPE, height=height, round=0,
                    block_id=forged_id, timestamp=ts,
                    validator_address=val.address, validator_index=i)
        sig = pk.Priv(chains["seed_of"][val.address]).sign(
            v.sign_bytes(CHAIN_ID))
        sigs.append(pk.CommitSig(block_id_flag=pk.FLAG_COMMIT,
                                 validator_address=val.address,
                                 timestamp=ts, signature=sig))
    commit = pk.Commit(height=height, round=0, block_id=forged_id,
                       signatures=sigs)
    return pk.LightBlock(signed_header=pk.SignedHeader(header=header,
                                                      commit=commit),
                         validator_set=vals)


def _witness(name, chains):
    pk, chain = PKGS[name], chains[name]

    class ForgingWitness(pk.NodeProvider):
        async def light_block(self, height):
            if height == 0:
                height = self.block_store.height
            if height >= FORGE_H:
                return _forge_lunatic_block(name, chains, height)
            return await super().light_block(height)

    return ForgingWitness(chain.block_store, chain.state_store, CHAIN_ID)


def _attack(name, chains):
    """Run the light client against a forging witness; return the
    evidence it reports to the primary."""
    pk, chain = PKGS[name], chains[name]
    primary = pk.NodeProvider(chain.block_store, chain.state_store,
                              CHAIN_ID)
    witness = _witness(name, chains)

    async def go():
        root = await primary.light_block(1)
        client = pk.Client(
            CHAIN_ID, pk.TrustOptions(
                period_ns=TRUST_PERIOD_NS, height=1,
                header_hash=root.signed_header.header.hash()),
            primary, [witness], pk.TrustedStore(pk.MemDB()), **KW[name])
        await client.initialize()
        with pytest.raises(pk.DivergenceError):
            await client.verify_light_block_at_height(FORGE_H)
    asyncio.run(go())
    assert primary.evidence and witness.evidence
    return primary.evidence[0]


@pytest.mark.parametrize("name", sorted(PKGS))
def test_forged_witness_evidence_accepted_by_peer_pool(name, chains,
                                                       stand_in):
    pk = PKGS[name]
    ev = _attack(name, chains)
    assert isinstance(ev, pk.LightClientAttackEvidence)
    assert len(ev.byzantine_validators) == N
    assert ev.conflicting_block.height == FORGE_H
    assert ev.common_height < FORGE_H and ev.height == ev.common_height
    pool = _pool(name, chains)
    pool.add_evidence(ev)
    pending, _ = pool.pending_evidence(1 << 20)
    assert any(p.hash() == ev.hash() for p in pending)
    pool.check_evidence([ev])


@pytest.mark.parametrize("name", sorted(PKGS))
def test_tampered_attribution_rejected(name, chains, stand_in):
    pk = PKGS[name]
    ev = _attack(name, chains)
    ev.byzantine_validators = ev.byzantine_validators[:1]
    pool = _pool(name, chains)
    with pytest.raises(pk.EvidenceError,
                       match=f"expected {N} byzantine validators, got 1"):
        pool.add_evidence(ev)


def test_attack_evidence_equal_and_refusals_equal(chains, stand_in):
    evs = {name: _attack(name, chains) for name in PKGS}
    assert encode(pb.EVIDENCE, evs["port"].to_proto_wrapped()) == \
        r_encode(r_pb.EVIDENCE, evs["jax"].to_proto_wrapped())
    assert evs["port"].hash() == evs["jax"].hash()
    dbs = {}
    for name, ev in evs.items():
        pool = _pool(name, chains)
        pool.add_evidence(ev)
        dbs[name] = rows(pool._db)
    assert dbs["port"] == dbs["jax"]

    def refusal(name, change):
        ev = dataclasses.replace(evs[name])
        change(ev)
        return _error(lambda: _pool(name, chains).add_evidence(ev))

    changes = [
        lambda ev: setattr(ev, "total_voting_power",
                           ev.total_voting_power + 1),
        lambda ev: setattr(ev, "timestamp",
                           type(ev.timestamp)(1_700_000_001, 0)),
        lambda ev: setattr(ev, "byzantine_validators",
                           list(reversed(ev.byzantine_validators))),
    ]
    for change in changes:
        got = {name: refusal(name, change) for name in PKGS}
        assert got["port"] is not None and got["port"] == got["jax"]


def test_attack_verified_on_plain_b1(chains):
    """No stand-in: both commit checks of the light-client attack run B1's
    plain version, two launches' worth of calls into ``verify_cols``."""
    ev = _attack("jax", chains)
    port_ev = convert.evidence(r_encode(r_pb.EVIDENCE,
                                        ev.to_proto_wrapped()))
    calls = []
    real = ek.verify_cols

    def counting(*cols):
        calls.append(int(cols[0].shape[1]))
        return real(*cols)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ek, "verify_cols", counting)
        pool = _pool("port", chains)
        pool.add_evidence(port_ev)
    assert len(calls) == 2
    assert [e.hash() for e in pool.all_pending()] == [ev.hash()]
    # a forged signature is refused with the JAX text
    bad = convert.evidence(r_encode(r_pb.EVIDENCE, ev.to_proto_wrapped()))
    sig = bad.conflicting_block.signed_header.commit.signatures[0]
    sig.signature = bytes([sig.signature[0] ^ 1]) + sig.signature[1:]
    with pytest.raises(p_pool.EvidenceError,
                       match="invalid conflicting block commit"):
        _pool("port", chains).add_evidence(bad)


def test_raising_kernel_surfaces(chains, monkeypatch):
    """A kernel that raises inside the light-client attack check leaves
    the pool, the reactor and the block executor as itself: never an
    EvidenceError, never an invalid block."""
    ev = convert.evidence(r_encode(r_pb.EVIDENCE,
                                   _attack("jax", chains).to_proto_wrapped()))

    def raising(a, r, s, k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ek, "verify_cols", raising)
    pool = _pool("port", chains)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        pool.add_evidence(ev)
    reactor = p_ev_reactor.EvidenceReactor(pool)
    raw = encode(p_ev_reactor.EVIDENCE_LIST_MSG,
                 {"evidence": [ev.to_proto_wrapped()]})
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        run(reactor.receive(0x38, SimpleNamespace(id="ab" * 20), raw))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        reactor.raise_if_failed()
    chain = chains["port"]
    ex = BlockExecutor(chain.state_store, chain.conns.consensus,
                       evpool=pool, block_store=chain.block_store,
                       device="cpu")
    block = chain.block_store.load_block(TOP)
    block.evidence = [ev]
    ex._last_validated_hash = block.hash()   # the LastCommit passed
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ex.validate_block(chain.state_store.load(), block)


def test_invalid_evidence_is_an_invalid_block(chains, stand_in):
    """The executor turns the pool's refusal into BlockValidationError,
    as the JAX executor does."""
    chain = chains["port"]
    pool = _pool("port", chains)
    ev = _dup_evidence("port", chains)
    ev.total_voting_power += 1
    ex = BlockExecutor(chain.state_store, chain.conns.consensus,
                       evpool=pool, block_store=chain.block_store,
                       device="cpu")
    state = chain.state_store.load()
    block = state.make_block(TOP + 1, [], chain.last_commit, [ev],
                             state.validators.get_proposer().address)
    with pytest.raises(BlockValidationError,
                       match="invalid evidence: total voting power mismatch"):
        ex.validate_block(state, block)


# -- the reactor's message and paths --------------------------------------------

def test_evidence_list_message_byte_equal(chains, stand_in):
    msgs = {}
    for name in PKGS:
        pk = PKGS[name]
        evs = [_dup_evidence(name, chains), _attack(name, chains)]
        msgs[name] = pk.reactor.EVIDENCE_LIST_MSG, [
            e.to_proto_wrapped() for e in evs]
    ours = encode(msgs["port"][0], {"evidence": msgs["port"][1]})
    theirs = r_encode(msgs["jax"][0], {"evidence": msgs["jax"][1]})
    assert ours == theirs
    assert p_ev_reactor.EVIDENCE_CHANNEL == r_ev_reactor.EVIDENCE_CHANNEL
    assert [(d.id, d.priority, d.send_queue_capacity) for d in
            p_ev_reactor.EvidenceReactor(None).get_channels()] == \
        [(d.id, d.priority, d.send_queue_capacity) for d in
         r_ev_reactor.EvidenceReactor(None).get_channels()]
    # the port's reactor takes the JAX package's bytes into its pool
    pool = _pool("port", chains)
    reactor = p_ev_reactor.EvidenceReactor(pool)
    run(reactor.receive(0x38, SimpleNamespace(id="ab" * 20), theirs))
    assert len(pool.all_pending()) == 2
    reactor.raise_if_failed()


def test_reactor_drops_bad_messages_and_refused_evidence(chains, stand_in):
    pool = _pool("port", chains)
    reactor = p_ev_reactor.EvidenceReactor(pool)
    peer = SimpleNamespace(id="ab" * 20)
    ev = _dup_evidence("port", chains)
    ev.total_voting_power += 1
    bad_sig = _dup_evidence("port", chains, height=3)
    bad_sig.vote_b.signature = bytes(64)
    for raw in (b"\xff\xff", encode(p_ev_reactor.EVIDENCE_LIST_MSG, {
            "evidence": [ev.to_proto_wrapped()]}),
            encode(p_ev_reactor.EVIDENCE_LIST_MSG, {
                "evidence": [bad_sig.to_proto_wrapped()]})):
        run(reactor.receive(0x38, peer, raw))
    assert pool.all_pending() == []
    reactor.raise_if_failed()


def test_broadcast_routine_sends_each_pending_once(chains, stand_in):
    class Peer:
        id = "cd" * 20

        def __init__(self):
            self.sent = []

        def send(self, ch, raw):
            self.sent.append((ch, raw))
            return True

    async def go():
        pool = _pool("port", chains)
        reactor = p_ev_reactor.EvidenceReactor(pool)
        peer = Peer()
        pool.add_evidence(_dup_evidence("port", chains))
        await reactor.add_peer(peer)
        await asyncio.sleep(0.05)
        pool.add_evidence(_dup_evidence("port", chains, height=3, index=1))
        deadline = asyncio.get_running_loop().time() + 10
        while len(peer.sent) < 2:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.6)           # a further scan sends nothing
        await reactor.remove_peer(peer, "done")
        await reactor.supervisor.stop()
        return peer.sent

    sent = run(go())
    assert [ch for ch, _ in sent] == [0x38, 0x38]
    assert len({raw for _, raw in sent}) == 2


# -- convert and NodeProvider ---------------------------------------------------

def test_convert_evidence_round_trips(chains, stand_in):
    for ev in (_dup_evidence("jax", chains), _attack("jax", chains)):
        wrapped = ev.to_proto_wrapped()
        raw = r_encode(r_pb.EVIDENCE, wrapped)
        for obj in (wrapped, raw):
            got = convert.evidence(obj)
            assert encode(pb.EVIDENCE, got.to_proto_wrapped()) == raw
            assert got.hash() == ev.hash()
            assert got.height == ev.height and got.time == \
                convert.evidence(raw).time


@pytest.mark.parametrize("height", [0, 1, 2, TOP - 1, TOP])
def test_node_provider_same_light_blocks(chains, height):
    got = {}
    for name in PKGS:
        pk, chain = PKGS[name], chains[name]
        prov = pk.NodeProvider(chain.block_store, chain.state_store,
                               CHAIN_ID)
        got[name] = asyncio.run(prov.light_block(height))
        assert prov.id() == f"node-provider:{CHAIN_ID}"
    assert encode(pb.LIGHT_BLOCK, got["port"].to_proto()) == \
        r_encode(r_pb.LIGHT_BLOCK, got["jax"].to_proto())
    assert got["port"].height == (height or TOP)


def test_node_provider_missing_height_and_evidence():
    chain = SimpleNamespace(height=3, load_block_meta=lambda h: None,
                            load_block_commit=lambda h: None,
                            load_seen_commit=lambda h: None)
    prov = p_provider.NodeProvider(chain, None, "c")
    with pytest.raises(p_provider.LightBlockNotFoundError,
                       match="no light block at height 9"):
        asyncio.run(prov.light_block(9))
    asyncio.run(prov.report_evidence("ev"))
    assert prov.evidence == ["ev"]


def test_pool_raises_without_cuda(chains):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    chain = chains["port"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_pool.EvidencePool(MemDB(), chain.state_store, chain.block_store)
