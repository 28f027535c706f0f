"""Every consensus message of the port (consensus/messages.py,
wire/consensus_pb.py) against the JAX package's, and the round state and
adaptive timeouts of tests/test_pipeline.py run against the port.

  * each of the fourteen ``Message`` arms: the port's ``encode_p2p`` bytes
    equal the JAX package's for the same message, each package decodes
    the other's bytes back to the same message, and the decoded kind is
    the one sent;
  * the WAL form: ``to_wal`` records (JSON) of the four logged kinds are
    equal in both packages, and ``message_from_wal`` of either package
    rebuilds the other's message; ``jsonify`` / ``dejsonify`` round trip;
  * the compact form of a real block: ``make_compact_block`` gives the
    same bytes in both packages and ``reconstruct_block_bytes`` rebuilds
    the block's exact encoding;
  * ``RoundState``'s transition seam and ``AdaptiveTimeouts``' arithmetic
    as the JAX tests check them, the floats compared with ``==`` against
    the JAX package's on the same samples.
"""
import json

import numpy as np
import pytest

from cometbft_tpu.consensus import adaptive as r_adaptive
from cometbft_tpu.consensus import messages as rm
from cometbft_tpu.types.block import Block as RBlock
from cometbft_tpu_torch.consensus import messages as pm
from cometbft_tpu_torch.consensus.adaptive import AdaptiveTimeouts
from cometbft_tpu_torch.consensus.round_state import (
    STEP_PRECOMMIT, STEP_PREVOTE, STEP_PROPOSE, RoundState, TimeoutInfo)
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import AggregateCommit
from cometbft_tpu_torch.types.part_set import Part, PartSet, PartSetHeader
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.wire import pb
from torch_chain import accept_all, port_chain, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

_MS = 1_000_000
_S = 1_000_000_000

RNG = np.random.default_rng(311)


def _b(n):
    return RNG.bytes(n)


def _bid():
    return BlockID(_b(32), PartSetHeader(3, _b(32)))


def _vote(type_=2, ext=False):
    v = Vote(type=type_, height=12, round=1, block_id=_bid(),
             timestamp=Timestamp(1_700_000_012, 345), validator_address=_b(20),
             validator_index=3, signature=_b(64))
    if ext:
        v.extension, v.extension_signature = _b(40), _b(64)
        v.non_rp_extension, v.non_rp_extension_signature = _b(8), _b(64)
    return v


def _bits(n, idx):
    return BitArray.from_indices(n, idx)


def _part():
    ps = PartSet.from_data(_b(5000), part_size=1024)
    return ps.get_part(3)


def _messages():
    """One message of each kind (two where a field may be absent)."""
    agg = AggregateCommit(height=9, round=0, block_id=_bid(),
                          signers=_bits(7, [0, 2, 3, 6]), signature=_b(96))
    return [
        pm.ProposalMessage(Proposal(height=5, round=2, pol_round=1,
                                    block_id=_bid(),
                                    timestamp=Timestamp(1_700_000_005, 9),
                                    signature=_b(64))),
        pm.BlockPartMessage(height=5, round=2, part=_part()),
        pm.BlockPartMessage(height=0, round=0, part=_part()),
        pm.VoteMessage(_vote()),
        pm.VoteMessage(_vote(ext=True)),
        pm.NewRoundStepMessage(height=5, round=2, step=STEP_PREVOTE,
                               seconds_since_start_time=3,
                               last_commit_round=1),
        pm.NewRoundStepMessage(height=1, round=0, step=1),
        pm.NewValidBlockMessage(height=5, round=2,
                                block_part_set_header=PartSetHeader(4, _b(32)),
                                block_parts=_bits(4, [1, 3]), is_commit=True),
        pm.NewValidBlockMessage(height=5, round=0,
                                block_part_set_header=PartSetHeader(1, _b(32))),
        pm.HasVoteMessage(height=5, round=2, type=2, index=7),
        pm.VoteSetMaj23Message(height=5, round=2, type=1, block_id=_bid()),
        pm.VoteSetBitsMessage(height=5, round=2, type=2, block_id=_bid(),
                              votes=_bits(70, [0, 5, 64, 69])),
        pm.ProposalPOLMessage(height=5, proposal_pol_round=1,
                              proposal_pol=_bits(9, [2, 8])),
        pm.HasProposalBlockPartMessage(height=5, round=2, index=3),
        pm.CompactBlockPartMessage(height=5, round=0,
                                   part_set_header=PartSetHeader(1, _b(32)),
                                   skeleton=_b(300),
                                   tx_hashes=[_b(32) for _ in range(3)]),
        pm.CompactBlockNackMessage(height=5, round=1),
        pm.VoteBatchMessage([_vote(1), _vote(2, ext=True)]),
        pm.AggregateCommitMessage(agg),
    ]


MESSAGES = _messages()


def _canon(raw_module, raw):
    """A decoded message as its re-encoding in the same package."""
    return raw_module.encode_p2p(raw_module.decode_p2p(raw))


@pytest.mark.parametrize("i", range(len(MESSAGES)),
                         ids=[f"{m.TYPE}-{i}" for i, m in enumerate(MESSAGES)])
def test_p2p_bytes_equal_and_cross_decode(i):
    msg = MESSAGES[i]
    mine = pm.encode_p2p(msg)
    theirs_msg = rm.decode_p2p(mine)
    assert type(theirs_msg).__name__ == type(msg).__name__
    assert rm.encode_p2p(theirs_msg) == mine
    back = pm.decode_p2p(rm.encode_p2p(theirs_msg))
    assert type(back) is type(msg)
    assert pm.encode_p2p(back) == mine
    assert _canon(pm, mine) == _canon(rm, mine)


def test_every_arm_is_covered():
    kinds = {type(m) for m in MESSAGES}
    assert len(kinds) == 14
    with pytest.raises(ValueError, match="cannot encode message"):
        pm.encode_p2p(object())
    with pytest.raises(ValueError, match="unknown consensus message"):
        pm.decode_p2p(b"")


WAL_KINDS = [m for m in MESSAGES if hasattr(m, "to_wal")]


@pytest.mark.parametrize("i", range(len(WAL_KINDS)))
def test_wal_records_equal_and_cross_replay(i):
    msg = WAL_KINDS[i]
    mine = json.dumps(msg.to_wal(), sort_keys=True)
    theirs_msg = rm.decode_p2p(pm.encode_p2p(msg))
    assert json.dumps(theirs_msg.to_wal(), sort_keys=True) == mine
    rebuilt = rm.message_from_wal(json.loads(mine))
    assert rm.encode_p2p(rebuilt) == pm.encode_p2p(msg)
    ours = pm.message_from_wal(json.loads(json.dumps(theirs_msg.to_wal())))
    assert pm.encode_p2p(ours) == pm.encode_p2p(msg)


def test_wal_kinds_and_unknown_type():
    assert sorted(m.TYPE for m in WAL_KINDS) == sorted(
        ["proposal", "block_part", "block_part", "vote", "vote",
         "aggregate_commit"])
    with pytest.raises(ValueError, match="unknown WAL message type"):
        pm.message_from_wal({"type": "timeout"})


def test_jsonify_round_trip():
    obj = {"a": b"\x00\xff", "b": [1, b"x", {"c": b""}], "d": "s"}
    js = pm.jsonify(obj)
    assert js == rm.jsonify(obj)
    assert json.loads(json.dumps(js)) == js
    assert pm.dejsonify(js) == obj == rm.dejsonify(js)


@pytest.fixture(scope="module")
def block():
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        chain = port_chain("msg-chain", seeds(2, 312))
        txs = [b"k%d=v%d" % (j, j) for j in range(pm.COMPACT_MIN_TXS + 3)]
        return chain.step(txs)[0]


def test_compact_block_equals_the_jax_packages(block):
    r_block = RBlock.from_proto(block.to_proto())
    parts = block.make_part_set()
    mine = pm.make_compact_block(7, 0, block, parts.header())
    theirs = rm.make_compact_block(7, 0, r_block,
                                   rm.decode_p2p(pm.encode_p2p(mine))
                                   .part_set_header)
    assert pm.encode_p2p(mine) == rm.encode_p2p(theirs)
    assert len(mine.tx_hashes) == len(block.data.txs)
    from cometbft_tpu_torch.wire import encode
    want = encode(pb.BLOCK, block.to_proto())
    got = pm.reconstruct_block_bytes(mine.skeleton, list(block.data.txs))
    assert got == want == rm.reconstruct_block_bytes(theirs.skeleton,
                                                    list(block.data.txs))
    assert PartSet.from_data(got).header() == parts.header()


# -- tests/test_pipeline.py TestRoundStateSeam, against the port ----------

def test_advance_is_monotonic():
    rs = RoundState()
    rs.height = 5
    rs.advance(0, 3)
    rs.advance(0, 4)
    rs.advance(1, 2)
    with pytest.raises(RoundState.TransitionError):
        rs.advance(0, 8)
    with pytest.raises(RoundState.TransitionError):
        rs.advance(1, 1)


def test_relock_requires_live_lock():
    rs = RoundState()
    with pytest.raises(RoundState.TransitionError):
        rs.relock(2)
    rs.lock(1, object(), object())
    rs.relock(3)
    with pytest.raises(RoundState.TransitionError):
        rs.relock(2)


def test_set_valid_monotonic():
    rs = RoundState()
    rs.set_valid(2, object(), object())
    with pytest.raises(RoundState.TransitionError):
        rs.set_valid(1, object(), object())


def test_round_state_texts_equal_the_jax_packages():
    from cometbft_tpu.consensus.round_state import RoundState as RRS
    from cometbft_tpu.consensus.round_state import TimeoutInfo as RTI
    for step in (STEP_PROPOSE, STEP_PREVOTE, STEP_PRECOMMIT):
        mine, theirs = RoundState(height=4, round=1, step=step), \
            RRS(height=4, round=1, step=step)
        assert str(mine) == str(theirs)
        assert mine.event_summary() == theirs.event_summary()
        assert str(TimeoutInfo(40 * _MS, 4, 1, step)) == \
            str(RTI(40 * _MS, 4, 1, step))
    rs = RoundState()
    with pytest.raises(RoundState.TransitionError) as e1:
        rs.mark_timeout_precommit(-1)
    r = RRS()
    with pytest.raises(RRS.TransitionError) as e2:
        r.mark_timeout_precommit(-1)
    assert str(e1.value) == str(e2.value)


# -- tests/test_pipeline.py TestAdaptiveTimeouts, against the port --------

FLOOR, CEIL = 200 * _MS, 10 * _S


def _pair(**kw):
    return AdaptiveTimeouts(FLOOR, CEIL, **kw), \
        r_adaptive.AdaptiveTimeouts(FLOOR, CEIL, **kw)


def _same(a, b):
    assert a.ewma_s() == b.ewma_s()
    assert a.p95_s() == b.p95_s()
    assert a.propose_timeout_ns() == b.propose_timeout_ns()
    assert a.vote_timeout_ns() == b.vote_timeout_ns()
    for static in (50 * _MS, 1 * _S):
        assert a.commit_padding_ns(static) == b.commit_padding_ns(static)


def test_empty_falls_back_to_static():
    a, b = _pair()
    assert a.propose_timeout_ns() is None
    assert a.vote_timeout_ns() is None
    assert a.commit_padding_ns(1 * _S) == 1 * _S
    _same(a, b)


def test_respects_floor_and_ceiling():
    a, b = _pair()
    for _ in range(16):
        a.observe(0.001)
        b.observe(0.001)
    assert a.propose_timeout_ns() == FLOOR
    assert a.vote_timeout_ns() == FLOOR
    _same(a, b)
    a, b = _pair()
    for _ in range(16):
        a.observe(60.0)
        b.observe(60.0)
    assert a.propose_timeout_ns() == CEIL
    assert a.vote_timeout_ns() == CEIL
    _same(a, b)


def test_never_below_measured_p95():
    a, b = _pair()
    for x in [0.01] * 64 + [2.0] * 60:
        a.observe(x)
        b.observe(x)
    p95_ns = int(a.p95_s() * 1e9)
    assert a.p95_s() == 2.0
    assert a.propose_timeout_ns() >= p95_ns
    assert a.vote_timeout_ns() >= p95_ns
    _same(a, b)


def test_commit_padding_only_shrinks():
    a, b = _pair()
    for _ in range(16):
        a.observe(0.01)
        b.observe(0.01)
    assert a.commit_padding_ns(1 * _S) < 1 * _S
    assert a.commit_padding_ns(1 * _S) >= FLOOR
    assert a.commit_padding_ns(50 * _MS) == 50 * _MS
    _same(a, b)


def test_ewma_rises_fast_decays_slow():
    a, b = _pair(alpha=0.5, window=4)
    for x, want in ((1.0, 1.0), (3.0, 3.0)):
        a.observe(x)
        b.observe(x)
        assert a.ewma_s() == want
    for _ in range(4):
        a.observe(1.0)
        b.observe(1.0)
    assert a.p95_s() == 1.0
    assert 1.0 < a.ewma_s() < 3.0
    _same(a, b)


def test_seeded_delays_give_equal_floats():
    rng = np.random.default_rng(313)
    a, b = _pair(alpha=0.3, window=16)
    for x in rng.lognormal(-3.0, 1.0, size=200):
        a.observe(float(x))
        b.observe(float(x))
        _same(a, b)


def test_bad_arguments_raise_the_same_text():
    for kw in ({"alpha": 0.0}, {"alpha": 1.5}):
        with pytest.raises(ValueError) as e1:
            AdaptiveTimeouts(FLOOR, CEIL, **kw)
        with pytest.raises(ValueError) as e2:
            r_adaptive.AdaptiveTimeouts(FLOOR, CEIL, **kw)
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError) as e1:
        AdaptiveTimeouts(CEIL, FLOOR)
    with pytest.raises(ValueError) as e2:
        r_adaptive.AdaptiveTimeouts(CEIL, FLOOR)
    assert str(e1.value) == str(e2.value)


def test_part_round_trips():
    part = _part()
    assert Part.from_proto(part.to_proto()) == part
