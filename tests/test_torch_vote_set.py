"""The port's VoteSet and HeightVoteSet against the JAX package's
(cometbft_tpu/types/vote_set.py, consensus/height_vote_set.py):

  * the cases of tests/test_types_extra.py:51-135 (``TestVoteSet``),
    each run through both packages on the same votes: the same return
    values, error classes and texts, bit arrays, sums and majorities;
  * every error text of ``add_vote``, ``set_peer_maj23`` and
    ``make_extended_commit``;
  * extended vote sets: extensions verified, missing or unexpected
    extension data rejected with the same text, the same
    ``make_extended_commit`` bytes;
  * ``from_aggregate_commit`` and ``inject_aggregate_majority``;
  * ``HeightVoteSet`` round tracking, peer catch-up rounds and
    peer-maj23 claims;
  * a JAX vote set's votes carried across by ``convert.vote`` give the
    same extended commit bytes, and the port's ``verify_commit`` (B1's
    plain version) accepts the commit made from them.

Keys and times come from seeded numpy generators; equality is exact.
Votes are verified serially (the memo starts empty), so no kernel runs
but in the one ``verify_commit``.
"""
import numpy as np
import pytest

from cometbft_tpu.consensus import height_vote_set as r_hvs
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.libs.bits import BitArray as RBitArray
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types import validation as r_validation
from cometbft_tpu.types import vote as r_vote
from cometbft_tpu.types import vote_set as r_vs
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import AggregateCommit as RAggregateCommit
from cometbft_tpu.types.part_set import PartSetHeader as RPSH
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.validator import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu.wire import pb as rpb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.consensus import height_vote_set as p_hvs
from cometbft_tpu_torch.types import validation as p_validation
from cometbft_tpu_torch.types import vote as p_vote
from cometbft_tpu_torch.types import vote_set as p_vs
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.wire import encode, pb
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "test"
PREVOTE = r_canonical.PREVOTE_TYPE
PRECOMMIT = r_canonical.PRECOMMIT_TYPE
BID = RBlockID(hash=b"\xaa" * 32,
               part_set_header=RPSH(1, b"\xbb" * 32))
BID2 = RBlockID(hash=b"\xcc" * 32,
                part_set_header=RPSH(1, b"\xdd" * 32))


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (r_vote, p_vote):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()
    r_batch.set_backend("cpu")
    yield
    r_batch.set_backend("auto")
    for mod in (r_vote, p_vote):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()


def _plain(x):
    """Package-free form of a result: proto dicts for objects."""
    if isinstance(x, tuple):
        return tuple(_plain(y) for y in x)
    return x.to_proto() if hasattr(x, "to_proto") else x


def _outcome(fn, *args):
    try:
        return "ok", _plain(fn(*args))
    except Exception as e:  # noqa: BLE001 — the text is what is compared
        return type(e).__name__, str(e)


def _pbid(r_bid):
    return BlockID(r_bid.hash, PartSetHeader(r_bid.part_set_header.total,
                                             r_bid.part_set_header.hash))


class Fixture:
    """One validator set on both sides and its keys in index order."""

    def __init__(self, n=4, power=10, seed=0):
        rng = np.random.default_rng(seed)
        privs = [r_ed.Ed25519PrivKey(rng.bytes(32)) for _ in range(n)]
        self.rset = RValidatorSet([RValidator.new(p.pub_key(), power)
                                   for p in privs])
        by_addr = {p.pub_key().address(): p for p in privs}
        self.privs = [by_addr[v.address] for v in self.rset.validators]
        self.pset = convert.validator_set(self.rset.to_proto())
        self.rng = rng

    def vote(self, idx, height=1, round_=0, type_=PREVOTE, block_id=None,
             ext=None):
        addr, _ = self.rset.get_by_index(idx)
        v = r_vote.Vote(type=type_, height=height, round=round_,
                        block_id=block_id or RBlockID(),
                        timestamp=RTimestamp(1700000000 + idx, 0),
                        validator_address=addr, validator_index=idx)
        v.signature = self.privs[idx].sign(v.sign_bytes(CHAIN_ID))
        if ext is not None:
            v.extension, v.non_rp_extension = ext
            v.extension_signature = self.privs[idx].sign(
                v.extension_sign_bytes(CHAIN_ID))
            v.non_rp_extension_signature = self.privs[idx].sign(
                v.non_rp_extension)
        return v

    def sets(self, type_=PREVOTE, height=1, round_=0, extended=False):
        if extended:
            return (r_vs.VoteSet.extended(CHAIN_ID, height, round_, type_,
                                          self.rset),
                    p_vs.VoteSet.extended(CHAIN_ID, height, round_, type_,
                                          self.pset))
        return (r_vs.VoteSet(CHAIN_ID, height, round_, type_, self.rset),
                p_vs.VoteSet(CHAIN_ID, height, round_, type_, self.pset))


def _proto(v):
    return None if v is None else v.to_proto()


def _state(vs):
    """Everything a VoteSet holds, in plain data."""
    maj, ok = vs.two_thirds_majority()
    return (str(vs.bit_array()), vs.sum, ok, maj.to_proto(),
            [_proto(v) for v in vs.votes],
            {k.hex(): (bv.peer_maj23, str(bv.bit_array), bv.sum,
                       [_proto(v) for v in bv.votes])
             for k, bv in vs.votes_by_block.items()},
            {p: b.to_proto() for p, b in vs.peer_maj23s.items()},
            vs.has_two_thirds_majority(), vs.has_two_thirds_any(),
            vs.has_all(), vs.is_commit(), vs.has_two_thirds_votes_for_maj23(),
            vs.log_string(), str(vs))


def _add_both(rvs, pvs, v):
    """add_vote on both sides; returns the (equal) outcome."""
    want = _outcome(rvs.add_vote, v)
    got = _outcome(pvs.add_vote, convert.vote(v.to_proto()))
    assert got == want
    assert _state(pvs) == _state(rvs)
    return got


def _tally(rvs, pvs, votes):
    return [_add_both(rvs, pvs, v) for v in votes]


# -- tests/test_types_extra.py TestVoteSet, through both packages -------------

def test_add_votes_reach_maj23():
    fx = Fixture(4)
    rvs, pvs = fx.sets()
    outs = _tally(rvs, pvs, [fx.vote(i, block_id=BID) for i in range(3)])
    assert outs == [("ok", True)] * 3
    assert pvs.two_thirds_majority() == (_pbid(BID), True)


def test_duplicate_vote_not_added():
    fx = Fixture(4)
    rvs, pvs = fx.sets()
    v = fx.vote(0, block_id=BID)
    assert _tally(rvs, pvs, [v, v]) == [("ok", True), ("ok", False)]


def test_conflicting_vote_raises():
    fx = Fixture(4)
    rvs, pvs = fx.sets()
    outs = _tally(rvs, pvs, [fx.vote(0, block_id=BID),
                                 fx.vote(0, block_id=BID2)])
    assert outs[1][0] == "ConflictingVoteError"


def test_conflict_tracked_after_peer_maj23():
    fx = Fixture(4)
    rvs, pvs = fx.sets()
    _add_both(rvs, pvs, fx.vote(0, block_id=BID))
    rvs.set_peer_maj23("peer1", BID2)
    pvs.set_peer_maj23("peer1", _pbid(BID2))
    assert _state(pvs) == _state(rvs)
    out = _add_both(rvs, pvs, fx.vote(0, block_id=BID2))
    assert out[0] == "ConflictingVoteError"
    ba = pvs.bit_array_by_block_id(_pbid(BID2))
    assert ba is not None and ba.get_index(0)
    assert str(ba) == str(rvs.bit_array_by_block_id(BID2))
    assert pvs.bit_array_by_block_id(BlockID(b"\x01" * 32)) is None


def test_wrong_signature_rejected():
    fx = Fixture(4)
    rvs, pvs = fx.sets()
    v = fx.vote(0, block_id=BID)
    v.signature = bytes(64)
    assert _add_both(rvs, pvs, v) == (
        "VoteSetError", "failed to verify vote: invalid vote signature")


def test_wrong_step_rejected():
    fx = Fixture(4)
    rvs, pvs = fx.sets()
    out = _add_both(rvs, pvs, fx.vote(0, height=2, block_id=BID))
    assert out == ("VoteSetError", "expected 1/0/1, got 2/0/1")


def test_make_extended_commit_and_verify_commit():
    fx = Fixture(4)
    rvs, pvs = fx.sets(PRECOMMIT)
    _tally(rvs, pvs, [fx.vote(i, type_=PRECOMMIT, block_id=BID)
                          for i in range(3)])
    rec, pec = rvs.make_extended_commit(), pvs.make_extended_commit()
    assert encode(pb.EXTENDED_COMMIT, pec.to_proto()) == \
        r_encode(rpb.EXTENDED_COMMIT, rec.to_proto())
    flags = [s.block_id_flag for s in pec.extended_signatures]
    assert flags.count(p_vote.BLOCK_ID_FLAG_COMMIT) == 3
    r_validation.verify_commit(CHAIN_ID, fx.rset, BID, 1, rec.to_commit())
    p_validation.verify_commit(CHAIN_ID, fx.pset, _pbid(BID), 1,
                               pec.to_commit(), device="cpu")


def test_nil_votes_tally_separately():
    fx = Fixture(4)
    rvs, pvs = fx.sets(PRECOMMIT)
    _tally(rvs, pvs, [fx.vote(i, type_=PRECOMMIT) for i in range(3)])
    bid, ok = pvs.two_thirds_majority()
    assert ok and bid.is_nil()
    rec, pec = rvs.make_extended_commit(), pvs.make_extended_commit()
    assert encode(pb.EXTENDED_COMMIT, pec.to_proto()) == \
        r_encode(rpb.EXTENDED_COMMIT, rec.to_proto())


# -- error texts ----------------------------------------------------------------

def _mutated(fx, **kw):
    v = fx.vote(1, block_id=BID)
    for k, val in kw.items():
        setattr(v, k, val)
    return v


@pytest.mark.parametrize("case", [
    "negative_index", "empty_address", "wrong_round", "wrong_type",
    "unknown_index", "address_mismatch", "non_deterministic",
    "extension_on_plain_set", "nil_vote"])
def test_add_vote_error_texts(case):
    fx = Fixture(4, seed=3)
    rvs, pvs = fx.sets()
    other = fx.vote(2, block_id=BID).validator_address
    if case == "nil_vote":
        assert _outcome(pvs.add_vote, None) == _outcome(rvs.add_vote, None)
        return
    if case == "non_deterministic":
        _add_both(rvs, pvs, fx.vote(1, block_id=BID))
        v = fx.vote(1, block_id=BID)
        v.signature = bytes(64)
    else:
        v = {
            "negative_index": lambda: _mutated(fx, validator_index=-1),
            "empty_address": lambda: _mutated(fx, validator_address=b""),
            "wrong_round": lambda: _mutated(fx, round=2),
            "wrong_type": lambda: _mutated(fx, type=PRECOMMIT),
            "unknown_index": lambda: _mutated(fx, validator_index=9),
            "address_mismatch": lambda: _mutated(fx, validator_address=other),
            "extension_on_plain_set": lambda: _mutated(fx, extension=b"e"),
        }[case]()
    out = _add_both(rvs, pvs, v)
    assert out[0] == "VoteSetError"


def test_other_error_texts():
    fx = Fixture(4, seed=4)
    rvs, pvs = fx.sets()
    for fn in ("make_extended_commit",):
        assert _outcome(getattr(pvs, fn)) == _outcome(getattr(rvs, fn))
    rpc, ppc = fx.sets(PRECOMMIT)
    assert _outcome(ppc.make_extended_commit) == \
        _outcome(rpc.make_extended_commit)
    rvs.set_peer_maj23("p", BID)
    pvs.set_peer_maj23("p", _pbid(BID))
    rvs.set_peer_maj23("p", BID)            # the same claim twice is fine
    pvs.set_peer_maj23("p", _pbid(BID))
    assert _outcome(pvs.set_peer_maj23, "p", _pbid(BID2)) == \
        _outcome(rvs.set_peer_maj23, "p", BID2)
    assert _outcome(pvs.get_by_address, b"\x09" * 20) == \
        _outcome(rvs.get_by_address, b"\x09" * 20)
    assert _outcome(p_vs.VoteSet, CHAIN_ID, 0, 0, PREVOTE, fx.pset) == \
        _outcome(r_vs.VoteSet, CHAIN_ID, 0, 0, PREVOTE, fx.rset)
    _add_both(rvs, pvs, fx.vote(3, block_id=BID))
    addr = fx.rset.validators[3].address
    assert _proto(pvs.get_by_address(addr)) == \
        _proto(rvs.get_by_address(addr))
    assert [v.to_proto() for v in pvs.list()] == \
        [v.to_proto() for v in rvs.list()]
    assert (pvs.size(), pvs.get_height(), pvs.get_round(), pvs.type()) == \
        (rvs.size(), rvs.get_height(), rvs.get_round(), rvs.type())


# -- extended vote sets -----------------------------------------------------------

def test_extended_vote_set_and_its_commit():
    fx = Fixture(5, seed=5)
    rvs, pvs = fx.sets(PRECOMMIT, extended=True)
    votes = [fx.vote(i, type_=PRECOMMIT, block_id=BID,
                     ext=(fx.rng.bytes(40), fx.rng.bytes(24)))
             for i in range(4)]
    missing = fx.vote(4, type_=PRECOMMIT, block_id=BID)   # no extension
    bad = fx.vote(4, type_=PRECOMMIT, block_id=BID, ext=(b"x", b"y"))
    bad.non_rp_extension_signature = bytes(64)
    outs = _tally(rvs, pvs, votes + [missing, bad])
    assert outs[:4] == [("ok", True)] * 4
    assert outs[4] == ("VoteSetError",
                       "failed to verify vote: vote extension signature "
                       "missing")
    assert outs[5] == ("VoteSetError", "failed to verify vote: invalid "
                       "non-RP vote extension signature")
    # extensions enabled from height 0 (never), 1 and 2 (not yet): the
    # first and last refuse the extended votes with the same text
    outs = [(_outcome(lambda: encode(pb.EXTENDED_COMMIT, pvs.make_extended_commit(
        h).to_proto())), _outcome(lambda: r_encode(
            rpb.EXTENDED_COMMIT, rvs.make_extended_commit(h).to_proto())))
        for h in (0, 1, 2)]
    assert [got == want for got, want in outs] == [True] * 3
    assert [got[0] for got, _ in outs] == ["CommitError", "ok",
                                          "CommitError"]
    # a plain set refuses the extension data the extended set accepted
    rplain, pplain = fx.sets(PRECOMMIT)
    assert _add_both(rplain, pplain, votes[0]) == (
        "VoteSetError", "unexpected vote extension data present in vote")


def test_carried_votes_make_the_same_extended_commit():
    """A JAX vote set's votes, carried across as wire bytes, tally into a
    port vote set whose extended commit is byte for byte the JAX one."""
    fx = Fixture(7, seed=6)
    rvs = r_vs.VoteSet.extended(CHAIN_ID, 1, 0, PRECOMMIT, fx.rset)
    for i in range(7):
        rvs.add_vote(fx.vote(i, type_=PRECOMMIT,
                             block_id=BID2 if i == 6 else (
                                 RBlockID() if i == 5 else BID),
                             ext=None if i == 5 else (b"e%d" % i, b"n")))
    pvs = p_vs.VoteSet.extended(CHAIN_ID, 1, 0, PRECOMMIT, fx.pset)
    for v in rvs.list():
        assert pvs.add_vote(convert.vote(r_encode(rpb.VOTE, v.to_proto())))
    raw = r_encode(rpb.EXTENDED_COMMIT,
                   rvs.make_extended_commit(1).to_proto())
    assert encode(pb.EXTENDED_COMMIT,
                  pvs.make_extended_commit(1).to_proto()) == raw
    assert encode(pb.EXTENDED_COMMIT,
                  convert.extended_commit(raw).to_proto()) == raw


# -- aggregate commits ------------------------------------------------------------

def test_from_aggregate_commit_and_injected_majority():
    fx = Fixture(4, seed=7)
    signers = RBitArray.from_indices(4, [0, 1, 2])
    ragg = RAggregateCommit(height=1, round=0, block_id=BID,
                            signers=signers, signature=b"\x05" * 96)
    pagg = convert.aggregate_commit(ragg.to_proto())
    rvs = r_vs.VoteSet.from_aggregate_commit(CHAIN_ID, ragg, fx.rset)
    pvs = p_vs.VoteSet.from_aggregate_commit(CHAIN_ID, pagg, fx.pset)
    assert _state(pvs) == _state(rvs)
    assert pvs.stored_aggregate_commit is pagg
    _add_both(rvs, pvs, fx.vote(3, type_=PRECOMMIT, block_id=BID))
    assert encode(pb.EXTENDED_COMMIT,
                  pvs.make_extended_commit().to_proto()) == \
        r_encode(rpb.EXTENDED_COMMIT, rvs.make_extended_commit().to_proto())
    for type_, block_id, round_ in ((PRECOMMIT, BID, 0), (PREVOTE, BID, 0),
                                    (PRECOMMIT, BID2, 0),
                                    (PRECOMMIT, BID, 1)):
        ragg2 = RAggregateCommit(height=1, round=round_, block_id=block_id,
                                 signers=signers, signature=b"\x05" * 96)
        pagg2 = convert.aggregate_commit(ragg2.to_proto())
        for seed_votes in (False, True):
            r2, p2 = fx.sets(type_)
            if seed_votes:
                _tally(r2, p2, [fx.vote(i, type_=type_, block_id=BID)
                                    for i in range(3)])
            assert p2.inject_aggregate_majority(pagg2) == \
                r2.inject_aggregate_majority(ragg2)
            assert _state(p2) == _state(r2)


# -- HeightVoteSet ------------------------------------------------------------------

def _hvs_state(h):
    return (h.height, h.round, sorted(h._round_vote_sets),
            {p: list(r) for p, r in h._peer_catchup_rounds.items()},
            {r: (_state(pv), _state(pc))
             for r, (pv, pc) in h._round_vote_sets.items()})


def test_height_vote_set_rounds_and_peer_catchup():
    fx = Fixture(4, seed=8)
    rh = r_hvs.HeightVoteSet(CHAIN_ID, 1, fx.rset)
    ph = p_hvs.HeightVoteSet(CHAIN_ID, 1, fx.pset)
    assert _hvs_state(ph) == _hvs_state(rh)

    def both(method, *args, port_args=None):
        want = _outcome(getattr(rh, method), *args)
        got = _outcome(getattr(ph, method), *(port_args or args))
        assert got == want, method
        assert _hvs_state(ph) == _hvs_state(rh)
        return got

    def add(v, peer):
        return both("add_vote", v, peer,
                    port_args=(convert.vote(v.to_proto()), peer))

    assert add(fx.vote(0, type_=PRECOMMIT, block_id=BID), "a") == ("ok", True)
    # round 1 is tracked (round + 1); 5 and 7 only as peer catch-up, two
    # a peer, the third is refused
    assert add(fx.vote(1, round_=1, block_id=BID), "a") == ("ok", True)
    assert add(fx.vote(1, round_=5, block_id=BID), "a") == ("ok", True)
    assert add(fx.vote(2, round_=7, block_id=BID), "a") == ("ok", True)
    assert add(fx.vote(3, round_=9, block_id=BID), "a")[0] == \
        "HeightVoteSetError"
    assert add(fx.vote(3, round_=9, block_id=BID), "b") == ("ok", True)
    bad = fx.vote(0, block_id=BID)
    bad.type = 5
    add(bad, "a")
    both("set_round", 3)
    both("set_round", 1)
    both("ensure_round_tracked", 12)
    for i in range(3):
        add(fx.vote(i, round_=3, block_id=BID2), "c")
    assert both("pol_info")[1][0] == 3
    both("set_peer_maj23", 3, PRECOMMIT, "p", BID,
         port_args=(3, PRECOMMIT, "p", _pbid(BID)))
    both("set_peer_maj23", 40, PREVOTE, "p", BID,
         port_args=(40, PREVOTE, "p", _pbid(BID)))
    both("set_peer_maj23", 3, 9, "p", BID, port_args=(3, 9, "p", _pbid(BID)))
    assert _outcome(ph.prevotes, 3)[0] == "ok"
    assert ph.precommits(99) is None and rh.precommits(99) is None
    both("reset", 2, fx.rset, port_args=(2, fx.pset))


def test_height_vote_set_extended_precommits():
    fx = Fixture(4, seed=9)
    rh = r_hvs.HeightVoteSet(CHAIN_ID, 1, fx.rset, extensions_enabled=True)
    ph = p_hvs.HeightVoteSet(CHAIN_ID, 1, fx.pset, extensions_enabled=True)
    for i in range(4):
        v = fx.vote(i, type_=PRECOMMIT, block_id=BID,
                    ext=None if i == 3 else (b"x" * i, b"y"))
        assert _outcome(ph.add_vote, convert.vote(v.to_proto())) == \
            _outcome(rh.add_vote, v)
    assert _hvs_state(ph) == _hvs_state(rh)
    assert ph.precommits(0).two_thirds_majority() == (_pbid(BID), True)
