"""The port's vote intake (cometbft_tpu_torch/consensus/state.py) against
the JAX package's ``ConsensusState`` methods, driven on a stub ``self``
that holds ``rs``, ``sm_state``, ``logger`` and ``block_exec`` (the cases
of tests/test_consensus.py:188-260 and more):

  * ``preverify_burst`` fills the memo from real votes: the same key
    sets (B1's plain version on the port);
  * ``append_vote_entries``: three triples for a non-nil precommit with
    both extension signatures, one otherwise;
  * the burst filters: timeouts, other heights, a VoteBatchMessage, an
    index out of range, an address that does not match, a burst of one
    triple — the same entries reach the batch on both sides;
  * the port's departure: a kernel failure raises from
    ``preverify_burst``, where the JAX package logs it and goes on;
  * ``vote_set_from_commit`` and ``vote_set_from_extended_commit``: the
    same vote sets and memo key sets, and after a restore the serial
    tally verifies nothing itself; an AggregateCommit restores as an
    aggregate-backed set;
  * the LRU cascade of a commit larger than the memo, at a memo of 8 and
    a 12-signature commit: the same memo contents and the same count of
    serial verifications in both packages;
  * chip_smoke.py's phase 9a storm drain, at 48 validators on the CPU.

Inputs come from seeded numpy generators; equality is exact.  The port
runs ``device="cpu"``: B1's plain version where verdicts matter, the
stand-in kernel of tests/test_torch_pipeline.py where they do not.
"""
import asyncio
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.consensus import messages as r_msgs
from cometbft_tpu.consensus.state import ConsensusState
from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.crypto import pipeline as r_pipeline
from cometbft_tpu.libs.bits import BitArray as RBitArray
from cometbft_tpu.libs.log import new_logger
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types import vote as r_vote
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import AggregateCommit as RAggregateCommit
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.commit import ExtendedCommit as RExtendedCommit
from cometbft_tpu.types.commit import ExtendedCommitSig as RExtendedCommitSig
from cometbft_tpu.types.part_set import PartSetHeader as RPSH
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.validator import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.consensus import messages as p_msgs
from cometbft_tpu_torch.consensus import state as p_state
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types import vote as p_vote
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "intake-chain"
HEIGHT = 9
PRECOMMIT = r_canonical.PRECOMMIT_TYPE
PREVOTE = r_canonical.PREVOTE_TYPE
REPO = Path(__file__).resolve().parents[1]


def _clear_memos():
    for mod in (r_vote, p_vote):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The reference's CPU batch verifier checks signatures one by one
    unless its native module is built: build it, so that only the serial
    tally calls verify_signature on either side."""
    _native_loader.load()


@pytest.fixture(autouse=True)
def _fresh():
    _clear_memos()
    r_batch.set_backend("cpu")
    yield
    r_batch.set_backend("auto")
    _clear_memos()
    pipeline.reset_workers()
    r_pipeline.reset_workers()
    oe.reset_bucket_tuning()


def _fake_kernel(monkeypatch):
    """B1's wrapper replaced by a stand-in that accepts every lane
    (tests/test_torch_pipeline.py); returns the lane counts it saw."""
    calls = []

    def verify_cols(a, r, s, k):
        calls.append(a.shape[1])
        return torch.ones(a.shape[1], dtype=torch.bool)

    monkeypatch.setattr(ek, "verify_cols", verify_cols)
    return calls


def _count_serial(monkeypatch):
    """Count verify_signature calls of both packages' ed25519 keys."""
    counts = {"jax": 0, "port": 0}
    for side, cls in (("jax", r_ed.Ed25519PubKey),
                      ("port", p_ed.Ed25519PubKey)):
        real = cls.verify_signature

        def counting(self, msg, sig, real=real, side=side):
            counts[side] += 1
            return real(self, msg, sig)

        monkeypatch.setattr(cls, "verify_signature", counting)
    return counts


class Stub:
    """What the JAX methods read from a ConsensusState."""
    _preverify_burst = ConsensusState._preverify_burst
    _append_vote_entries = ConsensusState._append_vote_entries
    _preverify_votes = ConsensusState._preverify_votes
    _vote_set_from_commit = ConsensusState._vote_set_from_commit
    _vote_set_from_extended_commit = \
        ConsensusState._vote_set_from_extended_commit

    def __init__(self, vals, height=HEIGHT):
        self.rs = SimpleNamespace(height=height, validators=vals)
        self.sm_state = SimpleNamespace(chain_id=CHAIN_ID,
                                        last_validators=vals)
        self.logger = new_logger("test")
        self.block_exec = SimpleNamespace(store=SimpleNamespace(
            load_validators=lambda h: vals))


class Net:
    """A validator set on both sides and its keys in index order."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        privs = [r_ed.Ed25519PrivKey(rng.bytes(32)) for _ in range(n)]
        self.rset = RValidatorSet([RValidator.new(p.pub_key(), 10)
                                   for p in privs])
        by_addr = {p.pub_key().address(): p for p in privs}
        self.privs = [by_addr[v.address] for v in self.rset.validators]
        self.pset = convert.validator_set(self.rset.to_proto())
        self.bid = RBlockID(hash=rng.bytes(32),
                            part_set_header=RPSH(1, rng.bytes(32)))
        self.rng = rng
        self.stub = Stub(self.rset)

    def vote(self, idx, type_=PRECOMMIT, height=HEIGHT, nil=False,
             ext=None):
        addr, _ = self.rset.get_by_index(idx)
        v = r_vote.Vote(type=type_, height=height, round=0,
                        block_id=RBlockID() if nil else self.bid,
                        timestamp=RTimestamp(1_700_000_000 + idx,
                                             int(self.rng.integers(0, 10**9))),
                        validator_address=addr, validator_index=idx)
        v.signature = self.privs[idx].sign(v.sign_bytes(CHAIN_ID))
        if ext is not None:
            v.extension, v.non_rp_extension = ext
            v.extension_signature = self.privs[idx].sign(
                v.extension_sign_bytes(CHAIN_ID))
            v.non_rp_extension_signature = self.privs[idx].sign(
                v.non_rp_extension)
        return v

    def commit(self, n_signed=None, absent=()):
        sigs = []
        for i in range(self.rset.size()):
            if i in absent or (n_signed is not None and i >= n_signed):
                sigs.append(RCommitSig.absent())
                continue
            v = self.vote(i)
            sigs.append(RCommitSig(r_vote.BLOCK_ID_FLAG_COMMIT,
                                   v.validator_address, v.timestamp,
                                   v.signature))
        return RCommit(height=HEIGHT, round=0, block_id=self.bid,
                       signatures=sigs)

    def extended_commit(self):
        sigs = []
        for i in range(self.rset.size()):
            nil = i % 5 == 4
            v = self.vote(i, nil=nil, ext=None if nil else (
                self.rng.bytes(int(self.rng.integers(0, 90))),
                self.rng.bytes(int(self.rng.integers(1, 40)))))
            sigs.append(RExtendedCommitSig(
                block_id_flag=(r_vote.BLOCK_ID_FLAG_NIL if nil
                               else r_vote.BLOCK_ID_FLAG_COMMIT),
                validator_address=v.validator_address, timestamp=v.timestamp,
                signature=v.signature, extension=v.extension,
                extension_signature=v.extension_signature,
                non_rp_extension=v.non_rp_extension,
                non_rp_extension_signature=v.non_rp_extension_signature))
        return RExtendedCommit(height=HEIGHT, round=0, block_id=self.bid,
                               extended_signatures=sigs)


def _port_burst(burst):
    out = []
    for kind, msg, peer in burst:
        if isinstance(msg, r_msgs.VoteMessage):
            msg = p_msgs.VoteMessage(convert.vote(msg.vote.to_proto()))
        elif isinstance(msg, r_msgs.VoteBatchMessage):
            msg = p_msgs.VoteBatchMessage(
                [convert.vote(v.to_proto()) for v in msg.votes])
        out.append((kind, msg, peer))
    return out


def _vote_set_state(vs):
    maj, ok = vs.two_thirds_majority()
    return (str(vs.bit_array()), vs.sum, ok, maj.to_proto(),
            [None if v is None else v.to_proto() for v in vs.votes],
            vs.extensions_enabled)


def _same_memos():
    assert list(p_vote._VERIFIED) == list(r_vote._VERIFIED)
    assert list(p_vote._REJECTED) == list(r_vote._REJECTED)


# -- the burst ----------------------------------------------------------------

def test_preverify_burst_fills_memo_from_real_votes():
    """tests/test_consensus.py:188 on the port, B1's plain version: the
    memo holds every vote of the burst, the keys the JAX package's."""
    net = Net(4, 30)
    burst = [("peer", r_msgs.VoteMessage(net.vote(i, type_=PREVOTE,
                                                  nil=True)), f"n{i}")
             for i in range(4)]
    asyncio.run(net.stub._preverify_burst(burst))
    asyncio.run(p_state.preverify_burst(_port_burst(burst), HEIGHT,
                                        net.pset, CHAIN_ID, device="cpu"))
    assert len(p_vote._VERIFIED) == 4
    _same_memos()


def test_append_vote_entries_covers_extension_signatures():
    """tests/test_consensus.py:227 on the port."""
    net = Net(1, 31)
    pk = net.privs[0].pub_key()
    ppk = net.pset.validators[0].pub_key
    cases = [net.vote(0, ext=(b"ext", b"nrp")), net.vote(0, type_=PREVOTE),
             net.vote(0, nil=True)]
    half = net.vote(0, ext=(b"ext", b"nrp"))
    half.non_rp_extension_signature = b""
    cases.append(half)
    for v, n in zip(cases, (3, 1, 1, 1)):
        want, got = [], []
        ConsensusState._append_vote_entries(net.stub, want, v, pk, "x-chain")
        p_state.append_vote_entries(got, convert.vote(v.to_proto()), ppk,
                                    "x-chain")
        assert len(got) == n
        assert [(k.bytes(), m, s) for k, m, s in got] == \
            [(k.bytes(), m, s) for k, m, s in want]


def _capture(monkeypatch):
    """Replace both packages' async pre-verification by a recorder of
    the entries each was given; returns the two lists of calls."""
    seen = {"jax": [], "port": []}

    def recorder(side):
        def submit(entries, device=None):
            seen[side].append([(k.bytes(), m, s) for k, m, s in entries])
            return r_pipeline.submit(lambda: None)
        return submit

    monkeypatch.setattr(r_vote, "preverify_signatures_async",
                        recorder("jax"))
    monkeypatch.setattr(p_vote, "preverify_signatures_async",
                        recorder("port"))
    return seen


def test_burst_filters_match_the_reference(monkeypatch):
    net = Net(6, 32)
    seen = _capture(monkeypatch)
    stranger = r_ed.Ed25519PrivKey(net.rng.bytes(32))
    wrong_addr = net.vote(3)
    wrong_addr.validator_address = stranger.pub_key().address()
    out_of_range = net.vote(2)
    out_of_range.validator_index = 6
    burst = [
        ("timeout", SimpleNamespace(height=HEIGHT), ""),
        ("peer", r_msgs.VoteMessage(net.vote(0, ext=(b"e", b"n"))), "a"),
        ("peer", r_msgs.VoteMessage(net.vote(1, height=HEIGHT + 1)), "a"),
        ("peer", r_msgs.VoteBatchMessage([net.vote(4), net.vote(5)]), "b"),
        ("peer", r_msgs.VoteMessage(out_of_range), "b"),
        ("peer", r_msgs.VoteMessage(wrong_addr), "c"),
        ("internal", r_msgs.VoteMessage(net.vote(5, type_=PREVOTE)), ""),
        ("peer", r_msgs.VoteMessage(net.vote(2, nil=True)), "d"),
    ]
    asyncio.run(net.stub._preverify_burst(burst))
    asyncio.run(p_state.preverify_burst(_port_burst(burst), HEIGHT,
                                        net.pset, CHAIN_ID, device="cpu"))
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 1 and len(seen["port"][0]) == 5
    # one triple, or none at all: no batch on either side
    for small in ([burst[2]], [burst[6]], []):
        asyncio.run(net.stub._preverify_burst(small))
        asyncio.run(p_state.preverify_burst(_port_burst(small), HEIGHT,
                                            net.pset, CHAIN_ID,
                                            device="cpu"))
    assert len(seen["jax"]) == len(seen["port"]) == 1


def test_burst_kernel_failure_raises_where_the_reference_goes_on(
        monkeypatch):
    net = Net(3, 33)

    def broken(*_):
        raise RuntimeError("ed25519_verify launch failed: unspecified "
                           "launch failure")

    monkeypatch.setattr(ek, "verify_cols", broken)

    class Raising(r_ed.CpuBatchVerifier):
        def verify(self):
            raise RuntimeError("verifier error")

    monkeypatch.setattr(r_batch, "create_batch_verifier",
                        lambda pk: Raising())
    burst = [("peer", r_msgs.VoteMessage(net.vote(i)), "p")
             for i in range(3)]
    asyncio.run(net.stub._preverify_burst(burst))
    assert not r_vote._VERIFIED
    with pytest.raises(RuntimeError, match="launch failed"):
        asyncio.run(p_state.preverify_burst(_port_burst(burst), HEIGHT,
                                            net.pset, CHAIN_ID,
                                            device="cpu"))
    votes = [convert.vote(v.vote.to_proto()) for _, v, _ in burst]
    with pytest.raises(RuntimeError, match="launch failed"):
        p_state.preverify_votes(CHAIN_ID, net.pset, votes, device="cpu")


# -- restoring the last commit ---------------------------------------------------

def test_vote_set_from_commit_matches_and_tallies_from_the_memo(
        monkeypatch):
    calls = _fake_kernel(monkeypatch)
    net = Net(10, 34)
    rc = net.commit(absent=(3,))
    nil_vote = net.vote(7, nil=True)
    rc.signatures[7] = RCommitSig(r_vote.BLOCK_ID_FLAG_NIL,
                                  nil_vote.validator_address,
                                  nil_vote.timestamp, nil_vote.signature)
    counts = _count_serial(monkeypatch)
    state = SimpleNamespace(chain_id=CHAIN_ID, last_validators=net.rset)
    rvs = net.stub._vote_set_from_commit(state, rc)
    pvs = p_state.vote_set_from_commit(CHAIN_ID, convert.commit(
        rc.to_proto()), net.pset, device="cpu")
    assert _vote_set_state(pvs) == _vote_set_state(rvs)
    _same_memos()
    assert calls == [64]
    assert counts == {"jax": 0, "port": 0}


def test_vote_set_from_aggregate_commit():
    net = Net(4, 35)
    ragg = RAggregateCommit(height=HEIGHT, round=0, block_id=net.bid,
                            signers=RBitArray.from_indices(4, [0, 1, 2]),
                            signature=b"\x07" * 96)
    state = SimpleNamespace(chain_id=CHAIN_ID, last_validators=net.rset)
    rvs = net.stub._vote_set_from_commit(state, ragg)
    pvs = p_state.vote_set_from_commit(
        CHAIN_ID, convert.aggregate_commit(ragg.to_proto()), net.pset)
    assert _vote_set_state(pvs) == _vote_set_state(rvs)
    assert pvs.stored_aggregate_commit is not None
    assert not p_vote._VERIFIED


def test_restore_from_extended_commit_with_cleared_memos(monkeypatch):
    """A node that restarts has empty memos: the restore pre-verifies all
    three signatures of every extended vote in one batch, and the serial
    tally then verifies nothing itself."""
    calls = _fake_kernel(monkeypatch)
    net = Net(10, 36)
    rec = net.extended_commit()
    counts = _count_serial(monkeypatch)
    state = SimpleNamespace(chain_id=CHAIN_ID, last_validators=net.rset)
    rvs = net.stub._vote_set_from_extended_commit(state, rec)
    pvs = p_state.vote_set_from_extended_commit(
        CHAIN_ID, convert.extended_commit(rec.to_proto()), net.pset,
        device="cpu")
    assert _vote_set_state(pvs) == _vote_set_state(rvs)
    _same_memos()
    assert len(p_vote._VERIFIED) == 8 * 3 + 2      # 2 nil precommits
    assert calls == [64]
    assert counts == {"jax": 0, "port": 0}
    assert pvs.make_extended_commit(1).to_proto() == \
        rvs.make_extended_commit(1).to_proto()


def test_lru_cascade_of_a_commit_larger_than_the_memo(monkeypatch):
    """Pins, in both packages, what a commit larger than the memo does:
    the pre-verification leaves only the newest 8 of 12 triples, and
    each serial miss then evicts the triple the tally asks for next, so
    every one of the 12 add_vote calls verifies serially."""
    for mod in (r_vote, p_vote):
        monkeypatch.setattr(mod, "_VERIFIED_MAX", 8)
    net = Net(12, 37)
    rc = net.commit()
    counts = _count_serial(monkeypatch)
    state = SimpleNamespace(chain_id=CHAIN_ID, last_validators=net.rset)
    rvs = net.stub._vote_set_from_commit(state, rc)
    pvs = p_state.vote_set_from_commit(
        CHAIN_ID, convert.commit(rc.to_proto()), net.pset, device="cpu")
    assert _vote_set_state(pvs) == _vote_set_state(rvs)
    _same_memos()
    assert len(p_vote._VERIFIED) == 8
    assert counts == {"jax": 12, "port": 12}


# -- chip_smoke.py phase 9a at a small size --------------------------------------

def test_storm_drain_of_the_chip_smoke_at_48_validators(monkeypatch):
    """chip_smoke.py's phase 9a drain on the CPU: precommits of a signed
    commit go out as VoteMessage wire bytes in a shuffled order, come
    back through decode_p2p into an asyncio.Queue and are drained in
    bursts of at most 16 (256 on the card): each burst pre-verified,
    then tallied serially into a HeightVoteSet.  The made commit equals
    the source and the tally verifies nothing itself."""
    calls = _fake_kernel(monkeypatch)
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    net = Net(48, 38)
    commit = convert.commit(net.commit().to_proto())
    counts = _count_serial(monkeypatch)
    votes = [commit.get_vote(i) for i in range(commit.size())]
    out = chip_smoke._vote_storm(CHAIN_ID, HEIGHT, votes, net.pset, seed=5,
                                 burst_max=16, device="cpu")
    assert out["bursts"] == 3 and calls == [64] * 3
    assert out["commit"].to_proto() == commit.to_proto()
    assert counts == {"jax": 0, "port": 0} and out["misses"] == 0
    assert out["maj23"] == commit.block_id
