"""The port's Vote, its wire forms and the verified-triple memo, against
the JAX package's (cometbft_tpu/types/vote.py, commit.py,
consensus/messages.py, crypto/batch.py):

  * sign bytes of votes and of their extensions, the sign-bytes memo
    across a timestamp rewrite and ``copy``, ``Commit.get_vote`` and the
    commit's sign-bytes template (tests/test_types.py:184,303);
  * ``validate_basic`` and the verify methods: the same error texts;
  * the Vote, ExtendedCommit and p2p message wire bytes, each side
    decoding the other's; ``convert.vote`` / ``convert.extended_commit``;
  * the memo: ``checked_verify`` keeps both verdicts, both memos are
    bounded (tests/test_batch_grouped.py:255-324);
  * ``batch_verify_by_type`` and ``preverify_signatures`` on a grouped
    burst with a corrupted ed25519 signature, BLS and secp256k1 entries,
    a wrong-length signature and a group of one: the same masks and the
    same memo key sets;
  * the port's one departure: a kernel or BLS library failure raises
    through ``batch_verify_by_type`` and ``preverify_signatures``, where
    the JAX package answers None;
  * ``preverify_signatures_async`` fills the memo
    (tests/test_verify_pipeline.py:417).

Inputs are made from seeded numpy generators; equality is exact.  The
port runs ``device="cpu"``: B1's plain version where verdicts matter,
the stand-in kernel of tests/test_torch_pipeline.py (accepts every lane)
where only bookkeeping does.
"""
import asyncio

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import bls12381 as r_bls
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.crypto import pipeline as r_pipeline
from cometbft_tpu.crypto import secp256k1 as r_secp
from cometbft_tpu.consensus import messages as r_msgs
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types import vote as r_vote
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.commit import ExtendedCommit as RExtendedCommit
from cometbft_tpu.types.commit import ExtendedCommitSig as RExtendedCommitSig
from cometbft_tpu.types.part_set import PartSetHeader as RPSH
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu.wire import pb as rpb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.consensus import messages as p_msgs
from cometbft_tpu_torch.crypto import batch as p_batch
from cometbft_tpu_torch.crypto import bls12381 as p_bls
from cometbft_tpu_torch.crypto import encoding as p_enc
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types import canonical as p_canonical
from cometbft_tpu_torch.types import vote as p_vote
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.wire import encode, pb
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "votes-chain"


def _clear_memos():
    for mod in (r_vote, p_vote):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The reference runs its BLS in pure Python unless its native
    module is built: build it."""
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


def _outcome(fn, *args):
    """('ok', result) or (exception class name, text)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the text is what is compared
        return type(e).__name__, str(e)


def _bid(rng):
    return RBlockID(hash=rng.bytes(32),
                    part_set_header=RPSH(int(rng.integers(1, 5)),
                                         rng.bytes(32)))


def _ed_privs(rng, n):
    return [r_ed.Ed25519PrivKey(rng.bytes(32)) for _ in range(n)]


def _port_pub(pk):
    return p_enc.pub_key_from_type_and_bytes(pk.type(), pk.bytes())


def _signed_vote(priv, rng, type_=r_canonical.PRECOMMIT_TYPE, height=5,
                 round_=0, bid=None, index=0, ext=None):
    """A reference vote signed by ``priv``; ``ext`` = (extension,
    non-RP extension) signs both extensions too."""
    v = r_vote.Vote(type=type_, height=height, round=round_,
                    block_id=bid if bid is not None else RBlockID(),
                    timestamp=RTimestamp(1_700_000_000 +
                                         int(rng.integers(0, 1 << 20)),
                                         int(rng.integers(0, 10**9))),
                    validator_address=priv.pub_key().address(),
                    validator_index=index)
    v.signature = priv.sign(v.sign_bytes(CHAIN_ID))
    if ext is not None:
        v.extension, v.non_rp_extension = ext
        v.extension_signature = priv.sign(v.extension_sign_bytes(CHAIN_ID))
        v.non_rp_extension_signature = priv.sign(v.non_rp_extension)
    return v


# -- sign bytes ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_sign_bytes_and_extension_sign_bytes_equal(seed):
    rng = np.random.default_rng(seed)
    priv = _ed_privs(rng, 1)[0]
    for type_ in (r_canonical.PREVOTE_TYPE, r_canonical.PRECOMMIT_TYPE):
        for bid in (RBlockID(), _bid(rng)):
            for chain in (CHAIN_ID, ""):
                v = _signed_vote(priv, rng, type_=type_, bid=bid,
                                 height=int(rng.integers(1, 1 << 40)),
                                 round_=int(rng.integers(0, 3)))
                v.extension = rng.bytes(int(rng.integers(0, 300)))
                pv = convert.vote(v.to_proto())
                assert pv.sign_bytes(chain) == v.sign_bytes(chain)
                assert pv.extension_sign_bytes(chain) == \
                    v.extension_sign_bytes(chain)
                assert pv.non_rp_extension_sign_bytes() == \
                    v.non_rp_extension_sign_bytes()
                assert p_canonical.vote_extension_sign_bytes(
                    chain, v.height, v.round, v.extension) == \
                    r_canonical.vote_extension_sign_bytes(
                        chain, v.height, v.round, v.extension)


def test_sign_bytes_memo_tracks_rewrites_and_copy():
    """The memo is keyed on every signed field: a timestamp rewritten
    after the first marshal (privval's same-HRS re-sign) misses it, and a
    copy changed afterwards does not carry stale bytes."""
    rng = np.random.default_rng(10)
    v = convert.vote(_signed_vote(_ed_privs(rng, 1)[0], rng).to_proto())
    first = v.sign_bytes(CHAIN_ID)
    v.timestamp = Timestamp(v.timestamp.seconds + 1, 0)
    second = v.sign_bytes(CHAIN_ID)
    assert second != first
    assert second == p_canonical.vote_sign_bytes(
        CHAIN_ID, v.type, v.height, v.round, v.block_id, v.timestamp)
    c = v.copy()
    assert "_sb_memo" not in c.__dict__
    c.round = 3
    assert c.sign_bytes(CHAIN_ID) == p_canonical.vote_sign_bytes(
        CHAIN_ID, c.type, c.height, 3, c.block_id, c.timestamp)
    assert v.sign_bytes(CHAIN_ID) == second


def test_commit_get_vote_and_template_match_the_reference():
    """tests/test_types.py:184,303: Commit.get_vote's sign bytes equal the
    commit's template splice, for every flag and timestamp shape, and
    equal the reference's."""
    rng = np.random.default_rng(11)
    bid = _bid(rng)
    times = [RTimestamp(1700000000, 0), RTimestamp(1700000000, 1),
             RTimestamp(0, 0), RTimestamp(1, 999_999_999),
             RTimestamp(2**31, 5)]
    sigs = []
    for i, ts in enumerate(times):
        flag = (r_vote.BLOCK_ID_FLAG_COMMIT if i % 3 != 1
                else r_vote.BLOCK_ID_FLAG_NIL)
        sigs.append(RCommitSig(block_id_flag=flag,
                               validator_address=bytes([i]) * 20,
                               timestamp=ts, signature=rng.bytes(64)))
    sigs.append(RCommitSig.absent())
    rc = RCommit(height=42, round=3, block_id=bid, signatures=sigs)
    c = convert.commit(rc.to_proto())
    for chain in ("tmpl-chain", ""):
        for i in range(len(sigs)):
            pv, rv = c.get_vote(i), rc.get_vote(i)
            assert pv.to_proto() == rv.to_proto()
            assert pv.sign_bytes(chain) == rv.sign_bytes(chain) == \
                c.vote_sign_bytes(chain, i)
    assert [cs.for_block() for cs in c.signatures] == \
        [cs.for_block() for cs in rc.signatures]
    assert [cs.absent_flag() for cs in c.signatures] == \
        [cs.absent_flag() for cs in rc.signatures]


# -- validate_basic and verify: error texts -------------------------------------

def _broken_votes():
    """(name, mutate) pairs; each breaks one rule of validate_basic."""
    def setter(**kw):
        def mutate(v):
            for k, val in kw.items():
                setattr(v, k, val)
        return mutate
    short_psh = RBlockID(hash=b"\x01" * 32, part_set_header=RPSH(1, b"\x02"))
    incomplete = RBlockID(hash=b"\x01" * 32, part_set_header=RPSH(0, b""))
    return [
        ("ok", setter()),
        ("type", setter(type=7)),
        ("height", setter(height=0)),
        ("round", setter(round=-1)),
        ("hash_size", setter(block_id=RBlockID(hash=b"\x01" * 5))),
        ("psh_hash_size", setter(block_id=short_psh)),
        ("incomplete", setter(block_id=incomplete)),
        ("address", setter(validator_address=b"\x01" * 19)),
        ("index", setter(validator_index=-1)),
        ("no_sig", setter(signature=b"")),
        ("big_sig", setter(signature=b"\x01" * 97)),
        ("big_ext", setter(extension=b"\x00" * (p_vote.MAX_VOTE_EXTENSION_SIZE
                                                + 1))),
        ("ext_no_sig", setter(extension=b"e", extension_signature=b"")),
        ("big_nrp", setter(non_rp_extension=b"\x00" * (
            p_vote.MAX_VOTE_EXTENSION_SIZE + 1))),
        ("big_nrp_sig", setter(non_rp_extension_signature=b"\x01" * 97)),
        ("nrp_no_sig", setter(non_rp_extension=b"n",
                              non_rp_extension_signature=b"")),
        ("unpaired", setter(non_rp_extension_signature=b"")),
        ("prevote_ext", setter(type=r_canonical.PREVOTE_TYPE)),
        ("nil_ext", setter(block_id=RBlockID())),
    ]


_EXTENDED_CASES = ("big_ext", "ext_no_sig", "big_nrp", "big_nrp_sig",
                   "nrp_no_sig", "unpaired", "prevote_ext", "nil_ext")


@pytest.mark.parametrize("name,mutate", _broken_votes(),
                         ids=[n for n, _ in _broken_votes()])
def test_validate_basic_same_error_texts(name, mutate):
    rng = np.random.default_rng(12)
    v = _signed_vote(_ed_privs(rng, 1)[0], rng, bid=_bid(rng),
                     ext=(b"ext", b"nrp"))
    if name not in _EXTENDED_CASES:
        v.extension = v.non_rp_extension = b""
        v.extension_signature = v.non_rp_extension_signature = b""
    mutate(v)
    pv = convert.vote(v.to_proto())
    got, want = _outcome(pv.validate_basic), _outcome(v.validate_basic)
    assert got == want
    assert (got[0] == "ok") == (name == "ok")


def test_verify_methods_same_error_texts():
    rng = np.random.default_rng(13)
    priv, other = _ed_privs(rng, 2)
    bid = _bid(rng)
    good = _signed_vote(priv, rng, bid=bid, ext=(b"ext", b"nrp"))
    cases = []
    for name, change in (
            ("good", {}),
            ("bad_sig", {"signature": bytes(64)}),
            ("bad_ext_sig", {"extension_signature": bytes(64)}),
            ("bad_nrp_sig", {"non_rp_extension_signature": bytes(64)}),
            ("no_ext_sig", {"extension_signature": b""}),
            ("other_ext", {"extension": b"changed"})):
        v = r_vote.Vote.from_proto(good.to_proto())
        for k, val in change.items():
            setattr(v, k, val)
        cases.append((name, v))
    for name, v in cases:
        pv = convert.vote(v.to_proto())
        for pk_r in (priv.pub_key(), other.pub_key()):
            pk_p = _port_pub(pk_r)
            for meth in ("verify", "verify_vote_and_extension",
                         "verify_extension"):
                _clear_memos()
                got = _outcome(getattr(pv, meth), CHAIN_ID, pk_p)
                want = _outcome(getattr(v, meth), CHAIN_ID, pk_r)
                assert got == want, (name, meth)


# -- wire forms ----------------------------------------------------------------

def _extended_commit(rng, n=5):
    privs = _ed_privs(rng, n)
    bid = _bid(rng)
    sigs = []
    for i, p in enumerate(privs):
        if i == 1:
            sigs.append(RExtendedCommitSig(
                block_id_flag=r_vote.BLOCK_ID_FLAG_ABSENT,
                timestamp=RTimestamp.zero()))
            continue
        nil = i == 2
        v = _signed_vote(p, rng, bid=RBlockID() if nil else bid, index=i,
                         ext=None if nil else (rng.bytes(40), rng.bytes(24)))
        sigs.append(RExtendedCommitSig(
            block_id_flag=(r_vote.BLOCK_ID_FLAG_NIL if nil
                           else r_vote.BLOCK_ID_FLAG_COMMIT),
            validator_address=v.validator_address, timestamp=v.timestamp,
            signature=v.signature, extension=v.extension,
            extension_signature=v.extension_signature,
            non_rp_extension=v.non_rp_extension,
            non_rp_extension_signature=v.non_rp_extension_signature))
    return RExtendedCommit(height=5, round=0, block_id=bid,
                           extended_signatures=sigs)


def test_vote_and_extended_commit_wire_round_trip():
    rng = np.random.default_rng(14)
    v = _signed_vote(_ed_privs(rng, 1)[0], rng, bid=_bid(rng), index=3,
                     ext=(rng.bytes(33), rng.bytes(17)))
    raw = r_encode(rpb.VOTE, v.to_proto())
    for obj in (v.to_proto(), raw):
        pv = convert.vote(obj)
        assert encode(pb.VOTE, pv.to_proto()) == raw
        assert pv.to_proto() == v.to_proto()
    rec = _extended_commit(rng)
    raw = r_encode(rpb.EXTENDED_COMMIT, rec.to_proto())
    for obj in (rec.to_proto(), raw):
        ec = convert.extended_commit(obj)
        assert encode(pb.EXTENDED_COMMIT, ec.to_proto()) == raw
        assert encode(pb.COMMIT, ec.to_commit().to_proto()) == \
            r_encode(rpb.COMMIT, rec.to_commit().to_proto())
        for i in range(ec.size()):
            assert ec.get_extended_vote(i).to_proto() == \
                rec.get_extended_vote(i).to_proto()
    wrapped = ec.to_commit().wrapped_extended_commit()
    assert encode(pb.EXTENDED_COMMIT, wrapped.to_proto()) == r_encode(
        rpb.EXTENDED_COMMIT,
        rec.to_commit().wrapped_extended_commit().to_proto())
    assert ec.is_commit() == rec.is_commit()


def test_extended_commit_checks_same_error_texts():
    rng = np.random.default_rng(15)
    rec = _extended_commit(rng)
    ec = convert.extended_commit(rec.to_proto())
    for enabled in (True, False):
        assert _outcome(ec.ensure_extensions, enabled) == \
            _outcome(rec.ensure_extensions, enabled)
    assert _outcome(ec.validate_basic) == _outcome(rec.validate_basic) == \
        ("ok", None)
    mutations = [
        lambda c: setattr(c, "height", -1),
        lambda c: setattr(c, "round", -1),
        lambda c: setattr(c, "block_id", type(c.block_id)()),
        lambda c: setattr(c, "extended_signatures", []),
        lambda c: setattr(c.extended_signatures[0], "signature", b""),
        lambda c: setattr(c.extended_signatures[1], "validator_address",
                          b"\x01" * 20),
        lambda c: setattr(c.extended_signatures[3], "block_id_flag", 9),
        lambda c: setattr(c.extended_signatures[2], "extension", b"x"),
        lambda c: setattr(c.extended_signatures[0], "extension_signature",
                          b""),
    ]
    for mutate in mutations:
        r2 = RExtendedCommit.from_proto(rec.to_proto())
        p2 = convert.extended_commit(rec.to_proto())
        mutate(r2)
        mutate(p2)
        for check in ("validate_basic",):
            assert _outcome(getattr(p2, check)) == \
                _outcome(getattr(r2, check))
        for enabled in (True, False):
            assert _outcome(p2.ensure_extensions, enabled) == \
                _outcome(r2.ensure_extensions, enabled)


def test_p2p_messages_same_bytes_and_cross_decode():
    rng = np.random.default_rng(16)
    privs = _ed_privs(rng, 3)
    bid = _bid(rng)
    votes = [_signed_vote(p, rng, bid=bid, index=i,
                          ext=(rng.bytes(9), rng.bytes(5)) if i else None)
             for i, p in enumerate(privs)]
    pvotes = [convert.vote(v.to_proto()) for v in votes]
    pairs = [(r_msgs.VoteMessage(votes[0]), p_msgs.VoteMessage(pvotes[0])),
             (r_msgs.VoteMessage(votes[2]), p_msgs.VoteMessage(pvotes[2])),
             (r_msgs.VoteBatchMessage(votes), p_msgs.VoteBatchMessage(pvotes)),
             (r_msgs.VoteBatchMessage([]), p_msgs.VoteBatchMessage([]))]
    for rmsg, pmsg in pairs:
        raw = r_msgs.encode_p2p(rmsg)
        assert p_msgs.encode_p2p(pmsg) == raw
        back = p_msgs.decode_p2p(raw)
        assert type(back).__name__ == type(rmsg).__name__
        assert p_msgs.encode_p2p(back) == raw
        assert r_msgs.encode_p2p(r_msgs.decode_p2p(
            p_msgs.encode_p2p(pmsg))) == raw
    assert p_msgs.decode_p2p(raw).votes == []


def test_other_message_kinds_raise_naming_the_queue_item():
    """Since the consensus slice (ROADMAP.md A.7d-2) every kind decodes
    as the JAX package's does; only what neither package encodes still
    raises, with the JAX package's text."""
    raw = r_msgs.encode_p2p(r_msgs.HasVoteMessage(height=3, round=1,
                                                  type=1, index=2))
    back = p_msgs.decode_p2p(raw)
    assert type(back).__name__ == "HasVoteMessage"
    assert p_msgs.encode_p2p(back) == raw
    with pytest.raises(ValueError, match="cannot encode message"):
        p_msgs.encode_p2p(object())
    with pytest.raises(ValueError, match="unknown consensus message"):
        p_msgs.decode_p2p(b"")


# -- the memo -------------------------------------------------------------------

def test_checked_verify_memoizes_both_verdicts(monkeypatch):
    rng = np.random.default_rng(17)
    priv = _ed_privs(rng, 1)[0]
    sig = priv.sign(b"memo-me")
    for mod, pub in ((r_vote, priv.pub_key()), (p_vote,
                                                 _port_pub(priv.pub_key()))):
        calls = {"n": 0}
        real = type(pub).verify_signature

        def counting(self, msg, s, real=real, calls=calls):
            calls["n"] += 1
            return real(self, msg, s)

        monkeypatch.setattr(type(pub), "verify_signature", counting)
        assert mod.checked_verify(pub, b"memo-me", sig)
        assert mod.checked_verify(pub, b"memo-me", sig)
        assert calls["n"] == 1
        assert not mod.checked_verify(pub, b"other", sig)
        assert not mod.checked_verify(pub, b"other", sig)
        assert calls["n"] == 2
    assert list(p_vote._VERIFIED) == list(r_vote._VERIFIED)
    assert list(p_vote._REJECTED) == list(r_vote._REJECTED)


def test_memo_is_bounded_as_the_reference():
    assert (p_vote._VERIFIED_MAX, p_vote._REJECTED_MAX) == \
        (r_vote._VERIFIED_MAX, r_vote._REJECTED_MAX) == (8192, 4096)
    for mod in (r_vote, p_vote):
        for i in range(mod._VERIFIED_MAX + 50):
            mod._memo_add((b"p%d" % i, b"m", b"s"))
        assert len(mod._VERIFIED) == mod._VERIFIED_MAX
        for i in range(mod._REJECTED_MAX + 50):
            mod._memo_reject((b"p%d" % i, b"m", b"s"))
        assert len(mod._REJECTED) == mod._REJECTED_MAX
    assert list(p_vote._VERIFIED) == list(r_vote._VERIFIED)
    assert list(p_vote._REJECTED) == list(r_vote._REJECTED)


# -- grouped batches ------------------------------------------------------------

def _grouped_entries(seed):
    """A burst of reference triples: five ed25519 (one corrupted, one
    63-byte signature), three BLS (one corrupted) and two secp256k1,
    which have no batch verifier."""
    rng = np.random.default_rng(seed)
    privs = (_ed_privs(rng, 5) +
             [r_bls.gen_priv_key_from_secret(rng.bytes(32))
              for _ in range(3)] +
             [r_secp.gen_priv_key_from_secret(rng.bytes(32))
              for _ in range(2)])
    entries = []
    for i, p in enumerate(privs):
        msg = rng.bytes(int(rng.integers(0, 150)))
        sig = p.sign(msg)
        if i in (1, 6):
            sig = bytes([sig[0] ^ 2]) + sig[1:]
        if i == 3:
            sig = sig[:63]
        entries.append((p.pub_key(), msg, sig))
    return entries


def _port_entries(entries):
    return [(_port_pub(pk), msg, sig) for pk, msg, sig in entries]


def test_batch_verify_by_type_and_preverify_match_the_reference():
    """tests/test_batch_grouped.py:281-313 on the port: the ed25519 group
    on B1's plain version, the BLS group on the host library, secp256k1
    and the 63-byte signature left None; the memo then holds the same
    keys, the corrupted entries confirmed serially into the negative
    memo."""
    entries = _grouped_entries(18)
    pent = _port_entries(entries)
    want = r_batch.batch_verify_by_type(entries)
    got = p_batch.batch_verify_by_type(pent, device="cpu")
    assert got == want
    assert got == [True, False, True, None, True, True, False, True,
                   None, None]
    r_vote.preverify_signatures(entries)
    p_vote.preverify_signatures(pent, device="cpu")
    assert list(p_vote._VERIFIED) == list(r_vote._VERIFIED)
    assert list(p_vote._REJECTED) == list(r_vote._REJECTED)
    assert len(p_vote._VERIFIED) == 5 and len(p_vote._REJECTED) == 2
    # every judged triple is now served by the memo, the bad ones too
    for i, (pk, msg, sig) in enumerate(pent):
        if got[i] is not None:
            assert p_vote.checked_verify(pk, msg, sig) == got[i]


def test_singleton_group_and_already_memoised_entries(monkeypatch):
    calls = _fake_kernel(monkeypatch)
    rng = np.random.default_rng(19)
    privs = _ed_privs(rng, 3)
    entries = [(p.pub_key(), b"m%d" % i, p.sign(b"m%d" % i))
               for i, p in enumerate(privs)]
    bls = r_bls.gen_priv_key_from_secret(rng.bytes(32))
    single = entries[:1] + [(bls.pub_key(), b"b", bls.sign(b"b"))]
    pent = _port_entries(single)
    assert p_batch.batch_verify_by_type(pent, device="cpu") == \
        r_batch.batch_verify_by_type(single) == [None, None]
    assert calls == []
    # two fresh triples of three: one batch of two; then nothing fresh
    r_vote.checked_verify(*entries[0])
    p_vote.checked_verify(*_port_entries(entries)[0])
    for _ in range(2):
        r_vote.preverify_signatures(entries)
        p_vote.preverify_signatures(_port_entries(entries), device="cpu")
    assert calls == [64]
    assert list(p_vote._VERIFIED) == list(r_vote._VERIFIED)


def test_kernel_failure_raises_where_the_reference_answers_none(
        monkeypatch):
    """The port's one departure: a launch that fails raises through
    batch_verify_by_type and preverify_signatures (and the async
    future); the JAX package answers None and leaves the memo empty."""
    entries = _grouped_entries(20)[:3]

    def broken(*_):
        raise RuntimeError("ed25519_verify launch failed: too many "
                           "resources requested for launch (7)")

    monkeypatch.setattr(ek, "verify_cols", broken)

    class Raising(r_ed.CpuBatchVerifier):
        def verify(self):
            raise RuntimeError("verifier error")

    monkeypatch.setattr(r_batch, "create_batch_verifier",
                        lambda pk: Raising())
    assert r_batch.batch_verify_by_type(entries) == [None] * 3
    r_vote.preverify_signatures(entries)
    assert not r_vote._VERIFIED and not r_vote._REJECTED
    pent = _port_entries(entries)
    with pytest.raises(RuntimeError, match="launch failed"):
        p_batch.batch_verify_by_type(pent, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        p_vote.preverify_signatures(pent, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        p_vote.preverify_signatures_async(pent, device="cpu").result(30)
    assert not p_vote._VERIFIED and not p_vote._REJECTED


def test_bls_library_failure_raises(monkeypatch):
    rng = np.random.default_rng(21)
    privs = [r_bls.gen_priv_key_from_secret(rng.bytes(32)) for _ in range(2)]
    pent = _port_entries([(p.pub_key(), b"x", p.sign(b"x")) for p in privs])

    def broken(*_):
        raise OSError("cometbft_bls: pairing failed")

    monkeypatch.setattr(p_bls.Bls12381BatchVerifier, "_rlc_holds", broken)
    with pytest.raises(OSError, match="pairing failed"):
        p_batch.batch_verify_by_type(pent, device="cpu")


def test_preverify_signatures_async_fills_memo(monkeypatch):
    """tests/test_verify_pipeline.py:417 on the port: the future runs on
    the staging worker and resolves once the memo holds the burst."""
    calls = _fake_kernel(monkeypatch)
    rng = np.random.default_rng(22)
    privs = _ed_privs(rng, 4)
    entries = [(p.pub_key(), b"pv%d" % i, p.sign(b"pv%d" % i))
               for i, p in enumerate(privs)]
    pent = _port_entries(entries)

    async def go():
        await asyncio.wrap_future(r_vote.preverify_signatures_async(entries))
        await asyncio.wrap_future(
            p_vote.preverify_signatures_async(pent, "cpu"))

    asyncio.run(go())
    assert calls == [64]
    assert list(p_vote._VERIFIED) == list(r_vote._VERIFIED)
    assert len(p_vote._VERIFIED) == 4


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(23)
    pent = _port_entries([(p.pub_key(), b"m", p.sign(b"m"))
                          for p in _ed_privs(rng, 2)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_batch.batch_verify_by_type(pent)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_vote.preverify_signatures(pent)
