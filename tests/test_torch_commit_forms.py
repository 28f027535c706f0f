"""Every commit form the reference verifies, through the port's three
entry points against the JAX package's.

Each scenario of SCENARIOS is built once with the reference's own types
and keys, carried across by cometbft_tpu_torch/convert.py (as dicts and
as wire bytes) and run through verify_commit, verify_commit_light and
verify_commit_light_trusting of both packages: the reference on its
``cpu`` backend, the port with ``device="cpu"`` (B1's plain version for
the ed25519 group, the host BLS library for BLS, the pure-Python curve
for secp256k1 and secp256k1eth).  Verdicts and error texts must be
equal.

  * grouped (mixed-key) commits, the cases of
    tests/test_batch_grouped.py:121-255: the gate, honest commits, a
    corrupt signature of each key type, the lowest
    failing index across inline and deferred signatures in both orders,
    the cache populated and reused, the cache keyed on the verified
    key's address, a forged signature without quorum, a wrong-length
    signature, a nil key; and all-secp256k1 (single path) and all-BLS
    (batch path) sets;
  * aggregate commits, the forgery matrix of
    tests/test_aggregate_commit.py:126-440: honest, one absent,
    sub-quorum, a non-signer bit, an out-of-range bit, a wrong-key
    aggregate, a wrong block ID, nil exclusion, rogue keys caught by the
    set hash, trusting rogue cancellation, trusting substituted keys, an
    unknown signer, the light and trusting variants, the verdict memo
    and the aggregate-pubkey cache.

Besides, a mixed commit runs under both kernels' plain versions, and the
ed25519 group, only it, reaches ops/ed25519.verify_batch.  A
``cuda``-marked test runs a small mixed commit on the card.
"""
import copy
import hashlib
from typing import NamedTuple, Optional

import pytest
import torch

from cometbft_tpu.crypto import _bls12381_math as r_m
from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import bls12381 as r_bls
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.crypto import secp256k1 as r_secp
from cometbft_tpu.crypto import secp256k1eth as r_eth
from cometbft_tpu.libs.bits import BitArray as RBitArray
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types import validation as rv
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import AggregateCommit as RAggregateCommit
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.part_set import PartSetHeader as RPSH
from cometbft_tpu.types.signature_cache import SignatureCache as RCache
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.validator import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu.types.vote import BLOCK_ID_FLAG_COMMIT
from cometbft_tpu.wire import encode, pb as rpb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import bls12381 as p_bls
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types import validation as pv
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.types.signature_cache import SignatureCache
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "forms-chain"
HEIGHT = 7


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The reference runs its BLS in pure Python unless its native
    module is built: build it."""
    _native_loader.load()


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    """Both packages' process-global aggregate caches start empty; the
    reference batches ed25519 on its CPU backend."""
    pv.reset_aggregate_caches()
    monkeypatch.setattr(rv, "_PK_RAWS", None)
    monkeypatch.setattr(r_bls, "_AGG_PK_CACHE", None)
    r_batch.set_backend("cpu")
    yield
    r_batch.set_backend("auto")
    pv.reset_aggregate_caches()


def _seed(tag, i):
    return hashlib.sha256(b"%s/%d" % (tag, i)).digest()


def _priv(kind, i):
    s = _seed(kind.encode(), i)
    if kind == "ed25519":
        return r_ed.gen_priv_key_from_secret(s)
    if kind == "secp256k1":
        return r_secp.gen_priv_key_from_secret(s)
    if kind == "secp256k1eth":
        return r_eth.Secp256k1EthPrivKey(
            (int.from_bytes(s, "big") % (r_secp._N - 1) + 1).to_bytes(32, "big"))
    return r_bls.gen_priv_key_from_secret(s)


def _bid(tag=b"\x77"):
    return RBlockID(hash=tag * 32, part_set_header=RPSH(1, b"\x88" * 32))


def _port_bid(r_bid):
    return BlockID(r_bid.hash, PartSetHeader(r_bid.part_set_header.total,
                                             r_bid.part_set_header.hash))


class Case(NamedTuple):
    vals: RValidatorSet
    commit: object
    bid: RBlockID
    trusted: RValidatorSet          # the set the trusting call trusts
    signer_vals: Optional[RValidatorSet] = None
    reuse_cache: bool = False
    bad_idx: Optional[int] = None   # the index verify_commit must name


# -- grouped (mixed-key) commits -----------------------------------------

def _mixed(counts, corrupt=(), absent=(), short=()):
    """A reference set of the given key types (equal power) and a fully
    signed precommit commit; ``corrupt`` flips bit 0 of those slots'
    signatures, ``absent`` marks slots absent, ``short`` replaces a
    signature by 32 bytes (reference: test_batch_grouped.py:91-118)."""
    privs = [_priv(kind, i) for kind, n in counts for i in range(n)]
    vset = RValidatorSet([RValidator.new(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = _bid()
    sigs = []
    for i, val in enumerate(vset.validators):
        if i in absent:
            sigs.append(RCommitSig.absent())
            continue
        ts = RTimestamp(1700000100 + i, 0)
        sb = r_canonical.vote_sign_bytes(
            CHAIN_ID, r_canonical.PRECOMMIT_TYPE, HEIGHT, 0, bid, ts)
        sig = by_addr[val.address].sign(sb)
        if i in corrupt:
            sig = bytes([sig[0] ^ 0x01]) + sig[1:]
        if i in short:
            sig = b"\x01" * 32
        sigs.append(RCommitSig(block_id_flag=BLOCK_ID_FLAG_COMMIT,
                               validator_address=val.address,
                               timestamp=ts, signature=sig))
    return vset, RCommit(height=HEIGHT, round=0, block_id=bid,
                         signatures=sigs)


MIXED = (("ed25519", 3), ("bls12_381", 2), ("secp256k1", 1))
MIXED_ALL = (("ed25519", 3), ("bls12_381", 2), ("secp256k1", 2),
             ("secp256k1eth", 1))
# no ed25519 group: the cases about host-verified signatures skip the
# plain kernel, which costs ~1.5 s a call on the CPU
MIXED_HOST = (("bls12_381", 2), ("secp256k1", 2), ("secp256k1eth", 1))


def _types(counts):
    vset, _ = _mixed(counts)
    return [v.pub_key.type() for v in vset.validators]


def _grouped(counts=MIXED, **kw):
    vals, commit = _mixed(counts, **kw)
    bad = [*kw.get("corrupt", ()), *kw.get("short", ())]
    return Case(vals, commit, commit.block_id, vals,
                bad_idx=min(bad) if bad else None)


def _first_of(counts, kind):
    return _types(counts).index(kind)


def _lowest_pair(counts, inline_first):
    """(deferred idx, inline idx) of the set with the inline one first
    or last."""
    types = _types(counts)
    inline = [i for i, t in enumerate(types) if t.startswith("secp")]
    deferred = [i for i, t in enumerate(types) if not t.startswith("secp")]
    pairs = [(d, i) for d in deferred for i in inline
             if (i < d) == inline_first]
    assert pairs, "the seeds leave no such pair"
    return pairs[0]


def _grouped_lowest(counts, inline_first):
    d, i = _lowest_pair(counts, inline_first)
    return _grouped(counts, corrupt=(d, i))


def _grouped_forged_no_quorum():
    vals, commit = _mixed(MIXED, corrupt=(1,), absent=range(3, 6))
    return Case(vals, commit, commit.block_id, vals, bad_idx=1)


GROUPED = {
    "grouped_honest": lambda: _grouped(),
    # the honest four-type commit runs in the kernel test below
    "grouped_corrupt_ed25519": lambda: _grouped(
        corrupt=(_first_of(MIXED, "ed25519"),)),
    **{f"grouped_corrupt_{k}": (lambda k=k: _grouped(
        MIXED_HOST, corrupt=(_first_of(MIXED_HOST, k),)))
       for k in ("bls12_381", "secp256k1", "secp256k1eth")},
    "grouped_lowest_index_inline_first": lambda: _grouped_lowest(
        MIXED_HOST, True),
    "grouped_lowest_index_deferred_first": lambda: _grouped_lowest(
        MIXED_ALL, False),
    "grouped_cache_reused": lambda: _grouped()._replace(reuse_cache=True),
    "grouped_forged_no_quorum": _grouped_forged_no_quorum,
    "grouped_wrong_length": lambda: _grouped(
        short=(_first_of(MIXED, "ed25519"),)),
    "all_secp256k1_single": lambda: _grouped((("secp256k1", 3),
                                              ("secp256k1eth", 1))),
    "all_bls_batch": lambda: _grouped((("bls12_381", 4),)),
    "all_bls_batch_corrupt": lambda: _grouped((("bls12_381", 4),),
                                              corrupt=(1,)),
}


# -- aggregate commits ----------------------------------------------------

def _bls_keys(n, tag=b"k"):
    """The reference's keys of test_aggregate_commit.py:48-51."""
    return [r_bls.gen_priv_key_from_secret(
        bytes([i % 256, i // 256]) + tag + b"\0" * (30 - len(tag)))
        for i in range(n)]


def _valset(sks) -> RValidatorSet:
    return RValidatorSet([RValidator(address=sk.pub_key().address(),
                                     pub_key=sk.pub_key(), voting_power=10)
                          for sk in sks])


def _sign_bytes(round_, bid):
    return r_canonical.vote_sign_bytes(
        CHAIN_ID, r_canonical.PRECOMMIT_TYPE, HEIGHT, round_, bid,
        RTimestamp.zero())


def _aggregate(sks, vals, bid, skip=(), round_=0):
    sb = _sign_bytes(round_, bid)
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    signers = RBitArray(vals.size())
    sigs = []
    for i, v in enumerate(vals.validators):
        if i in skip:
            continue
        signers.set_index(i, True)
        sigs.append(by_addr[v.address].sign(sb))
    return RAggregateCommit(height=HEIGHT, round=round_, block_id=bid,
                            signers=signers, signature=r_bls.aggregate(sigs))


def _agg_case(skip=(), mutate=None, bid=None, sign_bid=None):
    sks = _bls_keys(7)
    vals = _valset(sks)
    bid = bid or _bid(b"B")
    agg = _aggregate(sks, vals, sign_bid or bid, skip=skip)
    if mutate:
        mutate(agg)
    return Case(vals, agg, bid, vals, signer_vals=vals)


def _set_bit(i):
    return lambda agg: agg.signers.set_index(i, True)


def _agg_out_of_range():
    case = _agg_case()
    wide = RBitArray(case.vals.size() + 2)
    for i in case.commit.signers.true_indices():
        wide.set_index(i, True)
    wide.set_index(case.vals.size() + 1, True)
    case.commit.signers = wide
    return case


def _agg_wrong_key():
    other = _bls_keys(7, tag=b"x")
    bad = _aggregate(other, _valset(other), _bid(b"B"))
    return _agg_case(mutate=lambda agg: setattr(agg, "signature",
                                                bad.signature))


def _agg_nil_included():
    sks = _bls_keys(7)
    vals = _valset(sks)
    bid = _bid(b"B")
    sb, sb_nil = _sign_bytes(0, bid), _sign_bytes(0, RBlockID())
    by_addr = {sk.pub_key().address(): sk for sk in sks}
    signers = RBitArray(vals.size())
    sigs = []
    for i, v in enumerate(vals.validators):
        signers.set_index(i, True)
        sigs.append(by_addr[v.address].sign(sb_nil if i == 2 else sb))
    agg = RAggregateCommit(height=HEIGHT, round=0, block_id=bid,
                           signers=signers, signature=r_bls.aggregate(sigs))
    return Case(vals, agg, bid, vals, signer_vals=vals)


def _shifted(vals, d_sk):
    """vals with keys 0 and 1 shifted by +/-[d_sk]G1: the same key sum."""
    delta = r_m.pt_mul(r_m.G1_OPS, r_m.G1_GEN, d_sk)
    sub = [RValidator(address=v.address, pub_key=v.pub_key,
                      voting_power=v.voting_power) for v in vals.validators]
    pk_a = r_bls.Bls12381PubKey(r_m.g1_serialize(r_m.pt_add(
        r_m.G1_OPS, sub[0].pub_key.point(), delta)))
    pk_b = r_bls.Bls12381PubKey(r_m.g1_serialize(r_m.pt_add(
        r_m.G1_OPS, sub[1].pub_key.point(), r_m.pt_neg(r_m.G1_OPS, delta))))
    return sub, pk_a, pk_b


def _agg_rogue_set():
    """A substitute set with the same key sum: the pairing passes over
    it, but its hash differs, so no header can carry it."""
    case = _agg_case()
    sub, pk_a, pk_b = _shifted(case.vals, 12345)
    sub[0] = RValidator(address=pk_a.address(), pub_key=pk_a,
                        voting_power=10)
    sub[1] = RValidator(address=pk_b.address(), pub_key=pk_b,
                        voting_power=10)
    forged = RValidatorSet(sub)
    assert forged.hash() != case.vals.hash()
    return Case(forged, case.commit, case.bid, forged, signer_vals=forged)


def _agg_trusting_rogue_cancellation():
    sks = _bls_keys(7)
    vals = _valset(sks)
    bid = _bid(b"B")
    x = 987654321
    rogue_pt = r_m.pt_mul(r_m.G1_OPS, r_m.G1_GEN, x)
    for v in vals.validators[:5]:
        rogue_pt = r_m.pt_add(r_m.G1_OPS, rogue_pt,
                              r_m.pt_neg(r_m.G1_OPS, v.pub_key.point()))
    rogue_pk = r_bls.Bls12381PubKey(r_m.g1_serialize(rogue_pt))
    fabricated = RValidatorSet(
        [RValidator(address=v.address, pub_key=v.pub_key,
                    voting_power=v.voting_power)
         for v in vals.validators[:5]] +
        [RValidator(address=rogue_pk.address(), pub_key=rogue_pk,
                    voting_power=1)])
    sig = r_m.g2_compress(r_m.pt_mul(
        r_m.G2_OPS, r_m.hash_to_g2(_sign_bytes(0, bid), r_bls.DST), x))
    agg = RAggregateCommit(height=HEIGHT, round=0, block_id=bid,
                           signers=RBitArray.from_indices(6, range(6)),
                           signature=sig)
    return Case(fabricated, agg, bid, vals, signer_vals=fabricated)


def _agg_trusting_substituted(bad_signature):
    case = _agg_case()
    sub, pk_a, pk_b = _shifted(case.vals, 4242)
    sub[0] = RValidator(address=sub[0].address, pub_key=pk_a,
                        voting_power=10)
    sub[1] = RValidator(address=sub[1].address, pub_key=pk_b,
                        voting_power=10)
    fabricated = RValidatorSet(sub)
    agg = case.commit
    if bad_signature:
        agg = copy.deepcopy(agg)
        agg.signature = r_bls.aggregate(
            [sk.sign(_sign_bytes(1, case.bid)) for sk in _bls_keys(7)])
    return Case(case.vals, agg, case.bid, case.vals,
                signer_vals=fabricated)


def _agg_unknown_signer():
    new_sks = _bls_keys(7) + _bls_keys(1, tag=b"new")
    new_vals = _valset(new_sks)
    agg = _aggregate(new_sks, new_vals, _bid(b"B"))
    return Case(new_vals, agg, _bid(b"B"), _valset(_bls_keys(7)),
                signer_vals=new_vals)


def _agg_no_signer_vals():
    return _agg_case()._replace(signer_vals=None)


AGGREGATE = {
    "agg_honest": lambda: _agg_case(),
    "agg_one_absent": lambda: _agg_case(skip=(3,)),
    "agg_sub_quorum": lambda: _agg_case(skip=(0, 1, 2)),
    "agg_non_signer_bit": lambda: _agg_case(skip=(3,), mutate=_set_bit(3)),
    "agg_out_of_range_bit": _agg_out_of_range,
    "agg_wrong_key": _agg_wrong_key,
    "agg_wrong_block_id": lambda: _agg_case(sign_bid=_bid(b"C")),
    "agg_nil_included": _agg_nil_included,
    "agg_nil_excluded": lambda: _agg_case(skip=(2,)),
    "agg_rogue_set_same_key_sum": _agg_rogue_set,
    "agg_trusting_rogue_cancellation": _agg_trusting_rogue_cancellation,
    "agg_trusting_substituted_keys": lambda: _agg_trusting_substituted(False),
    "agg_trusting_substituted_keys_bad_sig":
        lambda: _agg_trusting_substituted(True),
    "agg_trusting_unknown_signer": _agg_unknown_signer,
    "agg_trusting_without_signer_vals": _agg_no_signer_vals,
    "agg_cache_reused": lambda: _agg_case()._replace(reuse_cache=True),
    "agg_bad_signature_cache_reused": lambda: _agg_case(
        skip=(3,), mutate=_set_bit(3))._replace(reuse_cache=True),
}

SCENARIOS = {**GROUPED, **AGGREGATE}

CALLS = ["verify_commit", "verify_commit_light",
         "verify_commit_light_trusting"]

# the reference's verdict on some (scenario, call) pairs (None = ok),
# pinned so a change in either package that moves both is caught too
_OK = ("verify_commit", "verify_commit_light", "verify_commit_light_trusting")
EXPECTED = {
    **{(name, call): None for name in (
        "grouped_honest", "grouped_cache_reused", "all_secp256k1_single", "all_bls_batch",
        "agg_honest", "agg_one_absent", "agg_nil_excluded")
       for call in _OK},
    # the pairing over a same-sum substitute set passes: only its hash
    # (which no header carries) tells it apart
    ("agg_rogue_set_same_key_sum", "verify_commit"): None,
    ("agg_sub_quorum", "verify_commit"): "NotEnoughVotingPowerError",
    ("agg_trusting_rogue_cancellation", "verify_commit"): None,
    ("agg_trusting_rogue_cancellation", "verify_commit_light_trusting"):
        "NotEnoughVotingPowerError",
    ("agg_trusting_substituted_keys", "verify_commit_light_trusting"): None,
    ("agg_trusting_substituted_keys_bad_sig",
     "verify_commit_light_trusting"): "VerificationError",
    ("agg_trusting_unknown_signer", "verify_commit_light"): None,
    ("agg_trusting_unknown_signer", "verify_commit_light_trusting"):
        "NotEnoughVotingPowerError",
    ("agg_trusting_without_signer_vals", "verify_commit_light_trusting"):
        "VerificationError",
    ("agg_non_signer_bit", "verify_commit"): "VerificationError",
    ("agg_wrong_key", "verify_commit"): "VerificationError",
    ("agg_nil_included", "verify_commit"): "VerificationError",
}


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared by type and text
        return type(e).__name__, str(e)
    return None


def _carry(case, wire):
    """The port's objects for a case: set and commit as wire bytes or
    as dicts."""
    def vs(v):
        return None if v is None else convert.validator_set(
            encode(rpb.VALIDATOR_SET, v.to_proto()) if wire else v.to_proto())
    if isinstance(case.commit, RAggregateCommit):
        d = case.commit.to_proto()
        commit = convert.aggregate_commit(
            encode(rpb.AGGREGATE_COMMIT, d) if wire else d)
    else:
        d = case.commit.to_proto()
        commit = convert.commit(encode(rpb.COMMIT, d) if wire else d)
    return vs(case.vals), commit, vs(case.trusted), vs(case.signer_vals)


def _run(case, call, p_objs, r_cache, p_cache):
    p_vals, p_commit, p_trusted, p_signers = p_objs
    p_bid = _port_bid(case.bid)
    if call == "verify_commit_light_trusting":
        want = _outcome(lambda: rv.verify_commit_light_trusting(
            CHAIN_ID, case.trusted, case.commit, rv.Fraction(1, 3),
            cache=r_cache, signer_vals=case.signer_vals))
        got = _outcome(lambda: pv.verify_commit_light_trusting(
            CHAIN_ID, p_trusted, p_commit, pv.Fraction(1, 3), cache=p_cache,
            signer_vals=p_signers, device="cpu"))
    else:
        want = _outcome(lambda: getattr(rv, call)(
            CHAIN_ID, case.vals, case.bid, HEIGHT, case.commit,
            cache=r_cache))
        got = _outcome(lambda: getattr(pv, call)(
            CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit, cache=p_cache,
            device="cpu"))
    return want, got


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_verdict_and_error_text_match_reference(scenario, call):
    case = SCENARIOS[scenario]()
    p_objs = _carry(case, wire=hash(scenario) % 2 == 0)
    r_cache = RCache() if case.reuse_cache else None
    p_cache = SignatureCache() if case.reuse_cache else None
    for _ in range(2 if case.reuse_cache else 1):
        want, got = _run(case, call, p_objs, r_cache, p_cache)
        assert got == want
        if case.reuse_cache:
            assert len(p_cache) == len(r_cache)
    if (scenario, call) in EXPECTED:
        assert (want and want[0]) == EXPECTED[scenario, call]
    if case.bad_idx is not None and call == "verify_commit":
        assert want[1].startswith(f"wrong signature (#{case.bad_idx}): ")


def test_group_gate_matches_reference():
    for counts in (MIXED, MIXED_ALL, MIXED_HOST,
                   (("secp256k1", 3), ("secp256k1eth", 2)),
                   (("secp256k1", 3), ("bls12_381", 1), ("ed25519", 1)),
                   (("secp256k1", 1), ("bls12_381", 2))):
        vals, commit = _mixed(counts)
        p_vals, p_commit, _, _ = _carry(Case(vals, commit, commit.block_id,
                                             vals), wire=False)
        assert pv._should_group_verify(p_vals, p_commit) == \
            rv._should_group_verify(vals, commit)
        assert pv._should_batch_verify(p_vals, p_commit) == \
            rv._should_batch_verify(vals, commit)


def test_cache_records_verified_key_address_not_commit_field():
    """tests/test_batch_grouped.py:183-205: the cache entry of a
    signature whose slot claims another validator's address records
    the key that verified it."""
    vals, commit = _mixed(MIXED)
    spoof_to = vals.validators[3].address
    s = commit.signatures[0]
    commit.signatures[0] = RCommitSig(
        block_id_flag=s.block_id_flag, validator_address=spoof_to,
        timestamp=s.timestamp, signature=s.signature)
    p_vals, p_commit, _, _ = _carry(Case(vals, commit, commit.block_id,
                                         vals), wire=True)
    cache, r_cache = SignatureCache(), RCache()
    rv.verify_commit(CHAIN_ID, vals, commit.block_id, HEIGHT, commit,
                     cache=r_cache)
    pv.verify_commit(CHAIN_ID, p_vals, _port_bid(commit.block_id), HEIGHT,
                     p_commit, cache=cache, device="cpu")
    got, want = cache.get(s.signature), r_cache.get(s.signature)
    assert got.validator_address == want.validator_address == \
        vals.validators[0].pub_key.address() != spoof_to


def test_nil_pubkey_rejected_like_reference():
    """tests/test_batch_grouped.py:223-237, on a mixed set too."""
    for counts in ((("ed25519", 4),), MIXED):
        vals, commit = _mixed(counts)
        p_vals, p_commit, _, _ = _carry(Case(vals, commit, commit.block_id,
                                             vals), wire=False)
        vals.validators[2].pub_key = None
        p_vals.validators[2].pub_key = None
        want = _outcome(lambda: rv.verify_commit(
            CHAIN_ID, vals, commit.block_id, HEIGHT, commit))
        got = _outcome(lambda: pv.verify_commit(
            CHAIN_ID, p_vals, _port_bid(commit.block_id), HEIGHT, p_commit,
            device="cpu"))
        assert got == want and "nil PubKey" in want[1]


def _agg_port(case):
    p_vals, p_commit, _, _ = _carry(case, wire=True)
    return p_vals, p_commit, _port_bid(case.bid)


def test_verdict_memo_skips_the_pairing(monkeypatch):
    """tests/test_aggregate_commit.py:406-420."""
    p_vals, p_commit, p_bid = _agg_port(_agg_case())
    cache = SignatureCache()
    pv.verify_commit(CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit, cache=cache,
                     device="cpu")
    calls = []
    orig = p_bls.verify_aggregate
    monkeypatch.setattr(p_bls, "verify_aggregate",
                        lambda *a: calls.append(1) or orig(*a))
    pv.verify_commit(CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit, cache=cache,
                     device="cpu")
    assert calls == []


def test_aggregate_pubkey_cache_skips_the_point_sum(monkeypatch):
    """tests/test_aggregate_commit.py:422-437, with the cache's
    counters."""
    from cometbft_tpu_torch.libs import metrics as p_metrics
    families = {m.name: m for m in p_metrics.DEFAULT.families()}
    hits = families["cometbft_crypto_agg_pubkey_cache_hits"]
    misses = families["cometbft_crypto_agg_pubkey_cache_misses"]
    h0, m0 = hits.value, misses.value
    p_vals, p_commit, p_bid = _agg_port(_agg_case())
    pv.verify_commit(CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit, device="cpu")
    assert (hits.value - h0, misses.value - m0) == (0, 1)
    calls = []
    orig = p_bls.aggregate_pub_keys_raw
    monkeypatch.setattr(p_bls, "aggregate_pub_keys_raw",
                        lambda blob: calls.append(1) or orig(blob))
    pv.verify_commit(CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit, device="cpu")
    assert calls == []
    assert (hits.value - h0, misses.value - m0) == (1, 1)
    assert pv.commit_verify_histogram().with_labels("aggregate").count >= 2


def test_aggregate_commit_proto_round_trip():
    """The wire form carries across both ways; non-canonical bitmaps
    are rejected with the reference's text."""
    agg = _agg_case().commit
    d = agg.to_proto()
    p = convert.aggregate_commit(encode(rpb.AGGREGATE_COMMIT, d))
    assert p.to_proto() == d
    assert p.signed_indices() == agg.signed_indices()
    assert p.vote_sign_bytes(CHAIN_ID) == agg.vote_sign_bytes(CHAIN_ID)
    for bad in (dict(d, signers=bytes([d["signers"][0] | 0x80])),
                dict(d, signers=d["signers"] + b"\x00")):
        want = _outcome(lambda: RAggregateCommit.from_proto(bad))
        got = _outcome(lambda: convert.aggregate_commit(bad))
        assert got == want and want[0] == "CommitError"


@pytest.mark.parametrize("kernel", ["cuda", "cuda8"])
def test_mixed_commit_sends_only_the_ed25519_group_to_the_kernel(
        kernel, monkeypatch):
    """Under either kernel's plain version the ed25519 group — and only
    it — reaches ops/ed25519.verify_batch, in one call; under cuda8 the
    first kernel is never reached.  The verification is observed as
    ``grouped``."""
    monkeypatch.setenv("COMETBFT_TPU_TORCH_KERNEL", kernel)
    if kernel == "cuda8":
        def first_kernel(*_):
            raise AssertionError("cuda8 reached the first kernel")
        monkeypatch.setattr(ek, "verify_cols", first_kernel)
    seen = []
    orig = oe.verify_batch
    monkeypatch.setattr(oe, "verify_batch", lambda items, device=None:
                        seen.append(list(items)) or orig(items, device))
    vals, commit = _mixed(MIXED_ALL)
    p_vals, p_commit, _, _ = _carry(Case(vals, commit, commit.block_id,
                                         vals), wire=True)
    grouped = pv.commit_verify_histogram().with_labels("grouped")
    before = grouped.count
    pv.verify_commit(CHAIN_ID, p_vals, _port_bid(commit.block_id), HEIGHT,
                     p_commit, device="cpu")
    assert grouped.count == before + 1
    ed_pubs = [v.pub_key.bytes() for v in vals.validators
               if v.pub_key.type() == "ed25519"]
    assert len(seen) == 1
    assert [pub for pub, _, _ in seen[0]] == ed_pubs


@pytest.mark.cuda
def test_mixed_commit_on_the_card():
    """A small mixed commit and an aggregate commit through the
    default entry points: the ed25519 group on B1 (one launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vals, commit = _mixed(MIXED_ALL)
    p_vals, p_commit, _, _ = _carry(Case(vals, commit, commit.block_id,
                                         vals), wire=True)
    ek.launches = 0
    pv.verify_commit(CHAIN_ID, p_vals, _port_bid(commit.block_id), HEIGHT,
                     p_commit)
    assert ek.launches == 1
    bad_idx = _first_of(MIXED_ALL, "ed25519")
    vals, commit = _mixed(MIXED_ALL, corrupt=(bad_idx,))
    p_vals, p_commit, _, _ = _carry(Case(vals, commit, commit.block_id,
                                         vals), wire=True)
    with pytest.raises(pv.VerificationError,
                       match=rf"^wrong signature \(#{bad_idx}\): "):
        pv.verify_commit(CHAIN_ID, p_vals, _port_bid(commit.block_id),
                         HEIGHT, p_commit)
    p_vals, p_commit, p_bid = _agg_port(_agg_case())
    pv.verify_commit(CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit)
