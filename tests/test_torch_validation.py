"""Commit verification in the port against the reference package.

Commits of 4 to 16 validators are built and signed with the JAX
package's own types and keys, carried across by
cometbft_tpu_torch/convert.py (as dicts and as wire bytes), and verified
by both packages: the reference on its ``cpu`` backend, the port with
``device="cpu"`` (the CUDA kernel's plain version, of the first kernel
and, under COMETBFT_TPU_TORCH_KERNEL=cuda8, of the second).  Verdicts
and error texts must be equal."""
import pytest

from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.types import validation as rv
from cometbft_tpu.types.block_id import BlockID as RBlockID
from cometbft_tpu.types.commit import Commit as RCommit
from cometbft_tpu.types.commit import CommitSig as RCommitSig
from cometbft_tpu.types.part_set import PartSetHeader as RPSH
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu.types.validator import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu.types.vote import (
    BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL,
)
from cometbft_tpu.wire import encode, pb as rpb
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types import validation as pv
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet

CHAIN_ID = "test-chain"
HEIGHT = 7


def _block_id(tag=b"b"):
    return RBlockID(hash=tag * 32, part_set_header=RPSH(3, tag * 32))


def _signed(n, powers=None, absent=(), nil=(), bad=()):
    """A reference ValidatorSet and a Commit signed by its validators."""
    privs = [r_ed.gen_priv_key_from_secret(b"validator-%d" % i)
             for i in range(n)]
    powers = powers or [10] * n
    vals = RValidatorSet([RValidator.new(p.pub_key(), pw)
                          for p, pw in zip(privs, powers)])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = _block_id()
    commit = RCommit(height=HEIGHT, round=1, block_id=bid,
                     signatures=[RCommitSig.absent() for _ in range(n)])
    sigs = []
    for i, val in enumerate(vals.validators):
        if i in absent:
            sigs.append(RCommitSig.absent())
            continue
        flag = BLOCK_ID_FLAG_NIL if i in nil else BLOCK_ID_FLAG_COMMIT
        cs = RCommitSig(block_id_flag=flag,
                        validator_address=val.address,
                        timestamp=RTimestamp(1_700_000_000 + i, 1000 * i))
        commit.signatures[i] = cs
        sig = by_addr[val.address].sign(commit.vote_sign_bytes(CHAIN_ID, i))
        if i in bad:
            sig = sig[:5] + bytes([sig[5] ^ 0x40]) + sig[6:]
        cs.signature = sig
        sigs.append(cs)
    return vals, RCommit(height=HEIGHT, round=1, block_id=bid,
                         signatures=sigs)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared by type and text
        return type(e).__name__, str(e)
    return None


SCENARIOS = {
    "valid": dict(n=4),
    "bad_signature": dict(n=8, bad=(5, 2)),
    "insufficient_power": dict(n=6, absent=(0, 1, 2)),
    "absent_signatures": dict(n=16, absent=(3, 9, 15), nil=(4,)),
    "wrong_height": dict(n=4),
    "wrong_block_id": dict(n=5),
    "unequal_power": dict(n=7, powers=[50, 1, 1, 30, 2, 9, 7], bad=(6,)),
}

CALLS = ["verify_commit", "verify_commit_light",
         "verify_commit_light_trusting"]


def _check_against_reference(scenario, call):
    opts = dict(SCENARIOS[scenario])
    vals, commit = _signed(**opts)
    # carried across once as dicts, once as wire bytes
    p_vals = convert.validator_set(vals.to_proto())
    p_commit = convert.commit(encode(rpb.COMMIT, commit.to_proto()))
    height = HEIGHT + 1 if scenario == "wrong_height" else HEIGHT
    r_bid = _block_id(b"x") if scenario == "wrong_block_id" else _block_id()
    p_bid = BlockID(r_bid.hash, PartSetHeader(
        r_bid.part_set_header.total, r_bid.part_set_header.hash))

    if call == "verify_commit_light_trusting":
        want = _outcome(lambda: rv.verify_commit_light_trusting(
            CHAIN_ID, vals, commit, rv.Fraction(1, 3)))
        got = _outcome(lambda: pv.verify_commit_light_trusting(
            CHAIN_ID, p_vals, p_commit, pv.Fraction(1, 3), device="cpu"))
    else:
        want = _outcome(lambda: getattr(rv, call)(
            CHAIN_ID, vals, r_bid, height, commit))
        got = _outcome(lambda: getattr(pv, call)(
            CHAIN_ID, p_vals, p_bid, height, p_commit, device="cpu"))
    assert got == want
    if scenario in ("valid", "absent_signatures"):
        assert want is None
    if scenario == "bad_signature":
        assert want[1].startswith("wrong signature (#2): ")


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_verdict_and_error_text_match_reference(scenario, call):
    _check_against_reference(scenario, call)


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_second_kernel_verdict_and_error_text_match_reference(
        scenario, call, monkeypatch):
    """The same commits through COMETBFT_TPU_TORCH_KERNEL=cuda8 (the
    second kernel's plain version); the first kernel is never reached."""
    def first_kernel(*_):
        raise AssertionError("cuda8 reached the first kernel")

    monkeypatch.setenv("COMETBFT_TPU_TORCH_KERNEL", "cuda8")
    monkeypatch.setattr(ek, "verify_cols", first_kernel)
    _check_against_reference(scenario, call)


def test_single_signature_path_matches_reference():
    """A one-validator commit takes the per-signature path (golden
    model), not the batch path: no kernel involved."""
    vals, commit = _signed(1, bad=(0,))
    p_vals = convert.validator_set(encode(rpb.VALIDATOR_SET,
                                          vals.to_proto()))
    p_commit = convert.commit(commit.to_proto())
    before = ek.launches
    want = _outcome(lambda: rv.verify_commit(
        CHAIN_ID, vals, _block_id(), HEIGHT, commit))
    got = _outcome(lambda: pv.verify_commit(
        CHAIN_ID, p_vals, BlockID(b"b" * 32, PartSetHeader(3, b"b" * 32)),
        HEIGHT, p_commit, device="cpu"))
    assert got == want and want[0] == "VerificationError"
    assert ek.launches == before


def test_port_built_set_equals_carried_set():
    """The port's own NewValidatorSet (priorities, order, proposer)
    equals the reference set carried across."""
    powers = [5, 17, 17, 1, 40, 3]
    privs = [r_ed.gen_priv_key_from_secret(b"v%d" % i)
             for i in range(len(powers))]
    ref_set = RValidatorSet([RValidator.new(p.pub_key(), pw)
                             for p, pw in zip(privs, powers)])
    port_set = ValidatorSet([
        Validator.new(p_ed.Ed25519PubKey(p.pub_key().bytes()), pw)
        for p, pw in zip(privs, powers)])
    carried = convert.validator_set(ref_set.to_proto())
    assert port_set.to_proto() == carried.to_proto() == ref_set.to_proto()
    assert port_set.get_proposer().address == \
        ref_set.get_proposer().address
    port_set.increment_proposer_priority(3)
    ref_set.increment_proposer_priority(3)
    assert port_set.to_proto() == ref_set.to_proto()


def test_sign_bytes_and_keys_match_reference():
    vals, commit = _signed(4)
    p_commit = convert.commit(commit.to_proto())
    for i in range(4):
        assert p_commit.vote_sign_bytes(CHAIN_ID, i) == \
            commit.vote_sign_bytes(CHAIN_ID, i)
    seed = bytes(range(32))
    assert p_ed.Ed25519PrivKey(seed).pub_key().bytes() == \
        r_ed.Ed25519PrivKey(seed).pub_key().bytes()
    assert p_ed.Ed25519PrivKey(seed).sign(b"m") == \
        r_ed.Ed25519PrivKey(seed).sign(b"m")
    assert p_ed.Ed25519PrivKey(seed).pub_key().address() == \
        r_ed.Ed25519PrivKey(seed).pub_key().address()


def test_absent_flag_constants_match():
    from cometbft_tpu_torch.types import vote as pvote
    assert (pvote.BLOCK_ID_FLAG_ABSENT, pvote.BLOCK_ID_FLAG_COMMIT,
            pvote.BLOCK_ID_FLAG_NIL) == (BLOCK_ID_FLAG_ABSENT,
                                         BLOCK_ID_FLAG_COMMIT,
                                         BLOCK_ID_FLAG_NIL)


def test_sign_bytes_template_matches_full_marshal():
    """The per-commit template splices each timestamp between two
    pre-marshalled halves; it must equal the full canonical marshal for
    commit, nil and absent flags."""
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.timestamp import Timestamp
    bid = BlockID(b"b" * 32, PartSetHeader(3, b"b" * 32))
    for block_id in (bid, BlockID()):
        make = canonical.vote_sign_bytes_template(
            CHAIN_ID, canonical.PRECOMMIT_TYPE, HEIGHT, 1, block_id)
        for ts in (Timestamp(1_700_000_000, 5), Timestamp.zero(),
                   Timestamp(0, 0)):
            assert make(ts) == canonical.vote_sign_bytes(
                CHAIN_ID, canonical.PRECOMMIT_TYPE, HEIGHT, 1, block_id, ts)


def test_signature_cache_skips_verified_signatures(monkeypatch):
    """A second verification with the same cache verifies nothing on
    the batch path; the reference with its own cache agrees on both
    calls."""
    from cometbft_tpu.types.signature_cache import SignatureCache as RCache
    from cometbft_tpu_torch.crypto import batch as pbatch
    from cometbft_tpu_torch.types.signature_cache import SignatureCache
    vals, commit = _signed(6)
    p_vals = convert.validator_set(vals.to_proto())
    p_commit = convert.commit(commit.to_proto())
    p_bid = BlockID(b"b" * 32, PartSetHeader(3, b"b" * 32))
    cache, r_cache = SignatureCache(), RCache()
    for _ in range(2):
        assert _outcome(lambda: rv.verify_commit(
            CHAIN_ID, vals, _block_id(), HEIGHT, commit,
            cache=r_cache)) is None
        assert _outcome(lambda: pv.verify_commit(
            CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit, cache=cache,
            device="cpu")) is None
    assert len(cache) == len(r_cache) == 6
    assert cache.hits == 6

    calls = []
    real = pbatch.CudaBatchVerifier.verify

    def counting(self):
        calls.append(len(self))
        return real(self)

    monkeypatch.setattr(pbatch.CudaBatchVerifier, "verify", counting)
    pv.verify_commit(CHAIN_ID, p_vals, p_bid, HEIGHT, p_commit,
                     cache=cache, device="cpu")
    assert calls == []          # everything came from the cache
