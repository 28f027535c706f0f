"""Commit verification — the seam that sends a commit's signatures to
the CUDA kernel.

Reference: types/validation.go, through cometbft_tpu/types/validation.py.
Semantics preserved exactly:
  * batching requires >= 2 signatures, a batch-capable key type, and all
    validators sharing one key type (:15-21);
  * VerifyCommit checks ALL signatures (incentivization contract),
    VerifyCommitLight* stop at 2/3 unless count_all_signatures;
  * on batch failure, the first invalid signature is identified (:384-397);
  * signature-cache hits skip verification and successes populate the cache.

The batch path defers every signature into crypto/batch's verifier, one
kernel launch per tile on the card (``device=None``) or the kernel's
plain version on ``device="cpu"``.  Aggregate (BLS) commits and the
mixed-key grouped path are not ported yet: the port's keys are ed25519.
Each verification is timed into ``consensus_commit_verify_seconds`` by
its kind, ``batch`` or ``single`` (reference: validation.py:42-80).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

from ..crypto import batch as crypto_batch
from ..device import resolve
from ..libs import metrics as libmetrics
from .block_id import BlockID
from .commit import Commit, CommitError, CommitSig
from .signature_cache import SignatureCache, SignatureCacheValue
from .validator_set import ValidatorSet
from .vote import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT

BATCH_VERIFY_THRESHOLD = 2

_COMMIT_VERIFY_HIST = libmetrics.DEFAULT.histogram(
    "consensus", "commit_verify_seconds",
    "Commit verification latency in seconds, by verification "
    "kind (aggregate = O(1) BLS pairing path; "
    "batch/grouped/single = per-signature paths).",
    labels=("kind",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5))


def commit_verify_histogram() -> libmetrics.Histogram:
    return _COMMIT_VERIFY_HIST


class _observe_kind:
    """Times one commit verification into the kind-labelled histogram
    (a rejected commit is observed too: it paid the verification)."""

    __slots__ = ("kind", "t0")

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _COMMIT_VERIFY_HIST.with_labels(self.kind).observe(
            time.perf_counter() - self.t0)
        return False


class Fraction(NamedTuple):
    numerator: int
    denominator: int


class VerificationError(Exception):
    pass


class NotEnoughVotingPowerError(VerificationError):
    def __init__(self, got: int, needed: int):
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, "
            f"needed more than {needed}")
        self.got = got
        self.needed = needed


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    return (len(commit.signatures) >= BATCH_VERIFY_THRESHOLD and
            crypto_batch.supports_batch_verifier(
                vals.get_proposer().pub_key) and
            vals.all_keys_have_same_type())


def _verify_basic_vals_and_commit(vals: ValidatorSet, commit,
                                  height: int, block_id: BlockID) -> None:
    if vals is None:
        raise VerificationError("nil validator set")
    if commit is None:
        raise VerificationError("nil commit")
    if vals.size() != commit.size():
        raise VerificationError(
            f"invalid commit -- wrong set size: {vals.size()} vs "
            f"{commit.size()}")
    if height != commit.height:
        raise VerificationError(
            f"invalid commit -- wrong height: {height} vs {commit.height}")
    if block_id != commit.block_id:
        raise VerificationError(
            f"invalid commit -- wrong block ID: want {block_id}, "
            f"got {commit.block_id}")


def _verify(chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures, look_up_by_index, cache, device) -> None:
    device = resolve(device)      # the card unless the caller names one
    if _should_batch_verify(vals, commit):
        with _observe_kind("batch"):
            _verify_commit_batch(
                chain_id, vals, commit, voting_power_needed, ignore, count,
                count_all_signatures, look_up_by_index, cache, device)
    else:
        with _observe_kind("single"):
            _verify_commit_single(
                chain_id, vals, commit, voting_power_needed, ignore, count,
                count_all_signatures, look_up_by_index, cache)


def verify_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID,
                  height: int, commit: Commit,
                  cache: Optional[SignatureCache] = None,
                  device=None) -> None:
    """+2/3 signed; checks ALL signatures (reference: VerifyCommit :30)."""
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
            lambda c: c.block_id_flag == BLOCK_ID_FLAG_ABSENT,
            lambda c: c.block_id_flag == BLOCK_ID_FLAG_COMMIT,
            count_all_signatures=True, look_up_by_index=True, cache=cache,
            device=device)


def verify_commit_light(chain_id: str, vals: ValidatorSet,
                        block_id: BlockID, height: int, commit: Commit,
                        count_all_signatures: bool = False,
                        cache: Optional[SignatureCache] = None,
                        device=None) -> None:
    """Light-client variant: stops at 2/3 unless count_all_signatures.

    Reference: VerifyCommitLight / ...AllSignatures / ...WithCache (:65)."""
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
            lambda c: c.block_id_flag != BLOCK_ID_FLAG_COMMIT,
            lambda c: True, count_all_signatures=count_all_signatures,
            look_up_by_index=True, cache=cache, device=device)


def verify_commit_light_trusting(
        chain_id: str, vals: ValidatorSet, commit: Commit,
        trust_level: Fraction, count_all_signatures: bool = False,
        cache: Optional[SignatureCache] = None, device=None) -> None:
    """trustLevel (e.g. 1/3) of a TRUSTED validator set signed; used for
    skipping verification.  Looks validators up by address since the sets
    need not correspond (reference: VerifyCommitLightTrusting :150)."""
    if vals is None:
        raise VerificationError("nil validator set")
    if trust_level.denominator == 0:
        raise VerificationError("trustLevel has zero Denominator")
    if commit is None:
        raise VerificationError("nil commit")
    product = vals.total_voting_power() * trust_level.numerator
    if product >= (1 << 63):
        raise VerificationError(
            "int64 overflow while calculating voting power needed")
    _verify(chain_id, vals, commit, product // trust_level.denominator,
            lambda c: c.block_id_flag != BLOCK_ID_FLAG_COMMIT,
            lambda c: True, count_all_signatures=count_all_signatures,
            look_up_by_index=False, cache=cache, device=device)


def _walk_commit(
        chain_id: str, vals: ValidatorSet, commit: Commit,
        voting_power_needed: int,
        ignore_sig: Callable[[CommitSig], bool],
        count_sig: Callable[[CommitSig], bool],
        count_all_signatures: bool, look_up_by_index: bool,
        cache: Optional[SignatureCache], strict: bool,
        handle: Callable) -> int:
    """The signature walk shared by the batch and single paths: ignore
    filter, optional structural validation, by-index or by-address
    validator lookup with double-vote detection, cache short-circuit,
    voting-power tally with the early exit.  Returns the tallied power.

    handle(idx, val, sign_bytes, commit_sig) is called for every
    signature the cache does not satisfy — it verifies inline (raising
    VerificationError) or defers into a batch verifier.

    strict adds commit_sig.validate_basic() (the per-signature path's
    behavior); the same-type batch path omits it, mirroring the
    reference's verifyCommitBatch.  The nil-pubkey check is
    unconditional on every path.
    """
    seen_vals: dict[int, int] = {}
    tallied = 0
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if strict:
            try:
                commit_sig.validate_basic()
            except CommitError as e:
                raise VerificationError(
                    f"invalid signature at index {idx}: {e}") from e
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(
                commit_sig.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise VerificationError(
                    f"double vote from {val} "
                    f"({seen_vals[val_idx]} and {idx})")
            seen_vals[val_idx] = idx
        if val.pub_key is None:
            raise VerificationError(
                f"validator {val} has a nil PubKey at index {idx}")

        vote_sign_bytes = commit.vote_sign_bytes(chain_id, idx)

        cache_hit = False
        if cache is not None:
            cv = cache.get(commit_sig.signature)
            cache_hit = (cv is not None and
                         cv.validator_address == val.pub_key.address() and
                         cv.vote_sign_bytes == vote_sign_bytes)
        if not cache_hit:
            handle(idx, val, vote_sign_bytes, commit_sig)

        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            break
    return tallied


def _verify_commit_batch(
        chain_id: str, vals: ValidatorSet, commit: Commit,
        voting_power_needed: int,
        ignore_sig: Callable[[CommitSig], bool],
        count_sig: Callable[[CommitSig], bool],
        count_all_signatures: bool, look_up_by_index: bool,
        cache: Optional[SignatureCache], device) -> None:
    """Reference: verifyCommitBatch (:265) — including its ordering:
    the voting-power threshold is judged before the deferred batch
    runs.  Cache entries record the VERIFIED key's address, never
    commit_sig.validator_address (attacker-controlled in by-index
    mode)."""
    bv = crypto_batch.create_batch_verifier(vals.get_proposer().pub_key,
                                            device=device)
    entries: list[tuple[int, bytes, bytes]] = []

    def handle(idx, val, sign_bytes, commit_sig):
        try:
            bv.add(val.pub_key, sign_bytes, commit_sig.signature)
        except (ValueError, TypeError) as e:
            # malformed (e.g. wrong-length) signature the structural
            # checks let through — the reference returns Add's error
            raise VerificationError(
                f"wrong signature (#{idx}): "
                f"{commit_sig.signature.hex().upper()}") from e
        entries.append((idx, val.pub_key.address(), sign_bytes))

    tallied = _walk_commit(
        chain_id, vals, commit, voting_power_needed, ignore_sig,
        count_sig, count_all_signatures, look_up_by_index, cache,
        strict=False, handle=handle)

    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(tallied, voting_power_needed)

    if not entries:
        return  # everything was cached

    ok, valid_sigs = bv.verify()
    if ok:
        if cache is not None:
            for idx, addr, sign_bytes in entries:
                cache.add(commit.signatures[idx].signature,
                          SignatureCacheValue(addr, sign_bytes))
        return

    # find and report the first invalid signature
    for sig_ok, (idx, addr, sign_bytes) in zip(valid_sigs, entries):
        sig = commit.signatures[idx]
        if not sig_ok:
            raise VerificationError(
                f"wrong signature (#{idx}): {sig.signature.hex().upper()}")
        if cache is not None:
            cache.add(sig.signature,
                      SignatureCacheValue(addr, sign_bytes))
    raise VerificationError(
        "BUG: batch verification failed with no invalid signatures")


def _verify_commit_single(
        chain_id: str, vals: ValidatorSet, commit: Commit,
        voting_power_needed: int,
        ignore_sig: Callable[[CommitSig], bool],
        count_sig: Callable[[CommitSig], bool],
        count_all_signatures: bool, look_up_by_index: bool,
        cache: Optional[SignatureCache]) -> None:
    """Reference: verifyCommitSingle (:413)."""

    def handle(idx, val, sign_bytes, commit_sig):
        if not val.pub_key.verify_signature(sign_bytes,
                                            commit_sig.signature):
            raise VerificationError(
                f"wrong signature (#{idx}): "
                f"{commit_sig.signature.hex().upper()}")
        if cache is not None:
            cache.add(commit_sig.signature, SignatureCacheValue(
                val.pub_key.address(), sign_bytes))

    tallied = _walk_commit(
        chain_id, vals, commit, voting_power_needed, ignore_sig,
        count_sig, count_all_signatures, look_up_by_index, cache,
        strict=True, handle=handle)

    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(tallied, voting_power_needed)
