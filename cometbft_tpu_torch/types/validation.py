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

Each entry point has the reference's four arms (validation.py:161-296):
  * an AggregateCommit takes the O(1) pairing path
    (_verify_aggregate_commit: one G1 key sum, memoised per set hash and
    bitmap, and one 2-pairing check in the host BLS library);
  * a same-type batchable set defers every signature into crypto/batch's
    verifier: ed25519 to the kernel, one launch per tile on the card
    (``device=None``) or the kernel's plain version on ``device="cpu"``;
    bls12_381 to the host RLC verifier;
  * a mixed set with a batchable pair takes the grouped path: the
    ed25519 group on the kernel as above, the BLS group on the host,
    secp256k1 and secp256k1eth verified inline, and the lowest failing
    index reported;
  * anything else is verified one signature at a time.
Each verification is timed into ``consensus_commit_verify_seconds`` by
its kind: ``aggregate``, ``batch``, ``grouped`` or ``single``
(reference: validation.py:42-80).
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

from ..crypto import batch as crypto_batch
from ..crypto import bls12381
from ..device import resolve
from ..libs import metrics as libmetrics
from ..libs.bits import BitArray
from .block_id import BlockID
from .commit import AggregateCommit, Commit, CommitError, CommitSig
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


def _should_group_verify(vals: ValidatorSet, commit: Commit) -> bool:
    """Mixed-key commits: batch per key-type group when any batchable
    type appears at least twice (reference: validation.py:108-126)."""
    if len(commit.signatures) < BATCH_VERIFY_THRESHOLD:
        return False
    counts: dict[str, int] = {}
    for val in vals.validators:
        if val.pub_key is None:
            continue
        if crypto_batch.supports_batch_verifier(val.pub_key):
            kt = val.pub_key.type()
            counts[kt] = counts.get(kt, 0) + 1
            if counts[kt] >= 2:
                return True
    return False


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


def _dispatch_aggregate(chain_id: str, vals: ValidatorSet,
                        block_id: BlockID, height: int,
                        commit: AggregateCommit,
                        cache: Optional[SignatureCache], device) -> None:
    """The O(1) arm shared by verify_commit and verify_commit_light:
    one aggregate signature covers every signer, so "all signatures"
    and "stop at 2/3" coincide (reference: validation.py:147-158)."""
    resolve(device)               # the same device rule; work is on the host
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    with _observe_kind("aggregate"):
        _verify_aggregate_commit(
            chain_id, vals, commit,
            vals.total_voting_power() * 2 // 3, cache=cache)


def _verify(chain_id, vals, commit, voting_power_needed, ignore, count,
            count_all_signatures, look_up_by_index, cache, device) -> None:
    device = resolve(device)      # the card unless the caller names one
    if _should_batch_verify(vals, commit):
        with _observe_kind("batch"):
            _verify_commit_batch(
                chain_id, vals, commit, voting_power_needed, ignore, count,
                count_all_signatures, look_up_by_index, cache, device)
    elif _should_group_verify(vals, commit):
        with _observe_kind("grouped"):
            _verify_commit_grouped(
                chain_id, vals, commit, voting_power_needed, ignore, count,
                count_all_signatures, look_up_by_index, cache, device)
    else:
        with _observe_kind("single"):
            _verify_commit_single(
                chain_id, vals, commit, voting_power_needed, ignore, count,
                count_all_signatures, look_up_by_index, cache)


def verify_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID,
                  height: int, commit: Commit | AggregateCommit,
                  cache: Optional[SignatureCache] = None,
                  device=None) -> None:
    """+2/3 signed; checks ALL signatures (reference: VerifyCommit :30).

    AggregateCommit commits take the O(1) pairing path."""
    if isinstance(commit, AggregateCommit):
        _dispatch_aggregate(chain_id, vals, block_id, height, commit,
                            cache, device)
        return
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
            lambda c: c.block_id_flag == BLOCK_ID_FLAG_ABSENT,
            lambda c: c.block_id_flag == BLOCK_ID_FLAG_COMMIT,
            count_all_signatures=True, look_up_by_index=True, cache=cache,
            device=device)


def verify_commit_light(chain_id: str, vals: ValidatorSet,
                        block_id: BlockID, height: int,
                        commit: Commit | AggregateCommit,
                        count_all_signatures: bool = False,
                        cache: Optional[SignatureCache] = None,
                        device=None) -> None:
    """Light-client variant: stops at 2/3 unless count_all_signatures.

    Reference: VerifyCommitLight / ...AllSignatures / ...WithCache (:65)."""
    if isinstance(commit, AggregateCommit):
        _dispatch_aggregate(chain_id, vals, block_id, height, commit,
                            cache, device)
        return
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
            lambda c: c.block_id_flag != BLOCK_ID_FLAG_COMMIT,
            lambda c: True, count_all_signatures=count_all_signatures,
            look_up_by_index=True, cache=cache, device=device)


def verify_commit_light_trusting(
        chain_id: str, vals: ValidatorSet,
        commit: Commit | AggregateCommit,
        trust_level: Fraction, count_all_signatures: bool = False,
        cache: Optional[SignatureCache] = None,
        signer_vals: Optional[ValidatorSet] = None, device=None) -> None:
    """trustLevel (e.g. 1/3) of a TRUSTED validator set signed; used for
    skipping verification.  Looks validators up by address since the sets
    need not correspond (reference: VerifyCommitLightTrusting :150).

    For an AggregateCommit the signer bitmap indexes the set that
    SIGNED the commit's height, which the caller passes as
    ``signer_vals``.  It maps bitmap indices to addresses only: the
    tally and the pairing use the TRUSTED set's keys for those
    addresses, and a signer outside the trusted set reports as
    not-enough-provable-power (reference: validation.py:232-296)."""
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
    if isinstance(commit, AggregateCommit):
        resolve(device)
        if signer_vals is None:
            raise VerificationError(
                "aggregate commit trusting verification needs the "
                "signing validator set")
        if signer_vals.size() != commit.size():
            raise VerificationError(
                f"invalid commit -- wrong set size: "
                f"{signer_vals.size()} vs {commit.size()}")
        with _observe_kind("aggregate"):
            _verify_aggregate_commit(
                chain_id, signer_vals, commit,
                product // trust_level.denominator, cache=cache,
                tally_vals=vals)
        return
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
    """The signature walk shared by the batch, grouped and single paths:
    ignore filter, optional structural validation, by-index or
    by-address validator lookup with double-vote detection, cache
    short-circuit, voting-power tally with the early exit.  Returns the
    tallied power.

    handle(idx, val, sign_bytes, commit_sig) is called for every
    signature the cache does not satisfy — it verifies inline (raising
    VerificationError) or defers into a batch verifier; returning False
    stops the walk (the grouped path reconciles an inline failure
    against its deferred groups, so the LOWEST failing index is named).

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
            if handle(idx, val, vote_sign_bytes, commit_sig) is False:
                break

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


def _verify_commit_grouped(
        chain_id: str, vals: ValidatorSet, commit: Commit,
        voting_power_needed: int,
        ignore_sig: Callable[[CommitSig], bool],
        count_sig: Callable[[CommitSig], bool],
        count_all_signatures: bool, look_up_by_index: bool,
        cache: Optional[SignatureCache], device) -> None:
    """Mixed-key commit verification with per-key-type batch groups
    (reference: validation.py:617-705).  Walk semantics match
    _verify_commit_single (strict structural checks, cache, early
    threshold exit); batchable signatures defer into one verifier per
    key type — ed25519 into the kernel on ``device``, bls12_381 into
    the host RLC verifier — and secp256k1 / secp256k1eth verify inline.
    Any invalid signature raises VerificationError naming the LOWEST
    failing commit index — an inline failure stops the walk and is
    reconciled against the deferred groups before reporting — and does
    so before the voting-power threshold is judged, as inline
    verification would."""
    # key type -> (verifier, [(idx, key address, sign bytes)])
    groups: dict[str, tuple] = {}
    inline_bad: Optional[int] = None

    def handle(idx, val, sign_bytes, commit_sig):
        nonlocal inline_bad
        if crypto_batch.supports_batch_verifier(val.pub_key):
            kt = val.pub_key.type()
            entry = groups.get(kt)
            if entry is None:
                entry = (crypto_batch.create_batch_verifier(
                    val.pub_key, device=device), [])
                groups[kt] = entry
            try:
                entry[0].add(val.pub_key, sign_bytes, commit_sig.signature)
            except (ValueError, TypeError):
                # malformed signature the structural checks let through
                # (e.g. wrong length): same verdict as a failed inline
                # verify, reconciled for the lowest index
                inline_bad = idx
                return False
            entry[1].append((idx, val.pub_key.address(), sign_bytes))
            return None
        if not val.pub_key.verify_signature(sign_bytes,
                                            commit_sig.signature):
            inline_bad = idx
            return False        # stop: reconcile vs deferred groups
        if cache is not None:
            cache.add(commit_sig.signature, SignatureCacheValue(
                val.pub_key.address(), sign_bytes))
        return None

    tallied = _walk_commit(
        chain_id, vals, commit, voting_power_needed, ignore_sig,
        count_sig, count_all_signatures, look_up_by_index, cache,
        strict=True, handle=handle)

    first_bad: Optional[int] = inline_bad
    for bv, entries in groups.values():
        if not entries:
            continue
        ok, valid_sigs = bv.verify()
        if ok:
            if cache is not None:
                for idx, addr, sign_bytes in entries:
                    cache.add(commit.signatures[idx].signature,
                              SignatureCacheValue(addr, sign_bytes))
            continue
        group_bad = [entries[i][0] for i, sig_ok in enumerate(valid_sigs)
                     if not sig_ok]
        if not group_bad:
            raise VerificationError(
                "BUG: batch verification failed with no invalid "
                "signatures")
        if cache is not None:
            bad_set = set(group_bad)
            for idx, addr, sign_bytes in entries:
                if idx not in bad_set:
                    cache.add(commit.signatures[idx].signature,
                              SignatureCacheValue(addr, sign_bytes))
        if first_bad is None or group_bad[0] < first_bad:
            first_bad = group_bad[0]
    if first_bad is not None:
        sig = commit.signatures[first_bad]
        raise VerificationError(
            f"wrong signature (#{first_bad}): "
            f"{sig.signature.hex().upper()}")

    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(tallied, voting_power_needed)


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


# ---------------------------------------------------------------------------
# aggregate-commit verification: O(1) pairing work in validator count

def _agg_memo_key(commit: AggregateCommit, valset_hash: bytes,
                  bitmap: bytes) -> bytes:
    """Verdict-memo key binding (block_id, valset, bitmap, signature);
    hashed so the shared SignatureCache stores 32-byte keys, prefixed
    so it can never collide with a raw signature key.  ``valset_hash``
    and ``bitmap`` describe the set the pubkeys were RESOLVED from — on
    the trusting path the trusted set and the bitmap re-indexed into
    it (reference: validation.py:303-318)."""
    h = hashlib.sha256()
    h.update(b"aggcommit/1\x00")
    h.update(valset_hash)
    h.update(commit.block_id.key())
    h.update(bitmap)
    h.update(commit.signature)
    return b"agg:" + h.digest()


# per-valset raw-pubkey table, keyed by valset hash, a small LRU: the G1
# point-sum consumes the keys' raw 96-byte serializations, and
# re-extracting them on every new signer bitmap costs more than the sum
_PK_RAWS: OrderedDict[bytes, Optional[tuple]] = OrderedDict()
_PK_RAWS_CAPACITY = 8


def _pubkey_raws(vals: ValidatorSet, valset_hash: bytes):
    """Tuple of 96-byte raw BLS pubkey serializations (valset order),
    or None when any validator key is not bls12_381 (reference:
    validation.py:329-353)."""
    if valset_hash in _PK_RAWS:
        _PK_RAWS.move_to_end(valset_hash)
        return _PK_RAWS[valset_hash]
    raws: Optional[list] = []
    for v in vals.validators:
        pk = v.pub_key
        if not isinstance(pk, bls12381.Bls12381PubKey):
            raws = None
            break
        raws.append(pk.bytes())
    entry = tuple(raws) if raws is not None else None
    _PK_RAWS[valset_hash] = entry
    if len(_PK_RAWS) > _PK_RAWS_CAPACITY:
        _PK_RAWS.popitem(last=False)
    return entry


def reset_aggregate_caches() -> None:
    """Empty the process-global raw-pubkey table and aggregate-pubkey
    cache (tests start each case from nothing)."""
    _PK_RAWS.clear()
    bls12381.reset_aggregate_pubkey_cache()


def _verify_aggregate_commit(
        chain_id: str, vals: ValidatorSet, commit: AggregateCommit,
        voting_power_needed: int,
        cache: Optional[SignatureCache] = None,
        tally_vals: Optional[ValidatorSet] = None) -> None:
    """One pairing check for the whole commit (reference:
    validation.py:356-476).

    ``vals`` is the set the signer bitmap indexes.  When ``tally_vals``
    is given (the trusting path's TRUSTED set) every signer is resolved
    through it BY ADDRESS: the tally and the key sum use the trusted
    set's entries, never the claimed keys in ``vals``, which a skipping
    hop cannot authenticate (a rogue key placed at a fabricated index
    could otherwise cancel the trusted keys).  A signer unknown to the
    trusted set means zero provable power.

    The G1 key sum — the only O(n) step — is memoised per (set hash,
    bitmap) in bls12381's AggregatePubKeyCache; the verdict is memoised
    in the SignatureCache keyed (block_id, set hash, bitmap,
    signature), both on the set the keys were RESOLVED from."""
    try:
        commit.validate_basic()
    except CommitError as e:
        raise VerificationError(f"invalid aggregate commit: {e}") from e

    top = commit.signers.highest_true_index()
    if top >= vals.size():
        raise VerificationError(
            f"signer bit {top} out of range for validator set "
            f"of {vals.size()}")

    # the tally is judged before the pairing, as the batch path judges
    # the threshold before its deferred verify
    if tally_vals is None:
        # complement walk: near-full bitmaps cost O(absent), not O(n)
        key_vals, key_bits = vals, commit.signers
        tallied = vals.total_voting_power()
        for i in commit.signers.not_().true_indices():
            tallied -= vals.validators[i].voting_power
    else:
        key_vals = tally_vals
        key_bits = BitArray(tally_vals.size())
        tallied = 0
        for i in commit.signed_indices():
            addr = vals.validators[i].address
            tidx = tally_vals.index_by_address(addr)
            if tidx < 0:
                raise NotEnoughVotingPowerError(0, voting_power_needed)
            if key_bits.get_index(tidx):
                raise VerificationError(
                    f"duplicate signer address {addr.hex().upper()} "
                    f"in aggregate commit signer set")
            key_bits.set_index(tidx, True)
            tallied += tally_vals.validators[tidx].voting_power
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(tallied, voting_power_needed)

    sign_bytes = commit.vote_sign_bytes(chain_id)
    valset_hash = key_vals.hash()
    bitmap = key_bits.to_le_bytes()

    memo_key = _agg_memo_key(commit, valset_hash, bitmap)
    if cache is not None:
        cv = cache.get(memo_key)
        if cv is not None and cv.vote_sign_bytes == sign_bytes:
            return

    def build():
        raws = _pubkey_raws(key_vals, valset_hash)
        if raws is None:
            raise VerificationError(
                "aggregate commits need a bls12_381 validator set")
        if key_bits.popcount() == len(raws):
            blob = b"".join(raws)
        else:
            blob = b"".join(raws[i] for i in key_bits.true_indices())
        return bls12381.aggregate_pub_keys_raw(blob)

    pk_cache = bls12381.aggregate_pubkey_cache()
    agg_pk = pk_cache.get(valset_hash, bitmap)
    fresh = agg_pk is None
    if fresh:
        agg_pk = build()

    if not bls12381.verify_aggregate(agg_pk, sign_bytes, commit.signature):
        raise VerificationError(
            f"wrong aggregate signature: "
            f"{commit.signature.hex().upper()[:24]}...")

    if fresh:
        # insert only after success: a forged-signature stream with
        # varying bitmaps must not evict the honest sums
        pk_cache.put(valset_hash, bitmap, agg_pk)
    if cache is not None:
        cache.add(memo_key, SignatureCacheValue(b"aggregate", sign_bytes))
