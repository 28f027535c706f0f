"""Vote: a prevote or precommit, optionally carrying vote extensions; the
verified-signature memo and the burst pre-verification that fills it.

Reference: types/vote.go — the Vote struct (:66-81), Verify /
VerifyWithExtension / VerifyExtension (:247,256,281), ValidateBasic, the
extension caps — through cometbft_tpu/types/vote.py (:1-368), whose
memo of verified and rejected (pubkey, message, signature) triples and
``preverify_signatures`` / ``preverify_signatures_async`` (:38-156) are
ported with the same bounds (8,192 and 4,096 entries, LRU) and the same
keys.

One departure, on purpose: ``preverify_signatures`` batches through
crypto/batch.batch_verify_by_type, which raises where a kernel fails to
build or launch or the BLS library fails, instead of turning that into
"verify it yourself" as the JAX package does.  The port has no silent
fallback from the card to the host.  Entries a batch verifier refuses
one by one (an unsupported key type, a wrong signature length) and
groups of one are still left to the caller's serial path.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field, replace

from ..crypto import batch as crypto_batch
from ..crypto import pipeline
from ..crypto.keys import PubKey
from . import canonical
from .block_id import BlockID
from .part_set import PartSetError
from .timestamp import Timestamp

# max(ed25519=64, bls12_381=96); reference: types/signable.go:13
MAX_SIGNATURE_SIZE = 96

# reference: types/vote.go:20 — 1 MiB cap on any single extension
MAX_VOTE_EXTENSION_SIZE = 1024 * 1024

# BlockIDFlag (proto/cometbft/types/v2/validator.proto)
BLOCK_ID_FLAG_UNKNOWN = 0
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


class VoteError(Exception):
    pass


class InvalidSignatureError(VoteError):
    pass


# --- the verified / rejected triple memos -----------------------------------
# A valid (pubkey, message, signature) triple is valid forever and a
# rejected one invalid forever, so both verdicts are kept, each in a
# bounded LRU.  The burst pre-verification fills them and the serial
# tally (VoteSet.add_vote -> Vote.verify -> checked_verify) reads them,
# in unchanged order.

_VERIFIED: "OrderedDict[tuple[bytes, bytes, bytes], None]" = OrderedDict()
_VERIFIED_MAX = 8192
_REJECTED: "OrderedDict[tuple[bytes, bytes, bytes], None]" = OrderedDict()
_REJECTED_MAX = 4096


def _memo_key(pub_key: PubKey, msg: bytes,
              sig: bytes) -> tuple[bytes, bytes, bytes]:
    # the message is hashed into the key: extension sign bytes can be
    # ~1 MiB, and a digest bounds every entry to ~130 bytes
    return (pub_key.bytes(), hashlib.sha256(msg).digest(), bytes(sig))


def _memo_add(key: tuple[bytes, bytes, bytes]) -> None:
    _VERIFIED[key] = None
    if len(_VERIFIED) > _VERIFIED_MAX:
        _VERIFIED.popitem(last=False)


def _memo_reject(key: tuple[bytes, bytes, bytes]) -> None:
    _REJECTED[key] = None
    if len(_REJECTED) > _REJECTED_MAX:
        _REJECTED.popitem(last=False)


def checked_verify(pub_key: PubKey, msg: bytes, sig: bytes) -> bool:
    """pub_key.verify_signature with the verified/rejected memos."""
    key = _memo_key(pub_key, msg, sig)
    if key in _VERIFIED:
        _VERIFIED.move_to_end(key)
        return True
    if key in _REJECTED:
        _REJECTED.move_to_end(key)
        return False
    ok = pub_key.verify_signature(msg, sig)
    if ok:
        _memo_add(key)
    else:
        _memo_reject(key)
    return ok


def preverify_signatures(entries, device=None) -> None:
    """Batch-verify (pub_key, msg, sig) triples and memoise both
    verdicts.  Triples already in either memo are skipped, and nothing
    is batched below two fresh triples.  Entries the batch could not
    judge (None: an unsupported key type, a malformed signature, a
    group of one) are left for the caller's serial path.  A False
    verdict is confirmed by one serial verify before it enters the
    negative memo, so the serial verifier keeps the final say.  A
    kernel or BLS library failure raises."""
    fresh = []
    keys = []
    for pub_key, msg, sig in entries:
        key = _memo_key(pub_key, msg, sig)
        if key in _VERIFIED or key in _REJECTED:
            continue
        fresh.append((pub_key, msg, sig))
        keys.append(key)
    if len(fresh) < 2:
        return
    mask = crypto_batch.batch_verify_by_type(fresh, device=device)
    for (pub_key, msg, sig), key, good in zip(fresh, keys, mask):
        if good:
            _memo_add(key)
        elif good is not None:
            if pub_key.verify_signature(msg, sig):
                _memo_add(key)           # batch false negative fixed
            else:
                _memo_reject(key)


def preverify_signatures_async(entries, device=None):
    """``preverify_signatures`` on the verification staging worker
    (crypto/pipeline.submit): a concurrent Future that resolves to None
    once the verdicts are memoised, or raises what the batch raised.
    The kernel runs on the worker's thread, on the pipeline's side
    stream of the device.  Memo reads and writes are single dict
    operations, atomic under the GIL, so the worker and a serial
    ``checked_verify`` on the event loop interleave safely."""
    return pipeline.submit(preverify_signatures, entries, device)


@dataclass
class Vote:
    type: int = canonical.UNKNOWN_TYPE
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    validator_address: bytes = b""
    validator_index: int = 0
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""
    non_rp_extension: bytes = b""
    non_rp_extension_signature: bytes = b""

    # ------------------------------------------------------------------
    def sign_bytes(self, chain_id: str) -> bytes:
        # memoised on the full signed-field tuple, so a later change of
        # any signed field (a re-signed timestamp) misses the memo
        # instead of returning stale bytes; the signature and the
        # extensions are not signed over
        key = (chain_id, self.type, self.height, self.round,
               self.block_id, self.timestamp)
        cache = self.__dict__.get("_sb_memo")
        if cache is not None and cache[0] == key:
            return cache[1]
        sb = canonical.vote_sign_bytes(
            chain_id, self.type, self.height, self.round, self.block_id,
            self.timestamp)
        self.__dict__["_sb_memo"] = (key, sb)
        return sb

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_extension_sign_bytes(
            chain_id, self.height, self.round, self.extension)

    def non_rp_extension_sign_bytes(self) -> bytes:
        """Reference: vote.go VoteExtensionSignBytes (:173-183) — the
        non-replay-protected extension signs its raw bytes."""
        return self.non_rp_extension

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    # ------------------------------------------------------------------
    def _verify_vote_sig(self, chain_id: str, pub_key: PubKey) -> None:
        if pub_key.address() != self.validator_address:
            raise InvalidSignatureError(
                "vote validator address does not match pubkey")
        if not checked_verify(pub_key, self.sign_bytes(chain_id),
                              self.signature):
            raise InvalidSignatureError("invalid vote signature")

    def verify(self, chain_id: str, pub_key: PubKey) -> None:
        """Reference: vote.go Verify — vote signature only."""
        self._verify_vote_sig(chain_id, pub_key)

    def verify_vote_and_extension(self, chain_id: str,
                                  pub_key: PubKey) -> None:
        """Reference: vote.go VerifyVoteAndExtension — for precommits on a
        block, the extension signatures too."""
        self._verify_vote_sig(chain_id, pub_key)
        if (self.type == canonical.PRECOMMIT_TYPE and
                not self.block_id.is_nil()):
            self.verify_extension(chain_id, pub_key)

    def verify_extension(self, chain_id: str, pub_key: PubKey) -> None:
        """Reference: vote.go VerifyExtension (:280-299) — both the
        replay-protected and the non-RP extension signatures are required
        and checked for non-nil precommits."""
        if self.type != canonical.PRECOMMIT_TYPE or self.block_id.is_nil():
            return
        if not self.extension_signature or \
                not self.non_rp_extension_signature:
            raise InvalidSignatureError("vote extension signature missing")
        if not checked_verify(pub_key,
                              self.extension_sign_bytes(chain_id),
                              self.extension_signature):
            raise InvalidSignatureError("invalid vote extension signature")
        if not checked_verify(pub_key,
                              self.non_rp_extension_sign_bytes(),
                              self.non_rp_extension_signature):
            raise InvalidSignatureError(
                "invalid non-RP vote extension signature")

    # ------------------------------------------------------------------
    def validate_basic(self) -> None:
        """Reference: vote.go ValidateBasic."""
        if not canonical.is_vote_type_valid(self.type):
            raise VoteError(f"invalid vote type {self.type}")
        if self.height <= 0:
            raise VoteError("vote height must be positive")
        if self.round < 0:
            raise VoteError("vote round must be non-negative")
        try:
            self.block_id.validate_basic()
        except PartSetError as e:
            raise VoteError(f"wrong BlockID: {e}") from e
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise VoteError("BlockID must be either empty or complete")
        if len(self.validator_address) != 20:
            raise VoteError("wrong validator address size")
        if self.validator_index < 0:
            raise VoteError("negative validator index")
        if len(self.signature) == 0:
            raise VoteError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise VoteError("signature is too big")
        if self.type == canonical.PRECOMMIT_TYPE and \
                not self.block_id.is_nil():
            if len(self.extension) > MAX_VOTE_EXTENSION_SIZE:
                raise VoteError("vote extension too big")
            if self.extension and not self.extension_signature:
                raise VoteError("vote extension signature is missing")
            if len(self.non_rp_extension) > MAX_VOTE_EXTENSION_SIZE:
                raise VoteError("non-RP vote extension too big")
            if len(self.non_rp_extension_signature) > MAX_SIGNATURE_SIZE:
                raise VoteError("non-RP extension signature is too big")
            if self.non_rp_extension and \
                    not self.non_rp_extension_signature:
                raise VoteError("non-RP extension signature is missing")
            # reference vote.go:385 — both extension signatures or neither
            if bool(self.extension_signature) != \
                    bool(self.non_rp_extension_signature):
                raise VoteError(
                    "extension signatures must both be present or absent")
        else:
            # extensions only on non-nil precommits
            if self.extension or self.extension_signature or \
                    self.non_rp_extension or self.non_rp_extension_signature:
                raise VoteError(
                    "unexpected vote extension on non-precommit vote")

    # ------------------------------------------------------------------
    def commit_sig(self) -> dict:
        """CommitSig view of this vote (reference: vote.go CommitSig)."""
        if self.block_id.is_nil():
            flag = BLOCK_ID_FLAG_NIL
        else:
            flag = BLOCK_ID_FLAG_COMMIT
        return {
            "block_id_flag": flag,
            "validator_address": self.validator_address,
            "timestamp": self.timestamp,
            "signature": self.signature,
        }

    def to_proto(self) -> dict:
        d: dict = {
            "block_id": self.block_id.to_proto(),
            "timestamp": self.timestamp.to_proto(),
        }
        if self.type:
            d["type"] = self.type
        if self.height:
            d["height"] = self.height
        if self.round:
            d["round"] = self.round
        if self.validator_address:
            d["validator_address"] = self.validator_address
        if self.validator_index:
            d["validator_index"] = self.validator_index
        if self.signature:
            d["signature"] = self.signature
        if self.extension:
            d["extension"] = self.extension
        if self.extension_signature:
            d["extension_signature"] = self.extension_signature
        if self.non_rp_extension:
            d["non_rp_extension"] = self.non_rp_extension
        if self.non_rp_extension_signature:
            d["non_rp_extension_signature"] = self.non_rp_extension_signature
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "Vote":
        return cls(
            type=d.get("type", 0),
            height=d.get("height", 0),
            round=d.get("round", 0),
            block_id=BlockID.from_proto(d.get("block_id") or {}),
            timestamp=Timestamp.from_proto(d.get("timestamp") or {}),
            validator_address=d.get("validator_address", b""),
            validator_index=d.get("validator_index", 0),
            signature=d.get("signature", b""),
            extension=d.get("extension", b""),
            extension_signature=d.get("extension_signature", b""),
            non_rp_extension=d.get("non_rp_extension", b""),
            non_rp_extension_signature=d.get(
                "non_rp_extension_signature", b""),
        )

    def copy(self) -> "Vote":
        # replace() builds a new object from the fields alone: the sign
        # bytes memo is not carried across
        return replace(self)

    def __str__(self) -> str:
        tname = {1: "Prevote", 2: "Precommit"}.get(self.type, "?")
        return (f"Vote{{{self.validator_index}:"
                f"{self.validator_address.hex().upper()[:12]} "
                f"{self.height}/{self.round:02d} {tname} "
                f"{self.block_id}}}")
