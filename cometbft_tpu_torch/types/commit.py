"""Commit and AggregateCommit: the evidence a block was committed.

Reference: types/block.go:634-1300 — CommitSig (one slot per validator,
flag Absent/Commit/Nil) and VoteSignBytes reconstruction — and
cometbft_tpu/types/commit.py:230-360 for AggregateCommit (one BLS
signature and a signer bitmap).  Hashing, median time and extended
commits are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..libs.bits import BitArray
from .block_id import BlockID
from .timestamp import Timestamp
from .vote import (
    BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL,
    MAX_SIGNATURE_SIZE,
)
from . import canonical


_VALID_FLAGS = (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT,
                BLOCK_ID_FLAG_NIL)


class CommitError(Exception):
    pass


@dataclass
class CommitSig:
    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        """Reference: NewCommitSigAbsent — validator did not sign."""
        return cls(block_id_flag=BLOCK_ID_FLAG_ABSENT,
                   timestamp=Timestamp.zero())

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig signed over (reference: CommitSig.BlockID)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        if self.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            return BlockID()
        raise CommitError(f"unknown BlockIDFlag {self.block_id_flag}")

    def validate_basic(self) -> None:
        if self.block_id_flag not in _VALID_FLAGS:
            raise CommitError(f"unknown BlockIDFlag {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise CommitError("validator address is present")
            if not (self.timestamp == Timestamp(0, 0) or
                    self.timestamp.is_zero()):
                raise CommitError("time is present")
            if self.signature:
                raise CommitError("signature is present")
        else:
            if len(self.validator_address) != 20:
                raise CommitError("wrong validator address size")
            if not self.signature:
                raise CommitError("signature is missing")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise CommitError("signature is too big")

    def to_proto(self) -> dict:
        d: dict = {"timestamp": self.timestamp.to_proto()}
        if self.block_id_flag:
            d["block_id_flag"] = self.block_id_flag
        if self.validator_address:
            d["validator_address"] = self.validator_address
        if self.signature:
            d["signature"] = self.signature
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "CommitSig":
        return cls(
            block_id_flag=d.get("block_id_flag", 0),
            validator_address=d.get("validator_address", b""),
            timestamp=Timestamp.from_proto(d.get("timestamp") or {}),
            signature=d.get("signature", b""),
        )


@dataclass
class Commit:
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: list[CommitSig] = field(default_factory=list)

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Canonical signed bytes of validator val_idx's vote.

        A commit's votes share every signed field except the
        timestamp (and the block-id variant selected by the flag), so
        the canonical marshal runs once per (chain id, flag) and each
        vote splices its timestamp.  The memo assumes commits are not
        mutated in place after first use (the timestamp and flag are
        part of the lookup; replacing a whole CommitSig is safe).

        Reference: block.go VoteSignBytes (:921)."""
        cs = self.signatures[val_idx]
        tmpls = self.__dict__.setdefault("_vsb_tmpls", {})
        key = (chain_id, cs.block_id_flag)
        make = tmpls.get(key)
        if make is None:
            make = canonical.vote_sign_bytes_template(
                chain_id, canonical.PRECOMMIT_TYPE, self.height,
                self.round, cs.block_id(self.block_id))
            tmpls[key] = make
        return make(cs.timestamp)

    def to_proto(self) -> dict:
        d: dict = {"block_id": self.block_id.to_proto(),
                   "signatures": [cs.to_proto() for cs in self.signatures]}
        if self.height:
            d["height"] = self.height
        if self.round:
            d["round"] = self.round
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "Commit":
        return cls(
            height=d.get("height", 0),
            round=d.get("round", 0),
            block_id=BlockID.from_proto(d.get("block_id") or {}),
            signatures=[CommitSig.from_proto(s)
                        for s in d.get("signatures", [])],
        )


@dataclass
class AggregateCommit:
    """One BLS signature + a signer bitmap for a whole commit.

    Every precommit FOR the block signs the same canonical message —
    the zero-timestamp canonical precommit over (chain_id, height,
    round, block_id) — so the signatures sum in G2 and verification is
    one 2-Miller-loop pairing check however many validators signed.
    Bit i of ``signers`` means validator index i (in the height's
    validator set) precommitted the block; nil and absent precommits
    are unset."""
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signers: BitArray = field(default_factory=lambda: BitArray(0))
    signature: bytes = b""

    BLS_SIGNATURE_SIZE = 96

    def size(self) -> int:
        """Validator slots covered (= validator-set size), matching
        Commit.size() so shared size checks work on either kind."""
        return self.signers.size()

    def signed_indices(self) -> list[int]:
        return self.signers.true_indices()

    def signers_bytes(self) -> bytes:
        """Canonical wire form of the bitmap: little-endian packed,
        (size+7)//8 bytes, padding bits zero."""
        return self.signers.to_le_bytes()

    def vote_sign_bytes(self, chain_id: str) -> bytes:
        """THE message every aggregated precommit signed: the canonical
        precommit with the zero timestamp."""
        return canonical.vote_sign_bytes(
            chain_id, canonical.PRECOMMIT_TYPE, self.height, self.round,
            self.block_id, Timestamp.zero())

    def validate_basic(self) -> None:
        if self.height < 0:
            raise CommitError("negative Height")
        if self.round < 0:
            raise CommitError("negative Round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise CommitError(
                    "aggregate commit cannot be for nil block")
            if self.signers.size() == 0:
                raise CommitError("no validator slots in "
                                  "aggregate commit")
            if self.signers.is_empty():
                raise CommitError("no signers in aggregate commit")
            if len(self.signature) != self.BLS_SIGNATURE_SIZE:
                raise CommitError(
                    f"aggregate signature must be "
                    f"{self.BLS_SIGNATURE_SIZE} bytes, "
                    f"got {len(self.signature)}")

    def to_proto(self) -> dict:
        d: dict = {"block_id": self.block_id.to_proto()}
        if self.height:
            d["height"] = self.height
        if self.round:
            d["round"] = self.round
        if self.signers.size():
            d["signer_count"] = self.signers.size()
        sb = self.signers_bytes()
        if sb:
            d["signers"] = sb
        if self.signature:
            d["signature"] = self.signature
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "AggregateCommit":
        count = d.get("signer_count", 0)
        try:
            ba = BitArray.from_le_bytes(d.get("signers", b""), count)
        except ValueError as e:
            raise CommitError(f"signer bitmap: {e}") from None
        return cls(
            height=d.get("height", 0),
            round=d.get("round", 0),
            block_id=BlockID.from_proto(d.get("block_id") or {}),
            signers=ba,
            signature=d.get("signature", b""),
        )
