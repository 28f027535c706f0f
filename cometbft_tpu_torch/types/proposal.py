"""Block proposal.

Reference: types/proposal.go — Proposal with POLRound (-1 when no
proof-of-lock), canonical sign-bytes, timely check for PBTS — through
cometbft_tpu/types/proposal.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import canonical
from .block_id import BlockID
from .vote import MAX_SIGNATURE_SIZE
from .part_set import PartSetError
from .timestamp import Timestamp


class ProposalError(Exception):
    pass


@dataclass
class Proposal:
    type: int = canonical.PROPOSAL_TYPE
    height: int = 0
    round: int = 0
    pol_round: int = -1
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Timestamp = field(default_factory=Timestamp.zero)
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id, self.height, self.round, self.pol_round,
            self.block_id, self.timestamp)

    def validate_basic(self) -> None:
        """Reference: proposal.go ValidateBasic."""
        if self.type != canonical.PROPOSAL_TYPE:
            raise ProposalError("invalid type")
        if self.height <= 0:
            raise ProposalError("height must be positive")
        if self.round < 0:
            raise ProposalError("negative round")
        if self.pol_round < -1 or (self.pol_round >= self.round and
                                   self.pol_round != -1):
            raise ProposalError(
                "POLRound must be -1 or in [0, round)")
        try:
            self.block_id.validate_basic()
        except PartSetError as e:
            raise ProposalError(f"wrong BlockID: {e}") from e
        if not self.block_id.is_complete():
            raise ProposalError("expected a complete, non-empty BlockID")
        if not self.signature:
            raise ProposalError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ProposalError("signature is too big")

    def is_timely(self, recv_time: Timestamp, sp) -> bool:
        """PBTS timely check (reference: proposal.go IsTimely):
        proposal time within [recv - precision, recv + delay + precision].
        sp is SynchronyParams (already adapted to the round)."""
        lhs = self.timestamp.unix_ns() - sp.precision_ns
        rhs = self.timestamp.unix_ns() + sp.message_delay_ns + \
            sp.precision_ns
        return lhs <= recv_time.unix_ns() <= rhs

    def to_proto(self) -> dict:
        d: dict = {
            "type": self.type,
            "block_id": self.block_id.to_proto(),
            "timestamp": self.timestamp.to_proto(),
        }
        if self.height:
            d["height"] = self.height
        if self.round:
            d["round"] = self.round
        if self.pol_round:
            d["pol_round"] = self.pol_round
        if self.signature:
            d["signature"] = self.signature
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "Proposal":
        return cls(
            type=d.get("type", 0),
            height=d.get("height", 0),
            round=d.get("round", 0),
            pol_round=d.get("pol_round", 0),
            block_id=BlockID.from_proto(d.get("block_id") or {}),
            timestamp=Timestamp.from_proto(d.get("timestamp") or {}),
            signature=d.get("signature", b""),
        )

    def __str__(self) -> str:
        return (f"Proposal{{{self.height}/{self.round} "
                f"({self.block_id}, -1:{self.pol_round}) "
                f"{self.timestamp.rfc3339()}}}")
