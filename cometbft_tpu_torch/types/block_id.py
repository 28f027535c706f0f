"""BlockID: a block's hash plus its part-set header.

Reference: types/block.go BlockID (IsNil/IsComplete/ValidateBasic, Key).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import tmhash
from .part_set import PartSetError, PartSetHeader


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (len(self.hash) == tmhash.SIZE and
                self.part_set_header.total > 0 and
                len(self.part_set_header.hash) == tmhash.SIZE)

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise PartSetError(f"wrong BlockID hash size {len(self.hash)}")
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Map key uniquely identifying this BlockID."""
        return (self.hash + self.part_set_header.total.to_bytes(4, "big") +
                self.part_set_header.hash)

    def to_proto(self) -> dict:
        d: dict = {"part_set_header": self.part_set_header.to_proto()}
        if self.hash:
            d["hash"] = self.hash
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "BlockID":
        return cls(
            hash=d.get("hash", b""),
            part_set_header=PartSetHeader.from_proto(
                d.get("part_set_header") or {}),
        )

    def __str__(self) -> str:
        if self.is_nil():
            return "nil-BlockID"
        return f"{self.hash.hex().upper()[:12]}:{self.part_set_header}"
