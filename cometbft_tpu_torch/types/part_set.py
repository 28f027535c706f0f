"""PartSetHeader: the part count and merkle root of a block's parts.

Reference: types/part_set.go.  Only the header travels in the slice the
port covers (inside BlockID); part sets themselves are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..crypto import tmhash


class PartSetError(Exception):
    pass


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise PartSetError(
                f"wrong PartSetHeader hash size {len(self.hash)}")

    def to_proto(self) -> dict:
        d: dict = {}
        if self.total:
            d["total"] = self.total
        if self.hash:
            d["hash"] = self.hash
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "PartSetHeader":
        return cls(total=d.get("total", 0), hash=d.get("hash", b""))

    def __str__(self) -> str:
        return f"{self.total}:{self.hash.hex().upper()[:12]}"
