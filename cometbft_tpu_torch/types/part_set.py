"""Block part sets: blocks split into 64 KiB parts for gossip and
storage.

Reference: types/part_set.go — BlockPartSizeBytes, Part with its merkle
proof, PartSetHeader, PartSet accumulation — through
cometbft_tpu/types/part_set.py:50-166.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..crypto import merkle, tmhash

BLOCK_PART_SIZE = 65536  # reference: types/part_set.go BlockPartSizeBytes


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


@dataclass(frozen=True)
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if len(self.bytes_) > BLOCK_PART_SIZE:
            raise PartSetError(f"part oversized: {len(self.bytes_)}")
        if self.proof.index != self.index:
            raise PartSetError("part proof index mismatch")

    def to_proto(self) -> dict:
        return {
            "index": self.index,
            "bytes": self.bytes_,
            "proof": {
                "total": self.proof.total,
                "index": self.proof.index,
                "leaf_hash": self.proof.leaf_hash,
                "aunts": list(self.proof.aunts),
            },
        }

    @classmethod
    def from_proto(cls, d: dict) -> "Part":
        p = d.get("proof") or {}
        return cls(
            index=d.get("index", 0),
            bytes_=d.get("bytes", b""),
            proof=merkle.Proof(
                total=p.get("total", 0), index=p.get("index", 0),
                leaf_hash=p.get("leaf_hash", b""),
                aunts=list(p.get("aunts", []))),
        )


class PartSet:
    """Accumulates parts of one block; complete when all present."""

    def __init__(self, header: PartSetHeader):
        self._header = header
        self._parts: list[Part | None] = [None] * header.total
        self._count = 0
        self._byte_size = 0

    @classmethod
    def from_data(cls, data: bytes,
                  part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        chunks = [data[i:i + part_size]
                  for i in range(0, len(data), part_size)] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, (chunk, proof) in enumerate(zip(chunks, proofs)):
            part = Part(index=i, bytes_=chunk, proof=proof)
            ps._parts[i] = part
            ps._count += 1
            ps._byte_size += len(chunk)
        return ps

    def header(self) -> PartSetHeader:
        return self._header

    def has_header(self, h: PartSetHeader) -> bool:
        return self._header == h

    @property
    def total(self) -> int:
        return self._header.total

    @property
    def count(self) -> int:
        return self._count

    @property
    def byte_size(self) -> int:
        return self._byte_size

    def is_complete(self) -> bool:
        return self._count == self._header.total and self._header.total > 0

    def has_part(self, index: int) -> bool:
        return 0 <= index < len(self._parts) and \
            self._parts[index] is not None

    def bit_array(self) -> list[bool]:
        return [p is not None for p in self._parts]

    def add_part(self, part: Part) -> bool:
        """Add a verified part; returns False if duplicate.

        Raises PartSetError on invalid index or merkle proof mismatch
        (reference: part_set.go AddPart).
        """
        if part.index >= self._header.total:
            raise PartSetError(
                f"part index {part.index} >= total {self._header.total}")
        if self._parts[part.index] is not None:
            return False
        part.validate_basic()
        leaf = merkle.leaf_hash(part.bytes_)
        if part.proof.leaf_hash != leaf:
            raise PartSetError("part leaf hash mismatch")
        part.proof.verify(self._header.hash, part.bytes_)
        self._parts[part.index] = part
        self._count += 1
        self._byte_size += len(part.bytes_)
        return True

    def get_part(self, index: int) -> Part | None:
        if 0 <= index < len(self._parts):
            return self._parts[index]
        return None

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise PartSetError("part set incomplete")
        return b"".join(p.bytes_ for p in self._parts)  # type: ignore
