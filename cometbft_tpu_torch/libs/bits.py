"""BitArray: the aggregate commit's signer bitmap and a vote set's
record of who voted.

Reference: internal/bits/bit_array.go, through cometbft_tpu/libs/bits.py
— a fixed-size bit array with set/get, copy, the set operations
(or, not, sub), the true indices, random picking (vote gossip), the
text form, the canonical little-endian packing and the proto form.
"""
from __future__ import annotations

import random
from typing import Optional


# bit positions set in each byte value (true_indices fast path)
_BYTE_BITS = tuple(tuple(i for i in range(8) if b >> i & 1)
                   for b in range(256))


class BitArray:
    __slots__ = ("bits", "_elems")

    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bits")
        self.bits = bits
        self._elems = 0  # int bitmap, bit i == index i

    @classmethod
    def from_indices(cls, bits: int, indices) -> "BitArray":
        ba = cls(bits)
        for i in indices:
            ba.set_index(i, True)
        return ba

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        return bool((self._elems >> i) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        if v:
            self._elems |= (1 << i)
        else:
            self._elems &= ~(1 << i)
        return True

    def copy(self) -> "BitArray":
        ba = BitArray(self.bits)
        ba._elems = self._elems
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
        """Union; result size is the larger (reference: Or)."""
        ba = BitArray(max(self.bits, other.bits))
        ba._elems = self._elems | other._elems
        return ba

    def and_(self, other: "BitArray") -> "BitArray":
        """Intersection; result size is the smaller (reference: And)."""
        ba = BitArray(min(self.bits, other.bits))
        mask = (1 << ba.bits) - 1
        ba._elems = self._elems & other._elems & mask
        return ba

    def not_(self) -> "BitArray":
        ba = BitArray(self.bits)
        ba._elems = ~self._elems & ((1 << self.bits) - 1)
        return ba

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (reference: Sub)."""
        ba = BitArray(self.bits)
        mask = (1 << self.bits) - 1
        ba._elems = self._elems & ~(other._elems) & mask
        return ba

    def is_empty(self) -> bool:
        return self._elems == 0

    def is_full(self) -> bool:
        return self.bits > 0 and self._elems == (1 << self.bits) - 1

    def true_indices(self) -> list[int]:
        # one to_bytes + per-byte table walk: the bit-shift and
        # lowest-set-bit loops are both O(bits^2/64) on big dense
        # ints (every shift/xor rewrites the whole bignum) —
        # aggregate-commit bitmaps hit this at 10k validators per
        # verification
        e = self._elems
        if not e:
            return []
        out: list[int] = []
        for base, byte in enumerate(
                e.to_bytes((self.bits + 7) // 8, "little")):
            if byte:
                start = base * 8
                out.extend(start + i for i in _BYTE_BITS[byte])
        return out

    def popcount(self) -> int:
        return bin(self._elems).count("1")

    def highest_true_index(self) -> int:
        """Index of the highest set bit, or -1 when empty."""
        return self._elems.bit_length() - 1

    def pick_random(self) -> Optional[int]:
        """A uniformly random true index, or None (reference: PickRandom)."""
        idxs = self.true_indices()
        if not idxs:
            return None
        return random.choice(idxs)

    def update(self, other: "BitArray") -> None:
        """Copy other's bits into self (reference: Update)."""
        mask = (1 << self.bits) - 1
        self._elems = other._elems & mask

    def __eq__(self, other) -> bool:
        return (isinstance(other, BitArray) and self.bits == other.bits and
                self._elems == other._elems)

    def __str__(self) -> str:
        s = "".join("x" if self.get_index(i) else "_"
                    for i in range(self.bits))
        return f"BA{{{self.bits}:{s}}}"

    def to_le_bytes(self) -> bytes:
        """Canonical little-endian packing: (bits+7)//8 bytes, byte i
        bit j = index 8i+j, padding bits zero (the aggregate-commit
        signer-bitmap wire layout)."""
        return self._elems.to_bytes((self.bits + 7) // 8, "little")

    @classmethod
    def from_le_bytes(cls, raw: bytes, bits: int) -> "BitArray":
        """Inverse of to_le_bytes; rejects non-canonical input (wrong
        length or padding bits set) so two wire encodings can never
        decode to one value."""
        if bits < 0:
            raise ValueError("negative bits")
        if len(raw) != (bits + 7) // 8:
            raise ValueError(
                f"bitmap length {len(raw)} != canonical "
                f"{(bits + 7) // 8} for {bits} bits")
        elems = int.from_bytes(raw, "little")
        if elems >> bits:
            raise ValueError("bitmap has padding bits set")
        ba = cls(bits)
        ba._elems = elems
        return ba

    def to_proto(self) -> dict:
        # libs/bits proto: {bits: int64, elems: repeated uint64}
        elems = []
        e = self._elems
        for _ in range((self.bits + 63) // 64):
            elems.append(e & ((1 << 64) - 1))
            e >>= 64
        d: dict = {}
        if self.bits:
            d["bits"] = self.bits
        if elems:
            d["elems"] = elems
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "BitArray":
        ba = cls(d.get("bits", 0))
        e = 0
        for i, w in enumerate(d.get("elems", [])):
            e |= w << (64 * i)
        ba._elems = e & ((1 << ba.bits) - 1) if ba.bits else 0
        return ba
