"""RFC-6962-style binary merkle root with domain-separated hashing.

Reference: crypto/merkle/tree.go (HashFromByteSlices, leaf/inner
prefixes, getSplitPoint), through cometbft_tpu/crypto/merkle.py:17-63.
The plain hashlib recursion only: the reference's native shortcut is
left out.  Proofs are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

from .tmhash import sum as _sha256

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def empty_hash() -> bytes:
    return _sha256(b"")


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (reference: tree.go:89)."""
    if n < 1:
        raise ValueError("n must be >= 1")
    b = 1 << (n.bit_length() - 1)
    return b // 2 if b == n else b


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """Merkle root of items (reference: crypto/merkle/tree.go:11)."""
    n = len(items)
    if n == 0:
        return empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]),
                      hash_from_byte_slices(items[k:]))
