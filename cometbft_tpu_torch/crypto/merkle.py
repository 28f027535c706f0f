"""RFC-6962-style binary merkle root with domain-separated hashing, and
inclusion proofs.

Reference: crypto/merkle/tree.go (HashFromByteSlices, leaf/inner
prefixes, getSplitPoint) and proof.go (Proof, ProofsFromByteSlices),
through cometbft_tpu/crypto/merkle.py:17-135; the root over leaf hashes
the state tree keeps (:292) and the ValueOp leaf binding (:359).  The
plain hashlib recursion only: the reference's native shortcut is left
out.  Multiproofs and proof operators wait for the state tree's proofs
(ROADMAP A.7b').
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ..wire.proto import encode_uvarint
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


@dataclass
class Proof:
    """Merkle inclusion proof (reference: crypto/merkle/proof.go)."""
    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes] = field(default_factory=list)

    def verify(self, root: bytes, leaf: bytes) -> None:
        if self.total < 0:
            raise ValueError("proof total must be >= 0")
        if self.index < 0:
            raise ValueError("proof index must be >= 0")
        if leaf_hash(leaf) != self.leaf_hash:
            raise ValueError("invalid leaf hash")
        if self.compute_root_hash() != root:
            raise ValueError("invalid proof: root mismatch")

    def compute_root_hash(self) -> bytes:
        return _compute_from_aunts(self.index, self.total, self.leaf_hash,
                                   self.aunts)


def _compute_from_aunts(index: int, total: int, lh: bytes,
                        aunts: Sequence[bytes]) -> bytes:
    if index >= total or index < 0 or total <= 0:
        raise ValueError("invalid index/total")
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts for single leaf")
        return lh
    if not aunts:
        raise ValueError("missing aunts")
    k = _split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, lh, aunts[:-1])
        return inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, lh, aunts[:-1])
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: Sequence[bytes]
                            ) -> tuple[bytes, list[Proof]]:
    """Root and one inclusion proof per item (reference: proof.go:40)."""
    trails, root_node = _trails_from_leaf_hashes(
        [leaf_hash(it) for it in items])
    root = root_node.hash if root_node else empty_hash()
    return root, [Proof(total=len(items), index=i, leaf_hash=trail.hash,
                        aunts=trail.flatten_aunts())
                  for i, trail in enumerate(trails)]


class _Node:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent = None
        self.left = None   # sibling trail nodes, reference naming
        self.right = None

    def flatten_aunts(self) -> list[bytes]:
        aunts = []
        node = self
        while node is not None:
            if node.left is not None:
                aunts.append(node.left.hash)
            elif node.right is not None:
                aunts.append(node.right.hash)
            node = node.parent
        return aunts


def _trails_from_leaf_hashes(hashes: Sequence[bytes]):
    n = len(hashes)
    if n == 0:
        return [], None
    if n == 1:
        node = _Node(hashes[0])
        return [node], node
    k = _split_point(n)
    lefts, left_root = _trails_from_leaf_hashes(hashes[:k])
    rights, right_root = _trails_from_leaf_hashes(hashes[k:])
    root = _Node(inner_hash(left_root.hash, right_root.hash))
    left_root.parent = root
    left_root.right = right_root
    right_root.parent = root
    right_root.left = left_root
    return lefts + rights, root


def _root_from_leaf_hashes(hashes: Sequence[bytes]) -> bytes:
    if len(hashes) == 1:
        return hashes[0]
    k = _split_point(len(hashes))
    return inner_hash(_root_from_leaf_hashes(hashes[:k]),
                      _root_from_leaf_hashes(hashes[k:]))


def root_from_leaf_hashes(hashes: Sequence[bytes]) -> bytes:
    """Merkle root over pre-hashed leaves (``leaf_hash(item)`` each):
    the state tree keeps its leaf hashes across commits and rehashes
    only the changed ones."""
    if not hashes:
        return empty_hash()
    return _root_from_leaf_hashes(hashes)


def value_op_leaf(key: bytes, value: bytes) -> bytes:
    """The <key, value-hash> leaf binding of ValueOp proofs and the
    kvstore's state tree (reference: proof_value.go:89-102 —
    encodeByteSlice(key) + encodeByteSlice(sha256(value)))."""
    vhash = _sha256(value)
    return (encode_uvarint(len(key)) + key + encode_uvarint(len(vhash)) +
            vhash)
