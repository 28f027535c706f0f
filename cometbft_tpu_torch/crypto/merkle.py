"""RFC-6962-style binary merkle root with domain-separated hashing,
inclusion proofs, compact multiproofs and chained proof operators.

Reference: crypto/merkle/tree.go (HashFromByteSlices, leaf/inner
prefixes, getSplitPoint), proof.go (Proof, ProofsFromByteSlices) and
proof_op.go / proof_value.go (ProofOperators, ValueOp), through
cometbft_tpu/crypto/merkle.py: Proof, the root over leaf hashes the
state tree keeps, ``Multiproof`` with its builders (one proof over many
leaves of one tree, the lightserve routes' wire form) and the ValueOp
leaf binding.  The plain hashlib recursion only: the reference's native
shortcut is left out.
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

    def to_dict(self) -> dict:
        return {"total": self.total, "index": self.index,
                "leaf_hash": self.leaf_hash.hex(),
                "aunts": [a.hex() for a in self.aunts]}

    @classmethod
    def from_dict(cls, d: dict) -> "Proof":
        return cls(total=d["total"], index=d["index"],
                   leaf_hash=bytes.fromhex(d["leaf_hash"]),
                   aunts=[bytes.fromhex(a) for a in d["aunts"]])


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


# -- compact multiproofs ----------------------------------------------------
# One proof covering many leaves of one tree.  Its layout is the proven
# leaf positions (``indices``, sorted and unique) and the roots of every
# maximal subtree holding no proven leaf (``aunts``), in the order a
# pre-order walk of the split-point tree visits them.  The verifier
# replays the same walk, so no aunt needs a position tag.


@dataclass
class Multiproof:
    """Compact inclusion proof for several leaves of one merkle tree:
    ints for total and indices, hex hashes in to_dict / from_dict.
    ``verify`` takes the raw items in ``indices`` order and raises
    ValueError on any mismatch, as Proof.verify does."""
    total: int
    indices: list[int] = field(default_factory=list)
    aunts: list[bytes] = field(default_factory=list)

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("multiproof total must be >= 0")
        prev = -1
        for i in self.indices:
            if i <= prev:
                raise ValueError(
                    "multiproof indices must be sorted and unique")
            prev = i
        if self.indices and self.indices[-1] >= self.total:
            raise ValueError("multiproof index out of range")

    def verify(self, root: bytes, leaves: Sequence[bytes]) -> None:
        """Verify the tree items ``leaves`` (aligned with ``indices``)
        against ``root``; each gets the leaf prefix hash here.  For the
        tx tree the items are the per-tx sha256 digests."""
        self.verify_hashes(root, [leaf_hash(leaf) for leaf in leaves])

    def verify_hashes(self, root: bytes,
                      leaf_hashes: Sequence[bytes]) -> None:
        if self.compute_root_hash(leaf_hashes) != root:
            raise ValueError("invalid multiproof: root mismatch")

    def compute_root_hash(self, leaf_hashes: Sequence[bytes]) -> bytes:
        self.validate_basic()
        if len(leaf_hashes) != len(self.indices):
            raise ValueError(
                f"multiproof expects {len(self.indices)} leaves, "
                f"got {len(leaf_hashes)}")
        aunts = iter(self.aunts)
        hashes = iter(leaf_hashes)
        pos = 0                       # the next unconsumed index

        def walk(lo: int, hi: int) -> bytes:
            nonlocal pos
            if pos >= len(self.indices) or self.indices[pos] >= hi:
                # no proven leaf in [lo, hi): one aunt covers it
                try:
                    return next(aunts)
                except StopIteration:
                    raise ValueError(
                        "invalid multiproof: missing aunts") from None
            if hi - lo == 1:
                pos += 1
                return next(hashes)
            k = lo + _split_point(hi - lo)
            left = walk(lo, k)
            return inner_hash(left, walk(k, hi))

        if self.total == 0:
            if self.aunts or self.indices:
                raise ValueError(
                    "unexpected aunts/indices for empty tree")
            return empty_hash()
        out = walk(0, self.total)
        if pos != len(self.indices):
            raise ValueError("invalid multiproof: unconsumed indices")
        if next(aunts, None) is not None:
            raise ValueError("invalid multiproof: unconsumed aunts")
        return out

    def to_dict(self) -> dict:
        return {"total": self.total, "indices": list(self.indices),
                "aunts": [a.hex() for a in self.aunts]}

    @classmethod
    def from_dict(cls, d: dict) -> "Multiproof":
        return cls(total=d["total"], indices=list(d["indices"]),
                   aunts=[bytes.fromhex(a) for a in d["aunts"]])


def multiproof_from_byte_slices(
        items: Sequence[bytes],
        indices: Sequence[int]) -> tuple[bytes, Multiproof]:
    """Root and one compact proof for the leaves at ``indices``, which
    may come unsorted or repeated: the proof carries them sorted and
    unique, and callers give leaves in that order.  Each untargeted
    subtree is hashed once."""
    return multiproof_from_leaf_hashes([leaf_hash(it) for it in items],
                                       indices)


def multiproof_from_leaf_hashes(
        hashes: Sequence[bytes],
        indices: Sequence[int]) -> tuple[bytes, Multiproof]:
    """Multiproof over pre-hashed leaves (tx digests, kv bindings)."""
    total = len(hashes)
    idx = sorted(set(indices))
    if idx and (idx[0] < 0 or idx[-1] >= total):
        raise ValueError(
            f"multiproof index out of range [0, {total})")
    if total == 0:
        return empty_hash(), Multiproof(total=0)
    aunts: list[bytes] = []
    pos = 0

    def build(lo: int, hi: int) -> bytes:
        nonlocal pos
        if pos >= len(idx) or idx[pos] >= hi:
            h = _root_from_leaf_hashes(hashes[lo:hi])
            aunts.append(h)
            return h
        if hi - lo == 1:
            pos += 1
            return hashes[lo]
        k = lo + _split_point(hi - lo)
        left = build(lo, k)
        return inner_hash(left, build(k, hi))

    root = build(0, total)
    return root, Multiproof(total=total, indices=idx, aunts=aunts)


# -- chained proof operators (reference: crypto/merkle/proof_op.go) ---------

def _uvarint(n: int) -> bytes:
    """Uvarint length prefix (reference: crypto/merkle/types.go:30
    encodeByteSlice)."""
    return encode_uvarint(n)


def value_op_leaf(key: bytes, value: bytes) -> bytes:
    """The <key, value-hash> leaf binding of ValueOp proofs and the
    kvstore's state tree (reference: proof_value.go:89-102 —
    encodeByteSlice(key) + encodeByteSlice(sha256(value)))."""
    vhash = _sha256(value)
    return _uvarint(len(key)) + key + _uvarint(len(vhash)) + vhash


class ProofOperator:
    def run(self, values: list[bytes]) -> list[bytes]:
        raise NotImplementedError

    def get_key(self) -> bytes:
        raise NotImplementedError


@dataclass
class ValueOp(ProofOperator):
    """Proves a leaf value's inclusion under a root (reference:
    proof_value.go)."""
    key: bytes
    proof: Proof

    def run(self, values: list[bytes]) -> list[bytes]:
        if len(values) != 1:
            raise ValueError("ValueOp expects one value")
        if leaf_hash(value_op_leaf(self.key, values[0])) != \
                self.proof.leaf_hash:
            raise ValueError("leaf hash mismatch")
        return [self.proof.compute_root_hash()]

    def get_key(self) -> bytes:
        return self.key


class ProofOperators(list):
    def verify(self, root: bytes, keypath: Sequence[bytes],
               args: list[bytes]) -> None:
        keys = list(keypath)
        for op in self:
            key = op.get_key()
            if key:
                if not keys or keys[-1] != key:
                    raise ValueError(f"key mismatch on {key!r}")
                keys.pop()
            args = op.run(args)
        if args[0] != root:
            raise ValueError("root mismatch after proof chain")
        if keys:
            raise ValueError("unconsumed keypath")

    def verify_value(self, root: bytes, keypath: Sequence[bytes],
                     value: bytes) -> None:
        self.verify(root, keypath, [value])
