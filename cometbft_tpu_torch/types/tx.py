"""Transactions and their merkle hashing.

Reference: types/tx.go — Tx.Hash = sha256(tx), Txs.Hash = the merkle
root over the per-tx hashes — through cometbft_tpu/types/tx.py.  The
plain hashlib loop only.
"""
from __future__ import annotations

from typing import Sequence

from ..crypto import merkle, tmhash


def tx_hash(tx: bytes) -> bytes:
    return tmhash.sum(tx)


def tx_key(tx: bytes) -> bytes:
    """Map key for mempool dedup and compact blocks (reference:
    types/tx.go TxKey — the sha256 of the tx)."""
    return tmhash.sum(tx)


def hash_each(txs: Sequence[bytes]) -> list[bytes]:
    """Per-tx sha256 digests (reference: Txs.Hash's TxID loop)."""
    return [tmhash.sum(tx) for tx in txs]


def txs_hash(txs: Sequence[bytes]) -> bytes:
    return merkle.hash_from_byte_slices(hash_each(txs))


def compute_proto_size_overhead(n: int) -> int:
    """Proto overhead of a bytes field of length n: the field tag and
    the uvarint length (reference: types/tx.go ComputeProtoSizeForTxs)."""
    ln = n
    bytes_needed = 1
    while ln >= 0x80:
        ln >>= 7
        bytes_needed += 1
    return 1 + bytes_needed
