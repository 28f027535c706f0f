"""Batch-verifier dispatch: key type -> BatchVerifier.

Reference: crypto/batch/batch.go — CreateBatchVerifier (:10),
SupportsBatchVerifier (:21); only ed25519 supports batching.

Every ed25519 batch goes to the CUDA kernel through
ops/ed25519.verify_batch.  There is no circuit breaker and no CPU
fallback: a kernel that fails to build or launch raises to the caller.
``device="cpu"`` runs the kernel's plain PyTorch version, for tests.
"""
from __future__ import annotations

from typing import Sequence

from . import ed25519
from .keys import BatchVerifier, PubKey
from ..device import resolve


def supports_batch_verifier(pub_key: PubKey) -> bool:
    return pub_key.type() == ed25519.KEY_TYPE


class CudaBatchVerifier(BatchVerifier):
    """ed25519 batch verifier on one torch device (the card unless the
    caller names another)."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self._items: list[tuple[bytes, bytes, bytes]] = []

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.type() != ed25519.KEY_TYPE:
            raise TypeError("CudaBatchVerifier requires ed25519 keys")
        if len(sig) != ed25519.SIGNATURE_SIZE:
            raise ValueError("malformed signature")
        self._items.append((pub_key.bytes(), bytes(msg), bytes(sig)))

    def __len__(self) -> int:
        return len(self._items)

    def verify(self) -> tuple[bool, Sequence[bool]]:
        from ..ops.ed25519 import verify_batch
        return verify_batch(self._items, device=self.device)


def create_batch_verifier(pub_key: PubKey, device=None) -> BatchVerifier:
    """Reference: batch.go:10 — errors for unsupported key types."""
    if not supports_batch_verifier(pub_key):
        raise ValueError(
            f"batch verification unsupported for {pub_key.type()}")
    return CudaBatchVerifier(device)
