"""Batch-verifier dispatch: key type -> BatchVerifier.

Reference: crypto/batch/batch.go — CreateBatchVerifier (:10),
SupportsBatchVerifier (:21).  Through cometbft_tpu/crypto/batch.py:
ed25519 and, beyond the Go reference, bls12_381 batch (:154-158,
:332-335); ``batch_verify_by_type`` (:161-197), the grouped batch of the
vote-burst pre-verification; the batch-verify latency histogram
(``verify_seconds_histogram`` / ``_observe_verify``, :68-93) and
``TracedBatchVerifier`` (:303-328), which ``create_batch_verifier``
wraps around every verifier it hands out.

Every ed25519 batch goes to the CUDA kernel through
ops/ed25519.verify_batch.  There is no circuit breaker and no CPU
fallback: a kernel that fails to build or launch raises to the caller,
through ``batch_verify_by_type`` too, where the JAX package turns any
verifier error into "verify it yourself".
``device="cpu"`` runs the kernel's plain PyTorch version, for tests.
A bls12_381 batch runs on the host, in the BLS library
(crypto/bls12381.Bls12381BatchVerifier, backend ``bls_native``).
"""
from __future__ import annotations

import time
from typing import Sequence

from . import bls12381, ed25519
from .keys import BatchVerifier, PubKey
from ..device import resolve
from ..libs import metrics as libmetrics
from ..libs import tracing
from ..ops import ed25519 as ops_ed25519

_VERIFY_HIST = libmetrics.DEFAULT.histogram(
    "crypto", "batch_verify_seconds",
    "Batch signature verification latency in seconds, by "
    "dispatch backend and kernel pad bucket.",
    labels=("backend", "pad_bucket"),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5))


def verify_seconds_histogram() -> libmetrics.Histogram:
    """The process-global batch-verify latency histogram."""
    return _VERIFY_HIST


def _observe_verify(backend: str, n: int, elapsed_s: float) -> None:
    _VERIFY_HIST.with_labels(
        backend, str(ops_ed25519._bucket(n))).observe(elapsed_s)


def supports_batch_verifier(pub_key: PubKey) -> bool:
    return pub_key.type() in (ed25519.KEY_TYPE, bls12381.KEY_TYPE)


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
        return ops_ed25519.verify_batch(self._items, device=self.device)


class TracedBatchVerifier(BatchVerifier):
    """A ``batch_verify`` span and a latency observation around any
    BatchVerifier's verify, labelled with its backend."""

    def __init__(self, inner: BatchVerifier, backend: str):
        self._inner = inner
        self._backend = backend

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        self._inner.add(pub_key, msg, sig)

    def __len__(self) -> int:
        return len(self._inner)

    def verify(self) -> tuple[bool, Sequence[bool]]:
        n = len(self)
        t0 = time.perf_counter()
        with tracing.span(tracing.CRYPTO, "batch_verify", batch=n,
                          backend=self._backend):
            out = self._inner.verify()
        _observe_verify(self._backend, n, time.perf_counter() - t0)
        return out


def batch_verify_by_type(entries, device=None) -> list:
    """Batch verification of (pub_key, msg, sig) triples grouped by key
    type: ed25519 into the kernel on ``device``, bls12_381 into the host
    BLS library.  Returns a per-entry list: True/False for entries a
    batch verifier judged, None for entries it could not — a key type
    with no batch verifier, an entry its verifier's ``add`` refused (a
    wrong signature length), a group of one.  Callers treat None as
    "verify it yourself".  Unlike the JAX package, an error from
    building or launching a kernel, or from the BLS library, raises."""
    out = [None] * len(entries)
    groups: dict[str, tuple[BatchVerifier, list[int]]] = {}
    for i, (pub_key, msg, sig) in enumerate(entries):
        if not supports_batch_verifier(pub_key):
            continue
        entry = groups.get(pub_key.type())
        if entry is None:
            entry = (create_batch_verifier(pub_key, device), [])
            groups[pub_key.type()] = entry
        try:
            entry[0].add(pub_key, msg, sig)
        except (TypeError, ValueError):
            continue
        entry[1].append(i)
    for bv, idxs in groups.values():
        if len(idxs) < 2:
            continue
        _, mask = bv.verify()
        for i, good in zip(idxs, mask):
            out[i] = bool(good)
    return out


def create_batch_verifier(pub_key: PubKey, device=None) -> BatchVerifier:
    """Reference: batch.go:10 — errors for unsupported key types.  The
    ed25519 backend label is the device type: ``cuda`` on the card,
    ``cpu`` for the plain version.  ``device`` is resolved for every key
    type, so the device rule is the same for a BLS batch, whose work is
    on the host."""
    if not supports_batch_verifier(pub_key):
        raise ValueError(
            f"batch verification unsupported for {pub_key.type()}")
    if pub_key.type() == bls12381.KEY_TYPE:
        resolve(device)
        return TracedBatchVerifier(bls12381.Bls12381BatchVerifier(),
                                   "bls_native")
    inner = CudaBatchVerifier(device)
    return TracedBatchVerifier(inner, inner.device.type)
