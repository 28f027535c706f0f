"""Shared key-operation benchmarking helpers.

Reference: crypto/internal/benchmarking/bench.go — one harness every key
type reuses for sign/verify throughput measurements — through
cometbft_tpu/crypto/benchmarking.py.  The batch harness takes the
device of the port's batch verifier (``None``: the card).
"""
from __future__ import annotations

import time
from typing import Callable

from .keys import PrivKey


def bench_sign(priv: PrivKey, msg_len: int = 128,
               iters: int = 200) -> float:
    """Signatures per second."""
    msg = bytes(range(256)) * (msg_len // 256 + 1)
    msg = msg[:msg_len]
    t0 = time.perf_counter()
    for _ in range(iters):
        priv.sign(msg)
    return iters / (time.perf_counter() - t0)


def bench_verify(priv: PrivKey, msg_len: int = 128,
                 iters: int = 200) -> float:
    """Verifications per second (single-sig path)."""
    msg = b"m" * msg_len
    sig = priv.sign(msg)
    pub = priv.pub_key()
    t0 = time.perf_counter()
    for _ in range(iters):
        assert pub.verify_signature(msg, sig)
    return iters / (time.perf_counter() - t0)


def bench_batch_verify(gen_priv: Callable[[], PrivKey],
                       batch_size: int = 64,
                       iters: int = 3, device=None) -> float:
    """Batched signatures verified per second via the engine's
    BatchVerifier dispatch (crypto/batch.py)."""
    from . import batch as crypto_batch
    items = []
    for i in range(batch_size):
        sk = gen_priv()
        msg = b"batch-%d" % i
        items.append((sk.pub_key(), msg, sk.sign(msg)))
    t0 = time.perf_counter()
    for _ in range(iters):
        bv = crypto_batch.create_batch_verifier(items[0][0], device)
        for pub, msg, sig in items:
            bv.add(pub, msg, sig)
        ok, _ = bv.verify()
        assert ok
    return batch_size * iters / (time.perf_counter() - t0)
