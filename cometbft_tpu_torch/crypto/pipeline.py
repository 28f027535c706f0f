"""Tile geometry, the verification worker and the pipeline's metrics.

Reference: cometbft_tpu/crypto/pipeline.py — ``tile_size`` and
``tile_plan`` (:65-91), the staging worker with ``submit`` /
``run_off_loop`` / ``reset_workers`` (:95-136), the dispatch and overlap
histograms (:142-177).  The tiles themselves run in
ops/ed25519.verify_batch: host prep of tile i+1 while tile i is on the
card.

The tile comes from ``COMETBFT_TPU_TORCH_VERIFY_TILE`` (at least 64;
anything else keeps the default), the port's own variable, so that the
JAX package's ``COMETBFT_TPU_VERIFY_TILE`` cannot reach it.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from ..libs import metrics as libmetrics
from ..libs.workers import SupervisedWorker

# a pad-bucket shape (ops/ed25519._BASE_BUCKETS)
DEFAULT_TILE = 4096
TILE_ENV = "COMETBFT_TPU_TORCH_VERIFY_TILE"


def tile_size() -> int:
    """Pipeline tile in lanes: ``COMETBFT_TPU_TORCH_VERIFY_TILE`` when it
    is an integer of at least 64, else DEFAULT_TILE."""
    try:
        t = int(os.environ.get(TILE_ENV, str(DEFAULT_TILE)))
    except ValueError:
        return DEFAULT_TILE
    return t if t >= 64 else DEFAULT_TILE


def tile_plan(n: int, tile: Optional[int] = None) -> list[tuple[int, int]]:
    """[(start, end), ...] covering n lanes in BALANCED slices of at
    most ``tile`` lanes (default ``tile_size()``): 10k at tile 4096
    plans three ~3334-lane tiles, not 4096+4096+1808."""
    t = tile or tile_size()
    if n <= 0:
        return []
    ntiles = -(-n // t)
    size = -(-n // ntiles)
    return [(s, min(s + size, n)) for s in range(0, n, size)]


# --- the staging worker (a lazy singleton) ----------------------------------

_STAGE: Optional[SupervisedWorker] = None
_stage_lock = threading.Lock()


def _stage_worker() -> SupervisedWorker:
    global _STAGE
    with _stage_lock:
        if _STAGE is None:
            _STAGE = SupervisedWorker("verify_stage")
        return _STAGE


def reset_workers() -> None:
    """Stop and discard the staging worker (tests call this after each
    test, so no worker thread outlives it)."""
    global _STAGE
    with _stage_lock:
        worker, _STAGE = _STAGE, None
    if worker is not None:
        worker.stop()


def submit(fn: Callable, *args):
    """Run ``fn(*args)`` on the staging worker; a concurrent Future."""
    return _stage_worker().submit(fn, *args)


def run_off_loop(fn: Callable, *args):
    """Awaitable for ``fn(*args)`` run on the staging worker, so an event
    loop never runs a verification itself.  Await it from a running
    loop."""
    import asyncio
    return asyncio.wrap_future(submit(fn, *args))


# --- metrics ----------------------------------------------------------------

_DISPATCH_HIST = libmetrics.DEFAULT.histogram(
    "crypto", "kernel_dispatch_seconds",
    "ed25519 kernel dispatch phases (host_prep / "
    "kernel_execute) in seconds, by kernel, pad bucket and "
    "warm-shape flag.",
    labels=("phase", "kernel", "pad_bucket", "warm"),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 5.0, 30.0, 120.0))

_OVERLAP_HIST = libmetrics.DEFAULT.histogram(
    "crypto", "verify_overlap_ratio",
    "Per-pipeline-run overlap ratio: summed phase wall time "
    "divided by pipeline wall time (1.0 = serial, higher = "
    "phases genuinely overlapped).",
    buckets=(0.5, 0.8, 0.9, 1.0, 1.05, 1.1, 1.25, 1.5, 1.75,
             2.0, 2.5))


def dispatch_histogram() -> libmetrics.Histogram:
    """``crypto_kernel_dispatch_seconds``: host_prep and kernel_execute
    of each tile, labelled phase, kernel ("cuda" | "cuda8"), pad_bucket
    and warm."""
    return _DISPATCH_HIST


def overlap_histogram() -> libmetrics.Histogram:
    """Overlap ratio of each multi-tile run: (host_prep wall + the part
    of each tile's kernel window not spent prepping the next tile) /
    pipeline wall.  1.0 = serial; 2.0 = two phases fully overlapped."""
    return _OVERLAP_HIST
