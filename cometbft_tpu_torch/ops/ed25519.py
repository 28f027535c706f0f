"""Host orchestration of batch ed25519 verification on the card.

Counterpart of the host half of cometbft_tpu/ops/ed25519_jax.py: pad
buckets and their measured refinement (:281-363), the host prep
(``prep_arrays``, :636-659, the one C pass of native/_native.cpp:187-463),
the tiled pipeline (``_verify_pipelined`` / ``_dispatch_async`` /
``_verify_chunk``, :445-634) with its spans and dispatch histogram, the
pre_bad masking and the kernel choice (:573-598).

``verify_batch`` splits a batch into balanced tiles
(crypto/pipeline.tile_plan).  Each tile is prepped by
ops/csrc/ed25519_prep.cpp (through ctypes, without the GIL) straight
into one host block, pinned on the card's path; the block goes to the
device with a non-blocking copy on a side stream, is laid out there in
the kernel's int32 columns and verified by the chosen kernel module's
``verify_cols`` on that stream, and its verdicts come back with a
non-blocking copy into pinned memory, after which the tile records one
event.  Tile i+1 is prepped while tile i runs, and tile i is settled
(its event synchronised) after tile i+1 is dispatched.  A launch that
fails raises at once; a fault that surfaces only on the device raises at
its tile's event, and no mask is returned.  On ``device="cpu"`` the same
code runs without pinned memory or streams, the kernel's plain version
synchronously.

``prep_arrays_plain`` is the numpy/hashlib version of the prep, kept as
the plain version the tests hold the C pass to; no path falls back to it.

The kernel is chosen by ``COMETBFT_TPU_TORCH_KERNEL``, read on every
call: ``cuda`` (the default) is ops/ed25519_kernel.py (B1, radix
2^25.5), ``cuda8`` is ops/ed25519_kernel8.py (B2, radix 2^16).  Any
other value raises: there is no "auto" and no fallback, and the JAX
package's names (``pallas``, ``pallas8``, ``xla``) are not accepted.
The variable is the port's own so that ``COMETBFT_TPU_KERNEL``, which
the JAX package reads, cannot reach it.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..crypto import _ed25519_ref as ref
from ..crypto import pipeline
from ..device import resolve
from ..libs import metrics as libmetrics
from ..libs import tracing
from . import _build, ed25519_kernel, ed25519_kernel8

L = ref.L

KERNEL_ENV = "COMETBFT_TPU_TORCH_KERNEL"
KERNELS = {"cuda": ed25519_kernel, "cuda8": ed25519_kernel8}

_BASE_BUCKETS = (64, 1024, 4096, 10240, 16384)
_BUCKETS = list(_BASE_BUCKETS)
_IDENTITY_BYTES = bytes([1] + [0] * 31)     # compressed identity (y=1)
_B_BYTES = ref.compress(ref.B)
_Z32, _Z64 = bytes(32), bytes(64)

# A prepped tile of m lanes is one host block: A, R (32 B a lane), the s
# and k windows (64 B a lane) -- the 192 B a lane copied to the device --
# then pre_bad (1 B a lane), which stays on the host.
_ROW_BYTES = (32, 32, 64, 64)
_WIRE = sum(_ROW_BYTES)
_LANE_BYTES = _WIRE + 1

# (kernel, bucket) pairs dispatched before: the "warm" label
_SEEN_SHAPES: set = set()


def _kernel_choice() -> str:
    """``cuda`` or ``cuda8`` from COMETBFT_TPU_TORCH_KERNEL (default
    ``cuda``); any other value raises ValueError."""
    choice = os.environ.get(KERNEL_ENV, "cuda")
    if choice not in KERNELS:
        raise ValueError(
            f"{KERNEL_ENV}={choice!r}: expected one of {sorted(KERNELS)}")
    return choice


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


# --- measured pad-bucket refinement -----------------------------------------
# The base buckets have a 16x gap at the bottom (64 -> 1024).  A bucket
# is refined only when warm single-tile dispatches that fill at most
# half of it spend at least twice as long in kernel_execute as in
# host_prep: then padding is what the batch pays for.

_REFINE_CANDIDATES = (128, 256, 512, 2048)
_TUNE_MIN_SAMPLES = 8
_TUNE_WINDOW = 64
_tune_samples: dict[int, list] = {}     # bucket -> [(n, prep_s, exec_s)]
_tune_lock = threading.Lock()
_REFINED = libmetrics.DEFAULT.counter(
    "crypto", "pad_bucket_refinements",
    "Pad buckets inserted by the measured host_prep/"
    "kernel_execute steering (small batches were "
    "padding into oversized buckets).")


def reset_bucket_tuning() -> None:
    """Drop refined buckets and samples."""
    with _tune_lock:
        _BUCKETS[:] = _BASE_BUCKETS
        _tune_samples.clear()


def _tune_record(n: int, m: int, prep_s: float, exec_s: float) -> None:
    with _tune_lock:
        samples = _tune_samples.setdefault(m, [])
        samples.append((n, prep_s, exec_s))
        if len(samples) > _TUNE_WINDOW:
            samples.pop(0)
        lows = [s for s in samples if s[0] <= m // 2]
        if len(lows) < _TUNE_MIN_SAMPLES:
            return
        med_prep = sorted(p for _, p, _ in lows)[len(lows) // 2]
        med_exec = sorted(e for _, _, e in lows)[len(lows) // 2]
        if med_exec < 2 * med_prep:
            return              # host_prep dominates: padding costs little
        target = max(s[0] for s in lows)
        prev = max((b for b in _BUCKETS if b < m), default=0)
        for cand in _REFINE_CANDIDATES:
            if cand >= m or cand in _BUCKETS or cand < target or \
                    cand <= prev:
                continue
            _BUCKETS.append(cand)
            _BUCKETS.sort()
            samples.clear()
            _REFINED.add()
            return


# --- host prep --------------------------------------------------------------

def _windows_u8(scalars: np.ndarray) -> np.ndarray:
    """[m, 32] uint8 little-endian scalars -> [m, 64] uint8 4-bit
    windows, lane-major (window 2i = low nibble of byte i, window
    2i+1 = high nibble)."""
    m = scalars.shape[0]
    win = np.empty((m, 64), np.uint8)
    win[:, 0::2] = scalars & 0x0F
    win[:, 1::2] = scalars >> 4
    return win


def pack(items):
    """(pub, msg, sig) items -> the C prep's packed blobs: (pubs 32n,
    sigs 64n, msgs concatenated, int64 offsets [n+1] into msgs, bool
    bad_len [n]).  An item whose pub is not 32 B or sig not 64 B is
    marked in bad_len and carries zero placeholders in both blobs."""
    n = len(items)
    if n == 0:
        return b"", b"", b"", np.zeros(1, np.int64), np.zeros(0, bool)
    pubs, msgs, sigs = zip(*items)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, msgs), np.int64, n), out=offsets[1:])
    bad = ((np.fromiter(map(len, pubs), np.int64, n) != 32) |
           (np.fromiter(map(len, sigs), np.int64, n) != 64))
    if bad.any():
        flags = bad.tolist()
        pubs = [_Z32 if b else p for p, b in zip(pubs, flags)]
        sigs = [_Z64 if b else s for s, b in zip(sigs, flags)]
    return b"".join(pubs), b"".join(sigs), b"".join(msgs), offsets, bad


def _prep_into(items, m: int, base: int) -> None:
    """Pack ``items`` and run the C prep into the m-lane host block at
    address ``base`` (``_LANE_BYTES * m`` bytes)."""
    n = len(items)
    if m < n:
        raise ValueError(f"m = {m} < {n} items")
    lib = _build.load_host()
    with tracing.span(tracing.CRYPTO, "prep_pack", batch=n):
        pubs, sigs, msgs, offsets, bad = pack(items)
    with tracing.span(tracing.CRYPTO, "prep_c", batch=n, bucket=m):
        rc = lib.ed25519_prep(
            pubs, sigs, msgs, offsets.ctypes.data, bad.ctypes.data, n, m,
            _B_BYTES, _IDENTITY_BYTES, base, base + 32 * m, base + 64 * m,
            base + 128 * m, base + 192 * m)
    if rc != 0:
        raise RuntimeError(f"ed25519_prep failed ({rc})")


def _split(block, m: int):
    """The five views of an m-lane host block: a_b, r_b [m, 32], s_w8,
    k_w8 [m, 64], pre_bad [m]."""
    out, at = [], 0
    for w in _ROW_BYTES:
        out.append(block[at * m:(at + w) * m].reshape(m, w))
        at += w
    return (*out, block[at * m:(at + 1) * m])


def prep_arrays(items, m: int):
    """The host-side prep for a batch of (pub, msg, sig) items, padded
    to m lanes, in one C pass: length/canonical-S checks,
    k = SHA-512(R||A||msg) mod L, 4-bit window split.  Returns
    (a_b [m,32]u8, r_b [m,32]u8, s_w8 [m,64]u8, k_w8 [m,64]u8,
    pre_bad [m]bool), byte for byte what ``prep_arrays_plain`` gives."""
    block = np.empty(_LANE_BYTES * m, np.uint8)
    _prep_into(items, m, block.ctypes.data)
    a_b, r_b, s_w8, k_w8, pre_bad = _split(block, m)
    return a_b, r_b, s_w8, k_w8, pre_bad.view(bool)


def prep_arrays_plain(items, m: int):
    """``prep_arrays`` in numpy and hashlib (the reference's fallback
    branch, ed25519_jax.py:661-715): the plain version of the C pass.
    Padding lanes and rejected lanes carry A = B, R = identity,
    s = k = 0, which verify trivially; pre_bad marks the rejected ones."""
    a_b = np.zeros((m, 32), np.uint8)
    r_b = np.zeros((m, 32), np.uint8)
    s_raw = np.zeros((m, 32), np.uint8)
    k_raw = np.zeros((m, 32), np.uint8)
    # padding lanes verify trivially: 0·B - identity - 0·A == identity
    a_b[:] = np.frombuffer(_B_BYTES, np.uint8)
    r_b[:] = np.frombuffer(_IDENTITY_BYTES, np.uint8)
    pre_bad = np.zeros(m, bool)

    good_idx = []
    pubs = []
    rs = []
    ss = []
    hashed = []            # R || A || msg per good item
    for i, (pub, msg, sig) in enumerate(items):
        if len(pub) != 32 or len(sig) != 64:
            pre_bad[i] = True
            continue
        good_idx.append(i)
        pubs.append(pub)
        rs.append(sig[:32])
        ss.append(sig[32:])
        hashed.append(sig[:32] + pub + msg)
    if good_idx:
        gi = np.asarray(good_idx)
        a_g = np.frombuffer(b"".join(pubs), np.uint8).reshape(-1, 32)
        r_g = np.frombuffer(b"".join(rs), np.uint8).reshape(-1, 32)
        s_g = np.frombuffer(b"".join(ss), np.uint8).reshape(-1, 32)
        # non-canonical S (>= L) rejection, vectorized as a
        # lexicographic big-endian compare (ZIP-215 requires S < L)
        s_be = s_g[:, ::-1]
        L_be = np.frombuffer(L.to_bytes(32, "big"), np.uint8)
        neq = s_be != L_be
        first = np.argmax(neq, axis=1)
        differs = neq.any(axis=1)
        s_ok = differs & (s_be[np.arange(len(gi)), first] <
                          L_be[first])
        pre_bad[gi[~s_ok]] = True
        k_g = np.zeros((len(gi), 32), np.uint8)
        for j, buf in enumerate(hashed):
            k = ref.sha512_mod_l(buf[:32], buf[32:64], buf[64:])
            k_g[j] = np.frombuffer(k.to_bytes(32, "little"), np.uint8)
        keep = np.asarray(s_ok)
        a_b[gi[keep]] = a_g[keep]
        r_b[gi[keep]] = r_g[keep]
        s_raw[gi[keep]] = s_g[keep]
        k_raw[gi[keep]] = k_g[keep]
    return a_b, r_b, _windows_u8(s_raw), _windows_u8(k_raw), pre_bad


# --- device side ------------------------------------------------------------

def to_cols(rows_u8: np.ndarray, device: torch.device) -> torch.Tensor:
    """[m, w] uint8 lane-major host rows -> [w, m] int32 columns on the
    device (the copy moves one byte per element; the transpose and the
    widening run there)."""
    dev_rows = torch.from_numpy(rows_u8).to(device)
    return dev_rows.t().to(torch.int32, memory_format=torch.contiguous_format)


def _wire_cols(wire: torch.Tensor, m: int) -> list[torch.Tensor]:
    """The 192 m wire bytes of a tile, on its device -> the kernel's
    four int32 column tensors."""
    return [rows.t().to(torch.int32, memory_format=torch.contiguous_format)
            for rows in _split(wire, m)[:4]]


_streams: dict[int, torch.cuda.Stream] = {}
_streams_lock = threading.Lock()


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The pipeline's stream on ``dev``, created for that device once
    (never the calling thread's current stream)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with _streams_lock:
        stream = _streams.get(index)
        if stream is None:
            stream = _streams[index] = torch.cuda.Stream(device=index)
        return stream


def _dispatch(kernel, block: torch.Tensor, m: int, dev: torch.device,
              stream):
    """Send one prepped tile to ``kernel`` without waiting for it.
    Returns (verdicts [m] bool on the host, event or None): on CUDA the
    verdicts are valid once the event has completed; on the CPU (no
    stream) the plain version has already run."""
    if stream is None:
        return kernel.verify_cols(*_wire_cols(block[:_WIRE * m], m)), None
    with torch.cuda.stream(stream):
        wire = block[:_WIRE * m].to(dev, non_blocking=True)
        ok = kernel.verify_cols(*_wire_cols(wire, m))
        ok_host = torch.empty(m, dtype=torch.bool, pin_memory=True)
        ok_host.copy_(ok, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return ok_host, event


def verify_batch(items: Sequence[tuple[bytes, bytes, bytes]],
                 device=None) -> tuple[bool, list[bool]]:
    """Verify [(pub, msg, sig), ...]; returns (all_valid, per_sig_mask)
    — the reference BatchVerifier.Verify contract (crypto/crypto.go:47).
    Batches above one tile (crypto/pipeline.tile_size) run as a
    pipeline of balanced tiles, all verified by the kernel
    ``COMETBFT_TPU_TORCH_KERNEL`` names.  Runs on the card unless
    ``device`` names another device."""
    dev = resolve(device)
    choice = _kernel_choice()
    kernel = KERNELS[choice]
    n = len(items)
    if n == 0:
        return True, []
    plan = pipeline.tile_plan(n, _bucket(pipeline.tile_size()))
    pipelined = len(plan) > 1
    stream = _side_stream(dev) if dev.type == "cuda" else None
    hist = pipeline.dispatch_histogram()
    out = np.zeros(n, bool)
    t_run0 = time.perf_counter()
    phase_s = 0.0
    inflight = None     # (lo, hi, m, warm, block, ok, event, t_exec0)

    def settle(tile) -> float:
        """Wait for a tile, apply its verdicts; returns when it ended
        and how long the kernel phase held it."""
        lo, hi, m, warm, block, ok, event, t_exec0 = tile
        with tracing.span(tracing.CRYPTO, "kernel_execute", batch=hi - lo,
                          bucket=m, kernel=choice, warm=warm,
                          pipelined=pipelined):
            if event is not None:
                event.synchronize()
            mask = ok.numpy()[:hi - lo].copy()
        t1 = time.perf_counter()
        hist.with_labels("kernel_execute", choice, str(m),
                         "1" if warm else "0").observe(t1 - t_exec0)
        mask[_split(block, m)[4].numpy()[:hi - lo] != 0] = False
        out[lo:hi] = mask
        return t1

    for lo, hi in plan:
        m = _bucket(hi - lo)
        warm = (choice, m) in _SEEN_SHAPES
        t0 = time.perf_counter()
        with tracing.span(tracing.CRYPTO, "host_prep", batch=hi - lo,
                          bucket=m, pipelined=pipelined):
            block = torch.empty(_LANE_BYTES * m, dtype=torch.uint8,
                                pin_memory=stream is not None)
            _prep_into(items[lo:hi], m, block.data_ptr())
        t1 = time.perf_counter()
        hist.with_labels("host_prep", choice, str(m),
                         "1" if warm else "0").observe(t1 - t0)
        phase_s += t1 - t0
        ok, event = _dispatch(kernel, block, m, dev, stream)
        t_disp = time.perf_counter()
        _SEEN_SHAPES.add((choice, m))
        if inflight is not None:
            # the previous tile's kernel window contains this tile's
            # host_prep (prepped between its dispatch and its settle);
            # only what lies beyond that was hidden by the overlap
            t_end = settle(inflight)
            phase_s += max(0.0, (t_end - inflight[7]) - (t1 - t0))
        # one tile: kernel_execute runs from the end of host_prep, as
        # the reference's single-chunk dispatch times it
        inflight = (lo, hi, m, warm, block, ok, event,
                    t_disp if pipelined else t1)
    t_end = settle(inflight)
    if pipelined:
        phase_s += t_end - inflight[7]
        wall = t_end - t_run0
        if wall > 0:
            pipeline.overlap_histogram().observe(phase_s / wall)
    elif inflight[3]:
        # only warm dispatches steer bucket refinement
        _tune_record(n, inflight[2], t1 - t0, t_end - t1)
    return bool(out.all()), out.tolist()
