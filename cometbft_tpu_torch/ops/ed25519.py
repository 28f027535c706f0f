"""Host orchestration of batch ed25519 verification on the card.

Counterpart of the host half of cometbft_tpu/ops/ed25519_jax.py:
pad buckets (:281), the host prep (prep_arrays, the numpy/hashlib
branch at :661-715), the balanced tile plan and the pre_bad masking
(:786-787), and the kernel choice (``_kernel_choice``/``_pallas_module``,
:573-598).  Each tile is prepped, copied to the device, transposed to
the kernel's int32 column layout and verified by the chosen kernel
module's ``verify_cols``, one after another on the current stream; the
verdicts are read back once, after the last launch.

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
from typing import Sequence

import numpy as np
import torch

from ..crypto import _ed25519_ref as ref
from ..crypto.pipeline import DEFAULT_TILE, tile_plan
from ..device import resolve
from . import ed25519_kernel, ed25519_kernel8

L = ref.L

KERNEL_ENV = "COMETBFT_TPU_TORCH_KERNEL"
KERNELS = {"cuda": ed25519_kernel, "cuda8": ed25519_kernel8}

_BASE_BUCKETS = (64, 1024, 4096, 10240, 16384)
_IDENTITY_BYTES = bytes([1] + [0] * 31)     # compressed identity (y=1)
_B_BYTES = ref.compress(ref.B)


def _kernel_choice() -> str:
    """``cuda`` or ``cuda8`` from COMETBFT_TPU_TORCH_KERNEL (default
    ``cuda``); any other value raises ValueError."""
    choice = os.environ.get(KERNEL_ENV, "cuda")
    if choice not in KERNELS:
        raise ValueError(
            f"{KERNEL_ENV}={choice!r}: expected one of {sorted(KERNELS)}")
    return choice


def _bucket(n: int) -> int:
    for b in _BASE_BUCKETS:
        if n <= b:
            return b
    return _BASE_BUCKETS[-1]


def _windows_u8(scalars: np.ndarray) -> np.ndarray:
    """[m, 32] uint8 little-endian scalars -> [m, 64] uint8 4-bit
    windows, lane-major (window 2i = low nibble of byte i, window
    2i+1 = high nibble)."""
    m = scalars.shape[0]
    win = np.empty((m, 64), np.uint8)
    win[:, 0::2] = scalars & 0x0F
    win[:, 1::2] = scalars >> 4
    return win


def prep_arrays(items, m: int):
    """The host-side prep for a batch of (pub, msg, sig) items, padded
    to m lanes: length/canonical-S checks, k = SHA-512(R||A||msg) mod L,
    4-bit window split.  Returns (a_b [m,32]u8, r_b [m,32]u8,
    s_w8 [m,64]u8, k_w8 [m,64]u8, pre_bad [m]bool).  Padding lanes and
    rejected lanes carry A = B, R = identity, s = k = 0, which verify
    trivially; pre_bad marks the rejected ones."""
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


def to_cols(rows_u8: np.ndarray, device: torch.device) -> torch.Tensor:
    """[m, w] uint8 lane-major host rows -> [w, m] int32 columns on the
    device (the copy moves one byte per element; the transpose and the
    widening run there)."""
    dev_rows = torch.from_numpy(rows_u8).to(device)
    return dev_rows.t().to(torch.int32, memory_format=torch.contiguous_format)


def verify_batch(items: Sequence[tuple[bytes, bytes, bytes]],
                 device=None) -> tuple[bool, list[bool]]:
    """Verify [(pub, msg, sig), ...]; returns (all_valid, per_sig_mask)
    — the reference BatchVerifier.Verify contract (crypto/crypto.go:47).
    Batches above DEFAULT_TILE split into balanced tiles, all verified
    by the kernel ``COMETBFT_TPU_TORCH_KERNEL`` names.  Runs on the card
    unless ``device`` names another device."""
    dev = resolve(device)
    kernel = KERNELS[_kernel_choice()]
    n = len(items)
    if n == 0:
        return True, []
    pending = []
    for lo, hi in tile_plan(n, _bucket(DEFAULT_TILE)):
        a_b, r_b, s_w8, k_w8, pre_bad = prep_arrays(items[lo:hi],
                                                    _bucket(hi - lo))
        ok = kernel.verify_cols(
            to_cols(a_b, dev), to_cols(r_b, dev), to_cols(s_w8, dev),
            to_cols(k_w8, dev))
        pending.append((lo, hi, ok, pre_bad))
    out = np.zeros(n, bool)
    for lo, hi, ok, pre_bad in pending:
        mask = ok[:hi - lo].cpu().numpy()
        mask[pre_bad[:hi - lo]] = False
        out[lo:hi] = mask
    return bool(out.all()), out.tolist()
