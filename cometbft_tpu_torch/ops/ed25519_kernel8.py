"""Batch ed25519 verification, second kernel: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of cometbft_tpu/ops/ed25519_pallas8.py (``_kernel``, :247,
launched by ``_pallas_verify``, :333), the first-generation TPU kernel
behind ``COMETBFT_TPU_KERNEL=pallas8``.  It computes the same function
as ops/ed25519_kernel.py (ZIP-215 cofactored verification, same public
layout: A and R as ``[32, n]`` int32 byte columns, s and k as
``[64, n]`` int32 4-bit windows, one verdict per lane out) with B2's
algorithmic choices and none of B1's field code:

  * the field is ops/field16.py (16 limbs of 16 bits, fold 38 at 2^256);
  * the B table holds full extended points (X, Y, Z = 1, T = xy) and is
    added with the 9-multiply unified add, not the affine mixed add;
  * every doubling and every addition produces T.

Per lane: decompress A and R; build i·(-A), i = 0..15, with 14 unified
adds; run 64 windows from the top, each 4 doublings, a unified add of
the B entry of the s window and a unified add of the lane entry of the
k window; add -R, double 3 times, test X == 0 and Y == Z, AND both
decompression flags.

``verify_cols`` launches ops/csrc/ed25519_verify8.cu for CUDA tensors
and runs ``verify_cols_plain`` for CPU tensors; nothing else picks
between them.  ``verify_cols_plain`` computes the function on
``[n, 16]`` int64 limbs with the one-signature formulas (_ext_add,
_ext_double).  The kernel runs four threads a signature; its rounds are
the _quad_* helpers below, and its entries carry 2d·T in place of T
(``KERNEL_CONSTS``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..crypto import _ed25519_ref as ref
from . import field16
from .ed25519_kernel import WINDOWS, _check

# Wrapper launches of the CUDA kernel in this process (a plain integer;
# callers reset it to 0 to count the launches of one run).
launches = 0


# --- constants --------------------------------------------------------------

def _build_b_table() -> list[list[list[int]]]:
    """i·B for i in 0..15 in extended coordinates (X, Y, Z = 1, T = xy),
    resting field16 limbs; entry 0 is the identity (0, 1, 1, 0)."""
    pts = [(0, 1)] + [ref.scalar_mult(i, ref.B) for i in range(1, 16)]
    return [[field16.balanced(x), field16.balanced(y), field16.balanced(1),
             field16.balanced(x * y % ref.P)] for x, y in pts]


B_TABLE = _build_b_table()

# D, 2D, sqrt(-1), then the [16][4][16] B table: the constants of
# verify_cols_plain, 1,072 int32 values.
CONSTS = (field16.balanced(ref.D) + field16.balanced(2 * ref.D % ref.P) +
          field16.balanced(ref.SQRT_M1) +
          [v for entry in B_TABLE for coord in entry for v in coord])

# The B entries as the kernel adds them: (X, Y, Z = 1, 2d·T).
B_TABLE_2DT = [entry[:3] + [field16.balanced(
    2 * ref.D * field16.from_limbs(entry[3]) % ref.P)] for entry in B_TABLE]

# The CUDA kernel's constant block, copied to shared memory by every
# block: D, 2D, sqrt(-1), then B_TABLE_2DT laid out [limb][entry][coord]
# (a quad reads coordinates c and c ^ 1 of its entry; the entry varies
# between quads) — 1,072 int32 values.
KERNEL_CONSTS = CONSTS[:3 * field16.LIMBS] + [
    B_TABLE_2DT[e][c][i] for i in range(field16.LIMBS) for e in range(16)
    for c in range(4)]


@functools.lru_cache(maxsize=8)
def _device_consts(device: torch.device) -> torch.Tensor:
    return torch.tensor(KERNEL_CONSTS, dtype=torch.int32, device=device)


# --- plain version: point arithmetic on (X, Y, Z, T) tuples -----------------

def _ext_add(p, q, two_d):
    """Unified add (add-2008-hwcd-3), complete for a = -1; 9 products."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = field16.mul(Y1 - X1, Y2 - X2)
    b = field16.mul(Y1 + X1, Y2 + X2)
    c = field16.mul(field16.mul(T1, T2), two_d)
    zz = field16.mul(Z1, Z2)
    d = zz + zz
    e, f, g, h = b - a, d - c, d + c, b + a
    return (field16.mul(e, f), field16.mul(g, h), field16.mul(f, g),
            field16.mul(e, h))


def _ext_double(p):
    """dbl-2008-hwcd, a = -1: 4 squarings and 4 products, T included."""
    X1, Y1, Z1, _ = p
    a = field16.sqr(X1)
    b = field16.sqr(Y1)
    zz = field16.sqr(Z1)
    c = zz + zz
    e = field16.sqr(X1 + Y1) - a - b
    g = b - a
    f = g - c
    h = -(a + b)
    return (field16.mul(e, f), field16.mul(g, h), field16.mul(f, g),
            field16.mul(e, h))


# --- the kernel's rounds: four threads a signature --------------------------
#
# The CUDA kernel runs the 4-way schedule of the extended-coordinate
# formulas: thread c of a quad keeps coordinate c of the running point and
# computes product c of a round.  Each helper below is one round per tensor
# expression (the four products as one batched multiply), with the
# kernel's operands: its limbs equal the kernel's.  They agree with the
# _ext_* formulas mod p, not limb for limb (the kernel's entries carry
# 2d·T, so C = T1·(2d·T2) is one product).  verify_cols_plain keeps the
# _ext_* formulas.

def _products(lhs, rhs):
    """One round: product c = lhs[c]·rhs[c] for c = 0..3, as one multiply."""
    ops = torch.broadcast_tensors(*lhs, *rhs)
    return field16.mul(torch.stack(ops[:4]), torch.stack(ops[4:])).unbind(0)


def _squares(xs):
    """One round of squarings: xs[c]² for c = 0..3."""
    return field16.sqr(torch.stack(torch.broadcast_tensors(*xs))).unbind(0)


def _quad_double(p):
    """dbl-2008-hwcd, a = -1, in 2 rounds: X², Y², Z², (X+Y)², then
    X3 = E·F, Y3 = G·H, Z3 = F·G, T3 = E·H."""
    X1, Y1, Z1, _ = p
    a, b, zz, s = _squares((X1, Y1, Z1, X1 + Y1))
    e, g, h = s - a - b, b - a, -a - b
    f = g - (zz + zz)
    return _products((e, g, f, e), (f, h, g, h))


def _quad_add(p, q):
    """Unified add (add-2008-hwcd-3) of an entry q = (X2, Y2, Z2, 2d·T2),
    in 2 rounds: (Y1-X1)(Y2-X2), (Y1+X1)(Y2+X2), Z1·Z2, T1·2dT2, then the
    products of _quad_double's round 2 with D = 2·Z1Z2."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2d = q
    a, b, zz, c = _products((Y1 - X1, Y1 + X1, Z1, T1),
                            (Y2 - X2, Y2 + X2, Z2, T2d))
    d = zz + zz
    e, f, g, h = b - a, d - c, d + c, b + a
    return _products((e, g, f, e), (f, h, g, h))


def _quad_entry(p, two_d):
    """A table entry as the kernel keeps it: (X, Y, Z, 2d·T), one more
    product."""
    X, Y, Z, T = p
    return X, Y, Z, field16.mul(T, two_d)


def _decompress(b, d_const, sqrt_m1, one):
    """[n, 32] byte values -> (x, y, valid) under ZIP-215: bit 255 is
    the sign of x and is cleared before y is read; y >= p stays."""
    b = b & 0xFF
    sign = b[:, 31] >> 7
    y = field16.carry(field16.from_bytes(
        torch.cat([b[:, :31], b[:, 31:] & 0x7F], 1)))
    yy = field16.sqr(y)
    u = yy - one
    v = field16.mul(yy, d_const) + one
    v3 = field16.mul(field16.sqr(v), v)
    v7 = field16.mul(field16.sqr(v3), v)
    x = field16.mul(field16.mul(u, v3),
                    field16.pow_p58(field16.mul(u, v7)))
    vxx = field16.mul(v, field16.sqr(x))
    ok_direct = field16.eq(vxx, u)
    ok_flip = field16.eq(vxx, -u)
    x = torch.where(ok_flip.unsqueeze(-1), field16.mul(x, sqrt_m1), x)
    wrong_sign = field16.parity(x) != sign
    x = torch.where(wrong_sign.unsqueeze(-1), -x, x)
    return x, y, ok_direct | ok_flip


def verify_cols_plain(a_cols: torch.Tensor, r_cols: torch.Tensor,
                      s_win: torch.Tensor, k_win: torch.Tensor
                      ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device.  Same
    arguments and result as ``verify_cols``."""
    _check(a_cols, r_cols, s_win, k_win)
    dev = a_cols.device
    n = a_cols.shape[1]
    L = field16.LIMBS
    consts = torch.tensor(CONSTS, dtype=torch.int64, device=dev)
    d_const = consts[0:L]
    two_d = consts[L:2 * L]
    sqrt_m1 = consts[2 * L:3 * L]
    b_tab = consts[3 * L:].reshape(16, 4, L)
    zero = torch.zeros(n, L, dtype=torch.int64, device=dev)
    one = zero.clone()
    one[:, 0] = 1
    lanes = torch.arange(n, device=dev)

    ax, ay, a_ok = _decompress(a_cols.t().long(), d_const, sqrt_m1, one)
    rx, ry, r_ok = _decompress(r_cols.t().long(), d_const, sqrt_m1, one)

    nax = -ax
    neg_a = (nax, ay, one, field16.mul(nax, ay))
    tab = [(zero, one, one, zero), neg_a]
    for _ in range(14):
        tab.append(_ext_add(tab[-1], neg_a, two_d))
    # [16, n, 4, 16]: entry, lane, coordinate, limb
    tab_t = torch.stack([torch.stack(e, 1) for e in tab])

    s_w = s_win.long() & 15
    k_w = k_win.long() & 15
    acc = (zero, one, one, zero)
    for j in range(WINDOWS):
        w = WINDOWS - 1 - j
        for _ in range(4):
            acc = _ext_double(acc)
        acc = _ext_add(acc, b_tab[s_w[w]].unbind(1), two_d)
        acc = _ext_add(acc, tab_t[k_w[w], lanes].unbind(1), two_d)

    nrx = -rx
    acc = _ext_add(acc, (nrx, ry, one, field16.mul(nrx, ry)), two_d)
    for _ in range(3):
        acc = _ext_double(acc)
    X, Y, Z, _ = acc
    return field16.is_zero(X) & field16.eq(Y, Z) & a_ok & r_ok


# --- the CUDA kernel's wrapper ----------------------------------------------

def verify_cols(a_cols: torch.Tensor, r_cols: torch.Tensor,
                s_win: torch.Tensor, k_win: torch.Tensor) -> torch.Tensor:
    """Verdicts ``[n]`` bool on the inputs' device.  CUDA tensors launch
    the kernel on the current stream (and raise if it cannot be built
    or launched); CPU tensors run ``verify_cols_plain``."""
    global launches
    _check(a_cols, r_cols, s_win, k_win)
    dev = a_cols.device
    if dev.type == "cpu":
        return verify_cols_plain(a_cols, r_cols, s_win, k_win)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = a_cols.shape[1]
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return ok
    from ._build import load
    lib = load()
    consts = _device_consts(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ed25519_verify8_launch(
            a_cols.data_ptr(), r_cols.data_ptr(), s_win.data_ptr(),
            k_win.data_ptr(), consts.data_ptr(), n, ok.data_ptr(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"ed25519_verify8 launch failed: "
            f"{lib.ed25519_error_string(rc).decode()} ({rc})")
    launches += 1
    return ok
