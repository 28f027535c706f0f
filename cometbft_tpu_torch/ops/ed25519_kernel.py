"""Batch ed25519 verification: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of cometbft_tpu/ops/ed25519_pallas.py (``_kernel``, :379,
launched by ``_pallas_verify``, :469).  Same function, same public
layout: A and R as ``[32, n]`` int32 byte columns, s and k as
``[64, n]`` int32 4-bit windows (little-endian, window 0 lowest), one
verdict per lane out.  Per lane it checks the ZIP-215 cofactored
equation [8](s·B - R - k·A) == identity:

  1. decompress A and R (non-canonical y accepted, "negative zero" x
     accepted, no square root -> invalid lane);
  2. build the 16-entry table i·(-A) with 14 unified adds;
  3. run 64 windows from the top: 4 doublings, a mixed add of the
     affine B-table entry of the s window, a unified add of the lane
     table entry of the k window;
  4. add -R, double 3 times, test X == 0 and Y == Z, AND both
     decompression flags.

``verify_cols`` launches ops/csrc/ed25519_verify.cu for CUDA tensors
and runs ``verify_cols_plain`` for CPU tensors; nothing else picks
between them.  ``verify_cols_plain`` repeats the kernel's arithmetic
step by step on ``[n, 10]`` int64 limbs (ops/field.py), so a mismatch
can be traced to one primitive.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..crypto import _ed25519_ref as ref
from . import field

WINDOWS = 64

# Wrapper launches of the CUDA kernel in this process (a plain integer;
# callers reset it to 0 to count the launches of one run).
launches = 0


# --- constants --------------------------------------------------------------

def _build_b_table() -> list[list[list[int]]]:
    """i·B for i in 0..15 in affine precomputed form (y-x, y+x, 2d·x·y),
    resting limbs; entry 0 is the identity (1, 1, 0)."""
    pts = [(0, 1)] + [ref.scalar_mult(i, ref.B) for i in range(1, 16)]
    return [[field.balanced((y - x) % ref.P),
             field.balanced((y + x) % ref.P),
             field.balanced(2 * ref.D * x * y % ref.P)] for x, y in pts]


B_TABLE = _build_b_table()

# The kernel's constant block: D, 2D, sqrt(-1), then the [16][3][10]
# B table — 510 int32 values, copied to shared memory by every block.
CONSTS = (field.balanced(ref.D) + field.balanced(2 * ref.D % ref.P) +
          field.balanced(ref.SQRT_M1) +
          [v for entry in B_TABLE for coord in entry for v in coord])


@functools.lru_cache(maxsize=8)
def _device_consts(device: torch.device) -> torch.Tensor:
    return torch.tensor(CONSTS, dtype=torch.int32, device=device)


# --- plain version: point arithmetic on (X, Y, Z, T) tuples -----------------

def _ext_add(p, q, two_d, need_t=True):
    """Unified add (add-2008-hwcd-3), complete for a = -1."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = field.mul(Y1 - X1, Y2 - X2)
    b = field.mul(Y1 + X1, Y2 + X2)
    c = field.mul(field.mul(T1, T2), two_d)
    zz = field.mul(Z1, Z2)
    d = zz + zz
    e, f, g, h = b - a, d - c, d + c, b + a
    return (field.mul(e, f), field.mul(g, h), field.mul(f, g),
            field.mul(e, h) if need_t else None)


def _ext_double(p, need_t=True):
    """dbl-2008-hwcd, a = -1; never reads T, so a run of doublings only
    produces T on the last one."""
    X1, Y1, Z1, _ = p
    a = field.sqr(X1)
    b = field.sqr(Y1)
    zz = field.sqr(Z1)
    c = zz + zz
    e = field.sqr(X1 + Y1) - a - b
    g = b - a
    f = g - c
    h = -(a + b)
    return (field.mul(e, f), field.mul(g, h), field.mul(f, g),
            field.mul(e, h) if need_t else None)


def _madd_affine(p, q3):
    """Mixed add of an extended point and an affine precomputed entry
    (y-x, y+x, 2d·x·y) with Z2 = 1: 7 products instead of 9."""
    X1, Y1, Z1, T1 = p
    ymx, ypx, t2d = q3
    a = field.mul(Y1 - X1, ymx)
    b = field.mul(Y1 + X1, ypx)
    c = field.mul(T1, t2d)
    d = Z1 + Z1
    e, f, g, h = b - a, d - c, d + c, b + a
    return (field.mul(e, f), field.mul(g, h), field.mul(f, g),
            field.mul(e, h))


# --- the kernel's rounds: four threads a signature --------------------------
#
# The CUDA kernel runs the 4-way schedule of the extended-coordinate
# formulas: thread c of a quad computes product c of a round, and the quad
# gathers the four.  Each helper below is one round per tensor expression
# (the four products as one batched multiply).  They agree with the
# _ext_* formulas mod p, not limb for limb: the kernel multiplies by 2d
# and 2Z in another order.  verify_cols_plain keeps the _ext_* formulas,
# so its op count (the kernel's bound) does not move.

def _products(lhs, rhs):
    """One round: product c = lhs[c]·rhs[c] for c = 0..3, as one multiply."""
    ops = torch.broadcast_tensors(*lhs, *rhs)
    return field.mul(torch.stack(ops[:4]), torch.stack(ops[4:])).unbind(0)


def _squares(xs):
    """One round of squarings: xs[c]² for c = 0..3 (the kernel's
    dedicated fe_sqr, limb for limb field.sqr)."""
    return field.sqr(torch.stack(torch.broadcast_tensors(*xs))).unbind(0)


def _quad_finish(e, f, g, h):
    """Round 2 of an add or a double: X3 = E·F, Y3 = G·H, Z3 = F·G,
    T3 = E·H."""
    return _products((e, g, f, e), (f, h, g, h))


def _quad_double(p):
    """dbl-2008-hwcd, a = -1, in 2 rounds: X², Y², Z², (X+Y)², then the
    four products of _quad_finish.  T comes free."""
    X1, Y1, Z1, _ = p
    a, b, zz, s = _squares((X1, Y1, Z1, X1 + Y1))
    g = b - a
    return _quad_finish(s - a - b, g - (zz + zz), g, -(a + b))


def _cached(p, two_d):
    """The cached form (Y-X, Y+X, 2d·T, 2Z) the kernel keeps its lane
    table in."""
    X, Y, Z, T = p
    return Y - X, Y + X, field.mul(T, two_d), Z + Z


def _quad_add_cached(p, q):
    """p + Q for Q in cached form (add-2008-hwcd-3) in 2 rounds: round 1
    is (Y1-X1)·YmX, (Y1+X1)·YpX, T1·2dT, Z1·2Z."""
    X1, Y1, Z1, T1 = p
    a, b, c, d = _products((Y1 - X1, Y1 + X1, T1, Z1), q)
    return _quad_finish(b - a, d - c, d + c, b + a)


def _quad_madd(p, q3, two_d):
    """p + an affine entry (y-x, y+x, 2d·x·y), Z2 = 1, in 2 rounds.
    D = 2·Z1 needs no product, so round 1's fourth slot computes 2d·T1,
    the cached coordinate of p.  Returns (p + q, 2d·T1)."""
    X1, Y1, Z1, T1 = p
    a, b, c, t2d = _products((Y1 - X1, Y1 + X1, T1, T1), (*q3, two_d))
    d = Z1 + Z1
    return _quad_finish(b - a, d - c, d + c, b + a), t2d


def _decompress(b, d_const, sqrt_m1, one):
    """[n, 32] byte values -> (x, y, valid) under ZIP-215."""
    sign = (b[:, 31] & 0xFF) >> 7
    y = field.carry(field.from_bytes(b))
    yy = field.sqr(y)
    u = yy - one
    v = field.mul(yy, d_const) + one
    v3 = field.mul(field.sqr(v), v)
    v7 = field.mul(field.sqr(v3), v)
    x = field.mul(field.mul(u, v3), field.pow_p58(field.mul(u, v7)))
    vxx = field.mul(v, field.sqr(x))
    ok_direct = field.eq(vxx, u)
    ok_flip = field.eq(vxx, -u)
    x = torch.where(ok_flip.unsqueeze(-1), field.mul(x, sqrt_m1), x)
    wrong_sign = field.parity(x) != sign
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
    consts = torch.tensor(CONSTS, dtype=torch.int64, device=dev)
    d_const = consts[0:10]
    two_d = consts[10:20]
    sqrt_m1 = consts[20:30]
    b_tab = consts[30:].reshape(16, 3, field.LIMBS)
    zero = torch.zeros(n, field.LIMBS, dtype=torch.int64, device=dev)
    one = zero.clone()
    one[:, 0] = 1
    lanes = torch.arange(n, device=dev)

    ax, ay, a_ok = _decompress(a_cols.t().long(), d_const, sqrt_m1, one)
    rx, ry, r_ok = _decompress(r_cols.t().long(), d_const, sqrt_m1, one)

    nax = -ax
    neg_a = (nax, ay, one, field.mul(nax, ay))
    tab = [(zero, one, one, zero), neg_a]
    for _ in range(14):
        tab.append(_ext_add(tab[-1], neg_a, two_d))
    # [16, n, 4, 10]: entry, lane, coordinate, limb
    tab_t = torch.stack([torch.stack(e, 1) for e in tab])

    s_w = s_win.long() & 15
    k_w = k_win.long() & 15
    acc = (zero, one, one, zero)
    for j in range(WINDOWS):
        w = WINDOWS - 1 - j
        for i in range(4):
            acc = _ext_double(acc, need_t=(i == 3))
        bq = b_tab[s_w[w]]                                  # [n, 3, 10]
        acc = _madd_affine(acc, bq.unbind(1))
        lq = tab_t[k_w[w], lanes]                           # [n, 4, 10]
        acc = _ext_add(acc, lq.unbind(1), two_d)

    nrx = -rx
    acc = _ext_add(acc, (nrx, ry, one, field.mul(nrx, ry)), two_d,
                   need_t=False)
    for _ in range(3):
        acc = _ext_double(acc, need_t=False)
    X, Y, Z, _ = acc
    return field.is_zero(X) & field.eq(Y, Z) & a_ok & r_ok


# --- the CUDA kernel's wrapper ----------------------------------------------

def _check(a_cols, r_cols, s_win, k_win) -> None:
    args = (("a_cols", a_cols, 32), ("r_cols", r_cols, 32),
            ("s_win", s_win, WINDOWS), ("k_win", k_win, WINDOWS))
    for name, t, _ in args:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    n = a_cols.shape[-1] if a_cols.dim() == 2 else -1
    for name, t, rows in args:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != rows or t.shape[1] != n:
            raise ValueError(
                f"{name} must have shape [{rows}, n] with one n for all "
                f"inputs, got {list(t.shape)}")
        if t.device != a_cols.device:
            raise ValueError(f"{name} is on {t.device}, a_cols on "
                             f"{a_cols.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
        rc = lib.ed25519_verify_launch(
            a_cols.data_ptr(), r_cols.data_ptr(), s_win.data_ptr(),
            k_win.data_ptr(), consts.data_ptr(), n, ok.data_ptr(),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"ed25519_verify launch failed: "
            f"{lib.ed25519_error_string(rc).decode()} ({rc})")
    launches += 1
    return ok
