"""GF(2^255 - 19) on int64 torch tensors, in the CUDA kernel's radix.

The plain counterpart of the arithmetic in ops/csrc/ed25519_verify.cu
(and of cometbft_tpu/ops/field.py and ops/field24.py, whose layouts were
chosen for the TPU and are not copied).  Every function here repeats
the kernel's integer operations in the same order, so the limbs agree
exactly, not only their values mod p.

Representation: a field element is a ``[..., 10]`` int64 tensor of
signed limbs in radix 2^25.5 — limb i holds bits [OFFSETS[i],
OFFSETS[i+1]), alternately 26 and 25 bits wide, as in ref10.  Values
are redundant: limbs may be negative and exceed their width.

Magnitude discipline (the kernel keeps its limbs in int32 and its
products in int64; the bound is pinned by tests/test_torch_field.py):

  * ``carry`` returns RESTING limbs, |limb i| <= RESTING[i]
    (2^25 for the 26-bit limbs, about 2^24 for the 25-bit ones).
  * ``mul``/``sqr`` accept LAZY operands: sums or differences of at most
    4 resting values.  With both operands at 4x resting, every 64-bit
    accumulator stays below MUL_ACC_LIMIT = 2^62 (mul_acc_bound), the
    doubled odd limbs stay below 2^31, and the carry of anything below
    2^62 lands back inside RESTING (carry_bound) — so the discipline is
    closed.

The JAX field's helpers (``constant``, ``carry_fold``, ``normalize``,
``add``, ``sub``, ``neg``, ``mul_const``, ``bytes_to_limbs``,
``canonical_bytes``) are here too, on this layout: they keep the value
mod p, not the JAX limbs, and the kernel does not use them.
"""
from __future__ import annotations

import functools

import torch

from ..device import resolve

P = 2**255 - 19
LIMBS = 10
SIZES = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255)
FOLD = 19                       # 2^255 mod p
MAX_LAZY = 4                    # resting values per mul operand
MUL_ACC_LIMIT = 1 << 62         # bound on every mul accumulator


# --- host helpers -----------------------------------------------------------

def to_limbs(x: int) -> list[int]:
    """Python int -> 10 canonical digits of x mod p."""
    x %= P
    return [(x >> OFFSETS[i]) & ((1 << SIZES[i]) - 1) for i in range(LIMBS)]


def from_limbs(limbs) -> int:
    """Limbs (any redundancy; list or [10] tensor) -> int mod p."""
    vals = limbs.tolist() if isinstance(limbs, torch.Tensor) else limbs
    return sum(int(v) << OFFSETS[i] for i, v in enumerate(vals)) % P


def constant(x: int, device=None) -> torch.Tensor:
    """The canonical limbs of x mod p as a ``[10]`` int64 tensor."""
    return torch.tensor(to_limbs(x), dtype=torch.int64,
                        device=resolve(device))


def _carry_ints(h: list[int]) -> list[int]:
    """carry() on Python ints (host-side constant balancing)."""
    h = list(h)
    for i in range(LIMBS):
        t = SIZES[i]
        q = (h[i] + (1 << (t - 1))) >> t
        h[i] -= q << t
        if i < LIMBS - 1:
            h[i + 1] += q
        else:
            h[0] += FOLD * q
    q = (h[0] + (1 << 25)) >> 26
    h[0] -= q << 26
    h[1] += q
    return h


def balanced(x: int) -> list[int]:
    """Resting (carried) limbs of x mod p: how constants ship to the
    kernel, so they enter products under the same bound as any
    carried value."""
    return _carry_ints(to_limbs(x))


# --- bound analysis (pure Python; pinned by the tests) ----------------------

def _coef(i: int, j: int) -> int:
    """Weight of f_i * g_j in product limb (i + j) mod 10: 2 when both
    limbs are odd (25.5-bit offsets round up twice), 19 when the product
    wraps past 2^255."""
    c = 2 if (i & 1) and (j & 1) else 1
    return c * FOLD if i + j >= LIMBS else c


def mul_acc_bound(ba, bb) -> list[int]:
    """Largest |accumulator| of mul for |f_i| <= ba[i], |g_j| <= bb[j]."""
    acc = [0] * LIMBS
    for i in range(LIMBS):
        for j in range(LIMBS):
            acc[(i + j) % LIMBS] += _coef(i, j) * ba[i] * bb[j]
    return acc


def carry_bound(bh) -> list[int]:
    """Largest |limb| out of carry for |h_i| <= bh[i] (interval
    propagation through the same sequential chain)."""
    b = list(bh)
    out = [0] * LIMBS
    for i in range(LIMBS):
        t = SIZES[i]
        q = (b[i] + (1 << (t - 1))) >> t
        out[i] = 1 << (t - 1)
        if i < LIMBS - 1:
            b[i + 1] += q
        else:
            out[0] += FOLD * q
    q = (out[0] + (1 << 25)) >> 26
    out[0] = 1 << 25
    out[1] += q
    return out


RESTING = carry_bound([MUL_ACC_LIMIT] * LIMBS)


# --- device constants -------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _mul_tables(device: torch.device):
    coef = torch.tensor([[_coef(i, j) for j in range(LIMBS)]
                         for i in range(LIMBS)], dtype=torch.int64,
                        device=device)
    target = torch.tensor([(i + j) % LIMBS for i in range(LIMBS)
                           for j in range(LIMBS)], dtype=torch.int64,
                          device=device)
    return coef, target


_TWO_P = [(2 * P >> OFFSETS[i]) & ((1 << SIZES[i]) - 1) for i in range(LIMBS)]
_TWO_P[LIMBS - 1] += 1 << SIZES[LIMBS - 1]    # 2p = 2^256 - 38 spans 256 bits


# --- arithmetic -------------------------------------------------------------

def carry(h: torch.Tensor) -> torch.Tensor:
    """Balanced (round-to-nearest) sequential carry; the carry out of
    limb 9 folds into limb 0 at weight 19, then limb 0 carries once
    more.  Output limbs are RESTING."""
    c = list(h.unbind(-1))
    for i in range(LIMBS):
        t = SIZES[i]
        q = (c[i] + (1 << (t - 1))) >> t
        c[i] = c[i] - q * (1 << t)
        if i < LIMBS - 1:
            c[i + 1] = c[i + 1] + q
        else:
            c[0] = c[0] + FOLD * q
    q = (c[0] + (1 << 25)) >> 26
    c[0] = c[0] - q * (1 << 26)
    c[1] = c[1] + q
    return torch.stack(c, -1)


def carry_fold(x: torch.Tensor) -> torch.Tensor:
    """One parallel floor-carry pass: each limb keeps its low bits and
    passes the rest to the next; the carry out of limb 9 folds into
    limb 0 at weight 19.  The value mod p is kept; magnitudes shrink by
    a limb's width a pass.  Negative limbs floor (arithmetic shift)."""
    c = [x[..., i] >> SIZES[i] for i in range(LIMBS)]
    lo = [x[..., i] & ((1 << SIZES[i]) - 1) for i in range(LIMBS)]
    return torch.stack([lo[0] + FOLD * c[LIMBS - 1]] +
                       [lo[i] + c[i - 1] for i in range(1, LIMBS)], -1)


def normalize(x: torch.Tensor, passes: int = 4) -> torch.Tensor:
    for _ in range(passes):
        x = carry_fold(x)
    return x


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x - y


def neg(x: torch.Tensor) -> torch.Tensor:
    return -x


def mul_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply a RESTING x by a small nonnegative int (< 2^15); output
    RESTING."""
    return carry(x * c)


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """f * g mod p for LAZY operands; output RESTING.  The kernel sums
    the products below and above 2^255 separately and folds the upper
    sum at weight 19; the integer accumulators are the same."""
    coef, target = _mul_tables(f.device)
    prod = f.unsqueeze(-1) * g.unsqueeze(-2) * coef
    shape = torch.broadcast_shapes(f.shape, g.shape)
    acc = torch.zeros(shape, dtype=torch.int64, device=f.device)
    acc.index_add_(-1, target, prod.flatten(-2))
    return carry(acc)


def sqr(f: torch.Tensor) -> torch.Tensor:
    return mul(f, f)


def pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        x = sqr(x)
    return x


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3), the standard ed25519 chain."""
    x2 = sqr(x)                                   # 2
    z9 = mul(x, sqr(sqr(x2)))                     # 9
    z11 = mul(x2, z9)                             # 11
    z_5_0 = mul(z9, sqr(z11))                     # 2^5 - 1
    z_10_0 = mul(pow2k(z_5_0, 5), z_5_0)
    z_20_0 = mul(pow2k(z_10_0, 10), z_10_0)
    z_40_0 = mul(pow2k(z_20_0, 20), z_20_0)
    z_50_0 = mul(pow2k(z_40_0, 10), z_10_0)
    z_100_0 = mul(pow2k(z_50_0, 50), z_50_0)
    z_200_0 = mul(pow2k(z_100_0, 100), z_100_0)
    z_250_0 = mul(pow2k(z_200_0, 50), z_50_0)
    return mul(pow2k(z_250_0, 2), x)              # 2^252 - 3


def _sweep(c: list) -> torch.Tensor:
    """Exact floor-carry sweep: limbs -> [0, 2^t); returns the carry
    out of bit 255."""
    for i in range(LIMBS - 1):
        t = SIZES[i]
        c[i + 1] = c[i + 1] + (c[i] >> t)
        c[i] = c[i] & ((1 << t) - 1)
    top = c[LIMBS - 1] >> SIZES[LIMBS - 1]
    c[LIMBS - 1] = c[LIMBS - 1] & ((1 << SIZES[LIMBS - 1]) - 1)
    return top


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Unique representative in [0, p) as canonical digits, for a LAZY x.

    carry -> |value| < 2p; + 2p -> positive; two floor sweeps, each
    folding its carry out of bit 255 at weight 19 -> [0, 2^255); then
    subtract p iff value + 19 reaches 2^255."""
    c = list(carry(x).unbind(-1))
    c = [c[i] + _TWO_P[i] for i in range(LIMBS)]
    for _ in range(2):
        top = _sweep(c)
        c[0] = c[0] + FOLD * top
    g = list(c)
    g[0] = g[0] + FOLD
    ge_p = _sweep(g) != 0
    return torch.stack([torch.where(ge_p, g[i], c[i]) for i in range(LIMBS)],
                       -1)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return (canonical(x) == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(a - b)


def parity(x: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical value (the ed25519 sign-of-x bit)."""
    return canonical(x)[..., 0] & 1


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] int64 byte values -> [..., 10] digits of bits 0..254
    (bit 255, the sign of x in a point encoding, is dropped; y >= p
    stays as it is — ZIP-215 decoding relies on that)."""
    b = b & 0xFF
    out = []
    for i in range(LIMBS):
        s, t = OFFSETS[i], SIZES[i]
        b0, sh = s >> 3, s & 7
        w = b[..., b0] >> sh
        for k in range(1, 5):
            if b0 + k < 32 and 8 * k - sh < t:
                w = w + (b[..., b0 + k] << (8 * k - sh))
        out.append(w & ((1 << t) - 1))
    return torch.stack(out, -1)


def bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] byte values -> [..., 10] limbs of all 256 bits, with no
    reduction: bit 255 rides on top of limb 9, and values >= p stay as
    they are in the redundant representation."""
    top = (b[..., 31].to(torch.int64) >> 7) << SIZES[LIMBS - 1]
    out = from_bytes(b.to(torch.int64))
    return torch.cat([out[..., :LIMBS - 1],
                      (out[..., LIMBS - 1] + top).unsqueeze(-1)], -1)


def canonical_bytes(x: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 canonical little-endian encoding of a LAZY x."""
    c = canonical(x)
    out = []
    for k in range(32):
        lo = 8 * k
        v = torch.zeros_like(c[..., 0])
        for i in range(LIMBS):
            s, e = OFFSETS[i], OFFSETS[i + 1]
            if e <= lo or s >= lo + 8:
                continue
            v = v | (c[..., i] << (s - lo) if s >= lo
                     else c[..., i] >> (lo - s))
        out.append(v & 0xFF)
    return torch.stack(out, -1).to(torch.uint8)
