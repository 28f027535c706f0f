"""GF(2^255 - 19) on int64 torch tensors, in the second CUDA kernel's
radix: 16 signed limbs of 16 bits, the carry out of limb 15 folded into
limb 0 at 38 (2^256 = 2p + 38).

The plain counterpart of the field arithmetic in
ops/csrc/ed25519_verify8.cu, which replaces the Pallas kernel
cometbft_tpu/ops/ed25519_pallas8.py and its fold-38 field
(cometbft_tpu/ops/field.py, 32 limbs of 8 bits).  Every function here
repeats the kernel's integer operations, so the limbs agree exactly.

Why this radix.  The point of a second kernel is that it shares no field
code with the first (ops/field.py, radix 2^25.5, fold 19 at 2^255): it
checks that arithmetic instead of repeating its bugs.  Keeping the TPU
kernel's own 2^8 would need 1,024 products per multiply.  Radix 2^16
keeps its fold at 2^256, needs 256 products, and keeps every product
and every accumulator inside int64, so this plain version can repeat
the kernel step by step.

Representation: a field element is a ``[..., 16]`` int64 tensor; limb i
has weight 2^(16 i).  Values are redundant: limbs may be negative and
exceed 16 bits, and a value may reach 2^256.

Magnitude discipline (the kernel stores limbs in int32 and accumulates
products in int64; the bound is pinned by tests/test_torch_field16.py):

  * ``carry`` returns RESTING limbs, |limb i| <= RESTING[i] (2^15 for
    every limb but limb 1, which takes the second carry out of limb 0).
  * ``mul``/``sqr`` accept LAZY operands: sums or differences of at most
    MAX_LAZY resting values.  With both operands at that bound every
    accumulator stays under MUL_ACC_LIMIT (mul_acc_bound), and the carry
    of anything under the limit is resting again (carry_bound).
"""
from __future__ import annotations

import functools

import torch

P = 2**255 - 19
LIMBS = 16
BITS = 16
FOLD = 38                       # 2^256 mod p
FOLD255 = 19                    # 2^255 mod p
MAX_LAZY = 4                    # resting values per mul operand
MUL_ACC_LIMIT = 1 << 44         # bound on every mul accumulator
_HALF = 1 << (BITS - 1)
_MASK = (1 << BITS) - 1


# --- host helpers -----------------------------------------------------------

def to_limbs(x: int) -> list[int]:
    """Python int -> 16 canonical digits of x mod p."""
    x %= P
    return [(x >> (BITS * i)) & _MASK for i in range(LIMBS)]


def from_limbs(limbs) -> int:
    """Limbs (any redundancy; list or [16] tensor) -> int mod p."""
    vals = limbs.tolist() if isinstance(limbs, torch.Tensor) else limbs
    return sum(int(v) << (BITS * i) for i, v in enumerate(vals)) % P


def _carry_ints(h: list[int]) -> list[int]:
    """carry() on Python ints (host-side constant balancing)."""
    h = list(h)
    for i in range(LIMBS):
        q = (h[i] + _HALF) >> BITS
        h[i] -= q << BITS
        if i < LIMBS - 1:
            h[i + 1] += q
        else:
            h[0] += FOLD * q
    q = (h[0] + _HALF) >> BITS
    h[0] -= q << BITS
    h[1] += q
    return h


def balanced(x: int) -> list[int]:
    """Resting (carried) limbs of x mod p: how constants ship to the
    kernel."""
    return _carry_ints(to_limbs(x))


# --- bound analysis (pure Python; pinned by the tests) ----------------------

def mul_acc_bound(ba, bb) -> list[int]:
    """Largest |accumulator| of mul for |f_i| <= ba[i], |g_j| <= bb[j]:
    products at or above 2^256 land in limb i + j - 16 at weight 38."""
    acc = [0] * LIMBS
    for i in range(LIMBS):
        for j in range(LIMBS):
            w = FOLD if i + j >= LIMBS else 1
            acc[(i + j) % LIMBS] += w * ba[i] * bb[j]
    return acc


def carry_bound(bh) -> list[int]:
    """Largest |limb| out of carry for |h_i| <= bh[i] (interval
    propagation through the same sequential chain)."""
    b = list(bh)
    out = [0] * LIMBS
    for i in range(LIMBS):
        q = (b[i] + _HALF) >> BITS
        out[i] = _HALF
        if i < LIMBS - 1:
            b[i + 1] += q
        else:
            out[0] += FOLD * q
    q = (out[0] + _HALF) >> BITS
    out[0] = _HALF
    out[1] += q
    return out


RESTING = carry_bound([MUL_ACC_LIMIT] * LIMBS)

# 2p = 2^256 - 38 as 16-bit digits: what canonical adds to make a carried
# value positive
TWO_P = [(1 << BITS) - 38] + [_MASK] * (LIMBS - 1)


# --- arithmetic -------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _mul_tables(device: torch.device):
    coef = torch.tensor([[FOLD if i + j >= LIMBS else 1 for j in range(LIMBS)]
                         for i in range(LIMBS)], dtype=torch.int64,
                        device=device)
    target = torch.tensor([(i + j) % LIMBS for i in range(LIMBS)
                           for j in range(LIMBS)], dtype=torch.int64,
                          device=device)
    return coef, target


def carry(h: torch.Tensor) -> torch.Tensor:
    """Balanced (round-to-nearest) sequential carry; the carry out of
    limb 15 folds into limb 0 at weight 38, then limb 0 carries once
    more.  Output limbs are RESTING."""
    c = list(h.unbind(-1))
    for i in range(LIMBS):
        q = (c[i] + _HALF) >> BITS
        c[i] = c[i] - q * (1 << BITS)
        if i < LIMBS - 1:
            c[i + 1] = c[i + 1] + q
        else:
            c[0] = c[0] + FOLD * q
    q = (c[0] + _HALF) >> BITS
    c[0] = c[0] - q * (1 << BITS)
    c[1] = c[1] + q
    return torch.stack(c, -1)


def _product(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    coef, target = _mul_tables(f.device)
    prod = f.unsqueeze(-1) * g.unsqueeze(-2) * coef
    shape = torch.broadcast_shapes(f.shape, g.shape)
    acc = torch.zeros(shape, dtype=torch.int64, device=f.device)
    acc.index_add_(-1, target, prod.flatten(-2))
    return carry(acc)


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """f * g mod p for LAZY operands; output RESTING.  The kernel sums
    the products below and above 2^256 separately and folds the upper
    sum at 38; the integer accumulators are the same."""
    return _product(f, g)


def sqr(f: torch.Tensor) -> torch.Tensor:
    """f^2 mod p.  The kernel takes each cross product once against a
    doubled limb (136 products); the accumulators equal mul's."""
    return _product(f, f)


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


def _sweep255(c: list) -> torch.Tensor:
    """Exact floor-carry sweep to digits of bits 0..254 (limb 15 keeps
    15 bits); returns the carry out of bit 255, which the caller folds
    back at 19."""
    for i in range(LIMBS - 1):
        c[i + 1] = c[i + 1] + (c[i] >> BITS)
        c[i] = c[i] & _MASK
    top = c[LIMBS - 1] >> (BITS - 1)
    c[LIMBS - 1] = c[LIMBS - 1] & (_HALF - 1)
    return top


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Unique representative in [0, p) as 16-bit digits, for a LAZY x.

    carry -> |value| < 2p; + 2p -> positive and below 2^257; two sweeps
    to 255 bits, each folding its carry out of bit 255 at 19 (values
    reach 2^256 in this radix, so bit 255 is folded here, before the
    compare) -> [0, 2^255); then subtract p iff value + 19 reaches
    2^255."""
    c = list(carry(x).unbind(-1))
    c = [c[i] + TWO_P[i] for i in range(LIMBS)]
    for _ in range(2):
        top = _sweep255(c)
        c[0] = c[0] + FOLD255 * top
    g = list(c)
    g[0] = g[0] + FOLD255
    ge_p = _sweep255(g) != 0
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
    """[..., 32] int64 byte values -> [..., 16] limbs of all 256 bits,
    limb i = byte 2i + 256 * byte 2i+1.  Bit 255 stays where it is (the
    fold at 2^256 carries it); a caller decoding a point clears it
    first."""
    b = b & 0xFF
    return b[..., 0::2] + (b[..., 1::2] << 8)
