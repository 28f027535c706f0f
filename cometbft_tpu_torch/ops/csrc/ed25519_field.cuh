// Device functions of the batch ed25519 verifier (ZIP-215, cofactored)
// for Hopper (sm_90a): the field in radix 2^25.5, the point formulas and
// ZIP-215 decompression.  Shared by ed25519_verify.cu (the verify kernel)
// and microbench.cu (loops over the same primitives), so both run one
// source.  The plain PyTorch version of every function is
// cometbft_tpu_torch/ops/field.py and ops/ed25519_kernel.py; the two agree
// limb for limb.
//
//   * Field: 10 signed limbs in radix 2^25.5 (26/25 bits), int32 storage,
//     32x32->64 products (IMAD.WIDE).  Products below and above 2^255
//     accumulate separately; the upper sum folds in at weight 19.
//   * Overflow bound (pinned by tests/test_torch_field.py): carry() leaves
//     RESTING limbs, |limb| <= 2^25 (26-bit limbs) and about 2^24 (25-bit
//     limbs).  mul() takes operands that are sums of at most 4 resting
//     values (every call site stays inside that), so a doubled odd
//     limb is < 2^28 and every int64 accumulator is < 2^62; carry() of
//     anything < 2^62 is resting again.
//
// Everything is in an anonymous namespace: each source that includes
// this header gets its own copy, and nothing is exported.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LIMBS = 10;

// constant block layout (int32), built by ed25519_kernel.CONSTS
constexpr int C_D = 0;
constexpr int C_2D = 10;
constexpr int C_SQRTM1 = 20;
constexpr int C_BTAB = 30;                 // [16][3][10]
constexpr int C_TOTAL = 30 + 16 * 3 * 10;  // 510

struct fe { int32_t v[LIMBS]; };
struct ge { fe X, Y, Z, T; };              // extended coordinates

__device__ __forceinline__ int limb_bits(int i) { return (i & 1) ? 25 : 26; }

__device__ __forceinline__ void fe_zero(fe& h) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) h.v[i] = 0;
}

__device__ __forceinline__ void fe_one(fe& h) {
  fe_zero(h);
  h.v[0] = 1;
}

__device__ __forceinline__ void fe_add(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) h.v[i] = f.v[i] + g.v[i];
}

__device__ __forceinline__ void fe_sub(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) h.v[i] = f.v[i] - g.v[i];
}

__device__ __forceinline__ void fe_neg(fe& h, const fe& f) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) h.v[i] = -f.v[i];
}

// Balanced sequential carry (ops/field.carry): round-to-nearest quotient
// per limb, the carry out of limb 9 folds into limb 0 at weight 19, then
// limb 0 carries once more.
__device__ __forceinline__ void fe_carry(fe& out, int64_t h[LIMBS]) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    const int t = limb_bits(i);
    const int64_t q = (h[i] + (int64_t(1) << (t - 1))) >> t;
    h[i] -= q * (int64_t(1) << t);
    if (i < LIMBS - 1) h[i + 1] += q; else h[0] += 19 * q;
  }
  const int64_t q = (h[0] + (int64_t(1) << 25)) >> 26;
  h[0] -= q * (int64_t(1) << 26);
  h[1] += q;
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) out.v[i] = (int32_t)h[i];
}

// out may alias f or g: both are read in full before out is written.
__device__ __forceinline__ void fe_mul(fe& out, const fe& f, const fe& g) {
  int64_t lo[LIMBS], hi[LIMBS];
#pragma unroll
  for (int k = 0; k < LIMBS; ++k) { lo[k] = 0; hi[k] = 0; }
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    const int32_t fi = f.v[i];
    const int32_t fi2 = (i & 1) ? 2 * fi : fi;
#pragma unroll
    for (int j = 0; j < LIMBS; ++j) {
      const int64_t p = (int64_t)(((i & 1) && (j & 1)) ? fi2 : fi) * g.v[j];
      if (i + j < LIMBS) lo[i + j] += p; else hi[i + j - LIMBS] += p;
    }
  }
  int64_t h[LIMBS];
#pragma unroll
  for (int k = 0; k < LIMBS; ++k) h[k] = lo[k] + 19 * hi[k];
  fe_carry(out, h);
}

__device__ __forceinline__ void fe_sqr(fe& out, const fe& f) { fe_mul(out, f, f); }

__device__ __noinline__ void fe_pow2k(fe& x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) fe_sqr(x, x);
}

// x^((p-5)/8) = x^(2^252 - 3), same chain as ops/field.pow_p58.
__device__ __noinline__ void fe_pow_p58(fe& out, const fe& x) {
  fe x2, z9, z11, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0, t;
  fe_sqr(x2, x);
  fe_sqr(t, x2);
  fe_sqr(t, t);
  fe_mul(z9, x, t);
  fe_mul(z11, x2, z9);
  fe_sqr(t, z11);
  fe_mul(z_5_0, z9, t);
  t = z_5_0; fe_pow2k(t, 5);    fe_mul(z_10_0, t, z_5_0);
  t = z_10_0; fe_pow2k(t, 10);  fe_mul(z_20_0, t, z_10_0);
  t = z_20_0; fe_pow2k(t, 20);  fe_mul(t, t, z_20_0);          // 2^40 - 1
  fe_pow2k(t, 10);              fe_mul(z_50_0, t, z_10_0);
  t = z_50_0; fe_pow2k(t, 50);  fe_mul(z_100_0, t, z_50_0);
  t = z_100_0; fe_pow2k(t, 100); fe_mul(t, t, z_100_0);        // 2^200 - 1
  fe_pow2k(t, 50);              fe_mul(t, t, z_50_0);          // 2^250 - 1
  fe_pow2k(t, 2);
  fe_mul(out, t, x);
}

// Exact floor-carry sweep to limbs in [0, 2^t); returns the carry out of
// bit 255.
__device__ __forceinline__ int64_t sweep(int64_t c[LIMBS]) {
#pragma unroll
  for (int i = 0; i < LIMBS - 1; ++i) {
    const int t = limb_bits(i);
    c[i + 1] += c[i] >> t;
    c[i] &= (int64_t(1) << t) - 1;
  }
  const int64_t top = c[LIMBS - 1] >> 25;
  c[LIMBS - 1] &= (int64_t(1) << 25) - 1;
  return top;
}

// Canonical digits of x mod p (ops/field.canonical).
__device__ __noinline__ void fe_canonical(fe& out, const fe& x) {
  int64_t h[LIMBS];
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) h[i] = x.v[i];
  fe r;
  fe_carry(r, h);
  // + 2p = 2^256 - 38, as digits of 2^255 - 38 plus bit 255 in limb 9
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    const int64_t two_p = (i == 0) ? (int64_t(1) << 26) - 38
                        : (i == LIMBS - 1) ? (int64_t(1) << 26) - 1
                        : (int64_t(1) << limb_bits(i)) - 1;
    h[i] = (int64_t)r.v[i] + two_p;
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) h[0] += 19 * sweep(h);
  int64_t g[LIMBS];
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) g[i] = h[i];
  g[0] += 19;
  const bool ge_p = sweep(g) != 0;
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) out.v[i] = (int32_t)(ge_p ? g[i] : h[i]);
}

__device__ __forceinline__ bool fe_is_zero(const fe& x) {
  fe c;
  fe_canonical(c, x);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) acc |= c.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  fe d;
  fe_sub(d, a, b);
  return fe_is_zero(d);
}

__device__ __forceinline__ int fe_parity(const fe& x) {
  fe c;
  fe_canonical(c, x);
  return c.v[0] & 1;
}

__device__ __forceinline__ void fe_load(fe& h, const int32_t* src) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) h.v[i] = src[i];
}

// ---- point arithmetic (ops/ed25519_kernel._ext_add etc.) ------------------

// Unified add (add-2008-hwcd-3), complete for a = -1.  out may alias p or q.
__device__ __noinline__ void ge_add(ge& out, const ge& p, const ge& q,
                                    const fe& two_d, bool need_t) {
  fe a, b, c, d, e, f, g, h, t1, t2;
  fe_sub(t1, p.Y, p.X);
  fe_sub(t2, q.Y, q.X);
  fe_mul(a, t1, t2);
  fe_add(t1, p.Y, p.X);
  fe_add(t2, q.Y, q.X);
  fe_mul(b, t1, t2);
  fe_mul(c, p.T, q.T);
  fe_mul(c, c, two_d);
  fe_mul(d, p.Z, q.Z);
  fe_add(d, d, d);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(out.X, e, f);
  fe_mul(out.Y, g, h);
  fe_mul(out.Z, f, g);
  if (need_t) fe_mul(out.T, e, h);
}

// dbl-2008-hwcd, a = -1; never reads T.
__device__ __noinline__ void ge_double(ge& out, const ge& p, bool need_t) {
  fe a, b, c, e, f, g, h, t;
  fe_sqr(a, p.X);
  fe_sqr(b, p.Y);
  fe_sqr(c, p.Z);
  fe_add(c, c, c);
  fe_add(t, p.X, p.Y);
  fe_sqr(e, t);
  fe_sub(e, e, a);
  fe_sub(e, e, b);
  fe_sub(g, b, a);
  fe_sub(f, g, c);
  fe_add(h, a, b);
  fe_neg(h, h);
  fe_mul(out.X, e, f);
  fe_mul(out.Y, g, h);
  fe_mul(out.Z, f, g);
  if (need_t) fe_mul(out.T, e, h);
}

// Mixed add of an extended point and an affine entry (y-x, y+x, 2d·x·y).
__device__ __noinline__ void ge_madd(ge& out, const ge& p, const int32_t* q3) {
  fe ymx, ypx, t2d, a, b, c, d, e, f, g, h, t;
  fe_load(ymx, q3);
  fe_load(ypx, q3 + LIMBS);
  fe_load(t2d, q3 + 2 * LIMBS);
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, ymx);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, ypx);
  fe_mul(c, p.T, t2d);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(out.X, e, f);
  fe_mul(out.Y, g, h);
  fe_mul(out.Z, f, g);
  fe_mul(out.T, e, h);
}

// Bits 0..254 of a 32-byte little-endian column as 10 digits.
__device__ __forceinline__ void fe_from_bytes(fe& h, const int32_t b[32]) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    // limb i starts at bit ceil(25.5 i): 0, 26, 51, 77, ..., 230
    const int s = (51 * i + 1) / 2, t = limb_bits(i), b0 = s >> 3, sh = s & 7;
    int64_t w = b[b0] >> sh;
#pragma unroll
    for (int k = 1; k < 5; ++k)
      if (b0 + k < 32 && 8 * k - sh < t) w += (int64_t)b[b0 + k] << (8 * k - sh);
    h.v[i] = (int32_t)(w & ((int64_t(1) << t) - 1));
  }
}

// ZIP-215 decompression of one lane's 32-byte column; returns validity.
__device__ __noinline__ bool ge_decompress(fe& x, fe& y, const int32_t* col,
                                           int n, int lane, const int32_t* sc) {
  int32_t b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) b[i] = col[(size_t)i * n + lane] & 0xFF;
  const int sign = b[31] >> 7;
  fe one, d_const, sqrt_m1, yy, u, v, v3, v7, t, vxx, negu;
  fe_one(one);
  fe_load(d_const, sc + C_D);
  fe_load(sqrt_m1, sc + C_SQRTM1);
  fe_from_bytes(t, b);
  {
    int64_t h[LIMBS];
#pragma unroll
    for (int i = 0; i < LIMBS; ++i) h[i] = t.v[i];
    fe_carry(y, h);
  }
  fe_sqr(yy, y);
  fe_sub(u, yy, one);
  fe_mul(v, yy, d_const);
  fe_add(v, v, one);
  fe_sqr(t, v);
  fe_mul(v3, t, v);
  fe_sqr(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sqr(t, x);
  fe_mul(vxx, v, t);
  const bool ok_direct = fe_eq(vxx, u);
  fe_neg(negu, u);
  const bool ok_flip = fe_eq(vxx, negu);
  if (ok_flip) fe_mul(x, x, sqrt_m1);
  if (fe_parity(x) != sign) fe_neg(x, x);
  return ok_direct || ok_flip;
}

}  // namespace
