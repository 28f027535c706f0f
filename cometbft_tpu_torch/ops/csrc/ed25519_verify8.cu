// Batch ed25519 verification (ZIP-215, cofactored) for Hopper (sm_90a),
// second kernel.
//
// Replaces the Pallas TPU kernel cometbft_tpu/ops/ed25519_pallas8.py
// (_kernel, :247; launched by _pallas_verify, :345), the first-generation
// kernel behind COMETBFT_TPU_KERNEL=pallas8.  Same function and the same
// public layout as ed25519_verify.cu: A and R as [32, n] int32 byte
// columns, s and k as [64, n] int32 4-bit windows; one verdict byte per
// lane out.  It is selected with COMETBFT_TPU_TORCH_KERNEL=cuda8.  The
// plain PyTorch version of the function is
// cometbft_tpu_torch/ops/ed25519_kernel8.py (verify_cols_plain) on
// ops/field16.py; the rounds below are its _quad_* helpers.
//
// It shares no code with ed25519_verify.cu or ed25519_field.cuh, so each
// checks the other.  From the TPU kernel it takes the function and the
// algorithmic choices, and it keeps them where B1 chose otherwise:
//   * Field: 16 signed limbs of 16 bits in int32, products in int64, the
//     carry out of limb 15 folded into limb 0 at 38 (2^256 = 2p + 38), a
//     sequential carry.  Values reach 2^256, so canonical() sweeps to 255
//     bits and folds bit 255 at 19 before it compares with p.
//   * Overflow bound (pinned by tests/test_torch_field16.py): carry()
//     leaves RESTING limbs, |limb| <= 2^15 except limb 1 (< 2^17.6).
//     mul() takes operands that are sums of at most 4 resting values;
//     every int64 accumulator is then < 2^44, and carry() of anything
//     < 2^44 is resting again.  tests/test_torch_ed25519_8_quad.py checks
//     every product operand of the schedule against that bound.
//   * Table entries are full extended points, every add is the unified
//     add (Z2 stays an operand, also for a B entry with Z = 1), and every
//     double and add makes T.  B1 keeps cached entries and mixed adds.
//
// Bound on this card: integer issue (the bound's formula is in PERF.md).
// One thread a signature, as this kernel first ran, left it latency-bound:
// a 4,096-lane tile was 128 warps on 528 schedulers, and one thread's
// chain of ~3,900 dependent 256-product multiplies set the time.  The
// design shortens the chain and fills the schedulers:
//
//   * A quad per signature.  Lanes 4q..4q+3 of a warp own signature q.
//     Thread c keeps only coordinate c of the running point (X, Y, Z, T):
//     16 int32 registers.  Each round of the 4-way extended-coordinate
//     formulas (Hisil, Wong, Carter, Dawson, "Twisted Edwards Curves
//     Revisited", 2008) is one field product a thread:
//       doubling (dbl-2008-hwcd)   round 1: X², Y², Z², (X+Y)²
//       unified add (add-2008-hwcd-3)  round 1: (Y1-X1)(Y2-X2),
//                                  (Y1+X1)(Y2+X2), Z1·Z2, T1·(2d·T2)
//       both, round 2: X3 = E·F, Y3 = G·H, Z3 = F·G, T3 = E·H.
//     A round fetches by __shfl_sync (width 4) only what the thread needs
//     to form its operands: X and Y for (X+Y)² (32 shuffles), the partner's
//     coordinate for Y1±X1 (16), the other three round-1 products for E,
//     F, G, H (48, by xor 1, 2, 3).  Fetched values are used and dropped;
//     no thread ever holds the whole point.  Operands are small integer
//     combinations of the fetched values, with coefficients chosen by c,
//     so no register is indexed at run time.
//   * Every thread runs every shuffle: a thread past the last signature
//     computes on the last lane and only thread 0 of a real quad stores.
//     The data-dependent steps of decompression are selects.
//   * Decompression of A (threads 0, 2) and R (threads 1, 3) runs side by
//     side, the same instructions on different data.
//   * Entries carry 2d·T in place of T, so the add's C = T1·(2d·T2) is one
//     product and the add is two rounds.  The B entries come so from the
//     host (ed25519_kernel8.KERNEL_CONSTS); a lane entry takes one more
//     product when the table is built.
//   * The lane table i·(-A), i = 0..15: thread c keeps coordinate c of
//     each entry, 16 x 16 int32 = 1 KB, in shared memory laid out
//     [entry][limb][thread] (conflict-free: the entry index is the same
//     within a quad, the thread index picks the bank).  A thread also
//     reads its partner's column (c ^ 1) for Y2 ± X2.  Entry 0, the
//     identity, is a select, and its slot holds -R's entry.  32-thread
//     blocks keep the table (32 KB) and the constant block (4,288 B)
//     under the 48 KB of static shared memory; shared memory holds 6
//     blocks an SM, registers 8.
//   * Every field and point function is force-inlined: no operand crosses
//     a call boundary, so nothing goes through local memory.  Constants
//     (d, 2d, sqrt(-1)) are read from shared memory where they are used.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int L16 = 16;
constexpr int WINDOWS = 64;
constexpr int QUAD = 4;
constexpr int THREADS = 32;                      // 8 signatures a block
constexpr unsigned FULL = 0xffffffffu;

// constant block layout (int32), built by ed25519_kernel8.KERNEL_CONSTS
constexpr int K_D = 0;
constexpr int K_2D = 16;
constexpr int K_SQRTM1 = 32;
constexpr int K_BTAB = 48;                       // [16 limb][16 entry][4]
constexpr int K_TOTAL = 48 + 16 * 16 * 4;        // 1072

struct f16 { int32_t v[L16]; };

__device__ __forceinline__ void f16_zero(f16& h) {
#pragma unroll
  for (int i = 0; i < L16; ++i) h.v[i] = 0;
}

__device__ __forceinline__ void f16_one(f16& h) {
  f16_zero(h);
  h.v[0] = 1;
}

__device__ __forceinline__ void f16_add(f16& h, const f16& f, const f16& g) {
#pragma unroll
  for (int i = 0; i < L16; ++i) h.v[i] = f.v[i] + g.v[i];
}

__device__ __forceinline__ void f16_sub(f16& h, const f16& f, const f16& g) {
#pragma unroll
  for (int i = 0; i < L16; ++i) h.v[i] = f.v[i] - g.v[i];
}

__device__ __forceinline__ void f16_neg(f16& h, const f16& f) {
#pragma unroll
  for (int i = 0; i < L16; ++i) h.v[i] = -f.v[i];
}

__device__ __forceinline__ void f16_load(f16& h, const int32_t* src) {
#pragma unroll
  for (int i = 0; i < L16; ++i) h.v[i] = src[i];
}

// h = k ? f : g, limb by limb
__device__ __forceinline__ void f16_select(f16& h, bool k, const f16& f,
                                           const f16& g) {
#pragma unroll
  for (int i = 0; i < L16; ++i) h.v[i] = k ? f.v[i] : g.v[i];
}

// Balanced sequential carry (ops/field16.carry): round-to-nearest quotient
// per limb, the carry out of limb 15 folds into limb 0 at 38, then limb 0
// carries once more.
__device__ __forceinline__ void f16_carry(f16& out, int64_t h[L16]) {
#pragma unroll
  for (int i = 0; i < L16; ++i) {
    const int64_t q = (h[i] + (int64_t(1) << 15)) >> 16;
    h[i] -= q * (int64_t(1) << 16);
    if (i < L16 - 1) h[i + 1] += q; else h[0] += 38 * q;
  }
  const int64_t q = (h[0] + (int64_t(1) << 15)) >> 16;
  h[0] -= q * (int64_t(1) << 16);
  h[1] += q;
#pragma unroll
  for (int i = 0; i < L16; ++i) out.v[i] = (int32_t)h[i];
}

// Products below 2^256 go to lo[i + j], those above to hi[i + j - 16],
// folded in at 38.  out may alias f or g: both are read before out is
// written.
__device__ __forceinline__ void f16_mul(f16& out, const f16& f, const f16& g) {
  int64_t lo[L16], hi[L16 - 1];
#pragma unroll
  for (int k = 0; k < L16; ++k) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < L16 - 1; ++k) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < L16; ++i) {
#pragma unroll
    for (int j = 0; j < L16; ++j) {
      const int64_t p = (int64_t)f.v[i] * g.v[j];
      if (i + j < L16) lo[i + j] += p; else hi[i + j - L16] += p;
    }
  }
  int64_t h[L16];
#pragma unroll
  for (int k = 0; k < L16 - 1; ++k) h[k] = lo[k] + 38 * hi[k];
  h[L16 - 1] = lo[L16 - 1];
  f16_carry(out, h);
}

// Squaring: each cross product once, against a doubled limb (136
// products); the accumulators equal f16_mul(f, f)'s.
__device__ __forceinline__ void f16_sqr(f16& out, const f16& f) {
  int64_t lo[L16], hi[L16 - 1];
#pragma unroll
  for (int k = 0; k < L16; ++k) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < L16 - 1; ++k) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < L16; ++i) {
    const int64_t d = (int64_t)f.v[i] * f.v[i];
    if (2 * i < L16) lo[2 * i] += d; else hi[2 * i - L16] += d;
    const int32_t a2 = 2 * f.v[i];
#pragma unroll
    for (int j = i + 1; j < L16; ++j) {
      const int64_t p = (int64_t)a2 * f.v[j];
      if (i + j < L16) lo[i + j] += p; else hi[i + j - L16] += p;
    }
  }
  int64_t h[L16];
#pragma unroll
  for (int k = 0; k < L16 - 1; ++k) h[k] = lo[k] + 38 * hi[k];
  h[L16 - 1] = lo[L16 - 1];
  f16_carry(out, h);
}

__device__ __forceinline__ void f16_pow2k(f16& x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) f16_sqr(x, x);
}

// x^((p-5)/8) = x^(2^252 - 3), same chain as ops/field16.pow_p58.
__device__ __forceinline__ void f16_pow_p58(f16& out, const f16& x) {
  f16 x2, z9, z11, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0, t;
  f16_sqr(x2, x);
  f16_sqr(t, x2);
  f16_sqr(t, t);
  f16_mul(z9, x, t);
  f16_mul(z11, x2, z9);
  f16_sqr(t, z11);
  f16_mul(z_5_0, z9, t);
  t = z_5_0; f16_pow2k(t, 5);    f16_mul(z_10_0, t, z_5_0);
  t = z_10_0; f16_pow2k(t, 10);  f16_mul(z_20_0, t, z_10_0);
  t = z_20_0; f16_pow2k(t, 20);  f16_mul(t, t, z_20_0);          // 2^40 - 1
  f16_pow2k(t, 10);              f16_mul(z_50_0, t, z_10_0);
  t = z_50_0; f16_pow2k(t, 50);  f16_mul(z_100_0, t, z_50_0);
  t = z_100_0; f16_pow2k(t, 100); f16_mul(t, t, z_100_0);        // 2^200 - 1
  f16_pow2k(t, 50);              f16_mul(t, t, z_50_0);          // 2^250 - 1
  f16_pow2k(t, 2);
  f16_mul(out, t, x);
}

// Exact floor-carry sweep to digits of bits 0..254 (limb 15 keeps 15
// bits); returns the carry out of bit 255.
__device__ __forceinline__ int64_t sweep255(int64_t c[L16]) {
#pragma unroll
  for (int i = 0; i < L16 - 1; ++i) {
    c[i + 1] += c[i] >> 16;
    c[i] &= 0xFFFF;
  }
  const int64_t top = c[L16 - 1] >> 15;
  c[L16 - 1] &= 0x7FFF;
  return top;
}

// Canonical digits of x mod p (ops/field16.canonical): carry, + 2p, two
// sweeps folding bit 255 at 19, then subtract p iff value + 19 >= 2^255.
// The last sweep runs twice, for its carry out and then for its digits,
// so that only one set of int64 digits is live.
__device__ __forceinline__ void f16_canonical(f16& out, const f16& x) {
  int64_t h[L16];
#pragma unroll
  for (int i = 0; i < L16; ++i) h[i] = x.v[i];
  f16 r;
  f16_carry(r, h);
  // 2p = 2^256 - 38 as 16-bit digits
#pragma unroll
  for (int i = 0; i < L16; ++i)
    h[i] = (int64_t)r.v[i] + ((i == 0) ? 0x10000 - 38 : 0xFFFF);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) h[0] += 19 * sweep255(h);
  int64_t cy = 19;
#pragma unroll
  for (int i = 0; i < L16 - 1; ++i) cy = (h[i] + cy) >> 16;
  const bool ge_p = (h[L16 - 1] + cy) >> 15 != 0;
  // the digits of value + 19 - 2^255 where ge_p, else h as it is
  cy = ge_p ? 19 : 0;
#pragma unroll
  for (int i = 0; i < L16; ++i) {
    const int64_t d = h[i] + cy;
    out.v[i] = (int32_t)(d & (i < L16 - 1 ? 0xFFFF : 0x7FFF));
    cy = d >> 16;
  }
}

__device__ __forceinline__ bool f16_is_zero(const f16& x) {
  f16 c;
  f16_canonical(c, x);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < L16; ++i) acc |= c.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool f16_eq(const f16& a, const f16& b) {
  f16 d;
  f16_sub(d, a, b);
  return f16_is_zero(d);
}

__device__ __forceinline__ int f16_parity(const f16& x) {
  f16 c;
  f16_canonical(c, x);
  return c.v[0] & 1;
}

__device__ __forceinline__ void f16_park(int32_t (*slot)[THREADS],
                                         const f16& v) {
#pragma unroll
  for (int i = 0; i < L16; ++i) slot[i][threadIdx.x] = v.v[i];
}

__device__ __forceinline__ void f16_unpark(f16& v,
                                           const int32_t (*slot)[THREADS]) {
#pragma unroll
  for (int i = 0; i < L16; ++i) v.v[i] = slot[i][threadIdx.x];
}

// ZIP-215 decompression of one lane's 32-byte column; returns validity.
// Bit 255 is the sign of x: it is cleared before y is read, and y >= p
// stays as it is.  The square-root fix-up and the sign flip are selects.
//
// Register pressure: two independent products side by side need ~190
// registers, and ptxas interleaves them where it can.  So the values that
// wait (y, u, v, ...) are parked in park[0..4], this thread's columns of
// shared memory, and where two products are independent the first one's
// result is stored before a __syncwarp() and the second one's operand is
// loaded after it: memory order then puts one after the other.
__device__ __forceinline__ bool p16_decompress(f16& x, f16& y,
                                               const int32_t* col, int n,
                                               int lane, const int32_t* sc,
                                               int32_t (*park)[L16][THREADS]) {
  int32_t b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) b[i] = col[(size_t)i * n + lane] & 0xFF;
  const int sign = b[31] >> 7;
  b[31] &= 0x7F;
  {
    int64_t h[L16];
#pragma unroll
    for (int i = 0; i < L16; ++i) h[i] = b[2 * i] + (b[2 * i + 1] << 8);
    f16_carry(y, h);
  }
  f16 k, u, v, t;
  f16_sqr(t, y);                                // y²
  f16_park(park[0], y);
  f16_one(k);
  f16_sub(u, t, k);                             // u = y² - 1
  f16_park(park[1], u);
  f16_load(k, sc + K_D);
  f16_mul(v, t, k);
  v.v[0] += 1;                                  // v = d·y² + 1
  f16_park(park[2], v);
  f16_sqr(t, v);
  f16_mul(t, t, v);                             // v³
  f16_park(park[3], t);
  f16_mul(x, u, t);                             // u·v³
  f16_park(park[4], x);
  __syncwarp();
  f16_unpark(t, park[3]);
  f16_sqr(t, t);
  f16_unpark(v, park[2]);
  f16_mul(t, t, v);                             // v⁷
  f16_unpark(u, park[1]);
  f16_mul(t, u, t);
  f16_pow_p58(t, t);
  f16_unpark(x, park[4]);
  f16_mul(x, x, t);                             // u·v³·(u·v⁷)^((p-5)/8)
  f16_sqr(t, x);
  f16_unpark(v, park[2]);
  f16_mul(t, v, t);                             // v·x²
  f16_park(park[3], t);
  __syncwarp();
  f16_load(k, sc + K_SQRTM1);
  f16_mul(v, x, k);                             // x·sqrt(-1)
  f16_park(park[2], v);
  __syncwarp();
  f16_unpark(t, park[3]);
  f16_unpark(u, park[1]);
  const bool ok_direct = f16_eq(t, u);
  f16_add(t, t, u);
  const bool ok_flip = f16_is_zero(t);          // v·x² == -u
  f16_unpark(v, park[2]);
  f16_select(x, ok_flip, v, x);
  f16_neg(t, x);
  f16_select(x, f16_parity(x) != sign, t, x);
  f16_unpark(y, park[0]);
  return ok_direct || ok_flip;
}

// ---- the quad's rounds (ops/ed25519_kernel8._quad_*) -----------------------

__device__ __forceinline__ void f16_shfl(f16& out, const f16& v, int src) {
#pragma unroll
  for (int i = 0; i < L16; ++i)
    out.v[i] = __shfl_sync(FULL, v.v[i], src, QUAD);
}

__device__ __forceinline__ void f16_shfl_xor(f16& out, const f16& v,
                                             int mask) {
#pragma unroll
  for (int i = 0; i < L16; ++i)
    out.v[i] = __shfl_xor_sync(FULL, v.v[i], mask, QUAD);
}

// out = k0·f0 + k1·f1 for small integer k
__device__ __forceinline__ void f16_comb2(f16& out, int k0, const f16& f0,
                                          int k1, const f16& f1) {
#pragma unroll
  for (int i = 0; i < L16; ++i) out.v[i] = k0 * f0.v[i] + k1 * f1.v[i];
}

// out = k0·f0 + k1·f1 + k2·f2 + k3·f3 for small integer k
__device__ __forceinline__ void f16_comb(f16& out, int k0, const f16& f0,
                                         int k1, const f16& f1, int k2,
                                         const f16& f2, int k3,
                                         const f16& f3) {
#pragma unroll
  for (int i = 0; i < L16; ++i)
    out.v[i] = k0 * f0.v[i] + k1 * f1.v[i] + k2 * f2.v[i] + k3 * f3.v[i];
}

// Round 2 of a double or an add.  r is this thread's round-1 product; the
// other three come by xor 1, 2, 3.  The coefficients kl (left operand)
// and kr (right), one per value in the order own, xor 1, xor 2, xor 3,
// form the thread's E·F, G·H, F·G or E·H: its new coordinate.
__device__ __forceinline__ void quad_round2(f16& m, const f16& r,
                                            const int (&kl)[4],
                                            const int (&kr)[4]) {
  f16 r1, r2, r3, lhs, rhs;
  f16_shfl_xor(r1, r, 1);
  f16_shfl_xor(r2, r, 2);
  f16_shfl_xor(r3, r, 3);
  f16_comb(lhs, kl[0], r, kl[1], r1, kl[2], r2, kl[3], r3);
  f16_comb(rhs, kr[0], r, kr[1], r1, kr[2], r2, kr[3], r3);
  f16_mul(m, lhs, rhs);
}

// m = coordinate c of 2P (ed25519_kernel8._quad_double).  Round 1:
// thread 0 A = X², 1 B = Y², 2 ZZ = Z², 3 S = (X+Y)².  Round 2 with
// E = S - A - B, G = B - A, F = G - 2·ZZ, H = -A - B.
__device__ __forceinline__ void quad_double(f16& m, int c) {
  f16 x, y, r;
  f16_shfl(x, m, 0);
  f16_shfl(y, m, 1);
  f16_add(x, x, y);
  f16_select(x, c == 3, x, m);
  f16_sqr(r, x);
  // the products by xor: c 0 holds (A, B, ZZ, S), 1 (B, A, S, ZZ),
  // 2 (ZZ, S, A, B), 3 (S, ZZ, B, A)
  const int kl[4] = {c == 0 ? -1 : c == 1 ? 1 : c == 2 ? -2 : 1,
                     c == 0 ? -1 : c == 1 ? -1 : 0,
                     c == 0 ? 0 : c == 1 ? 0 : -1,
                     c == 0 ? 1 : c == 1 ? 0 : c == 2 ? 1 : -1};
  const int kr[4] = {c == 0 ? -1 : c == 1 ? -1 : 0,
                     c == 0 ? 1 : c == 1 ? -1 : 0,
                     c == 0 ? -2 : c == 1 ? 0 : -1,
                     c == 0 ? 0 : c == 1 ? 0 : c == 2 ? 1 : -1};
  quad_round2(m, r, kl, kr);
}

// m = coordinate c of P + Q (ed25519_kernel8._quad_add), where q is
// coordinate c of the entry Q = (X2, Y2, Z2, 2d·T2) and qp coordinate
// c ^ 1.  Round 1: thread 0 A = (Y1-X1)(Y2-X2), 1 B = (Y1+X1)(Y2+X2),
// 2 ZZ = Z1·Z2, 3 C = T1·2dT2.  Round 2 with D = 2·ZZ, E = B - A,
// F = D - C, G = D + C, H = B + A.
__device__ __forceinline__ void quad_add(f16& m, int c, const f16& q,
                                         const f16& qp) {
  f16 mp, lhs, rhs, r;
  f16_shfl_xor(mp, m, 1);                       // 0 gets Y1, 1 gets X1
  const int k0 = c == 0 ? -1 : 1, k1 = c < 2 ? 1 : 0;
  f16_comb2(lhs, k0, m, k1, mp);
  f16_comb2(rhs, k0, q, k1, qp);
  f16_mul(r, lhs, rhs);
  // the products by xor: c 0 holds (A, B, ZZ, C), 1 (B, A, C, ZZ),
  // 2 (ZZ, C, A, B), 3 (C, ZZ, B, A)
  const int kl[4] = {c == 0 ? -1 : c == 2 ? 2 : 0,
                     c == 0 ? 1 : c == 2 ? -1 : 0,
                     c == 1 ? 1 : c == 3 ? 1 : 0,
                     c == 0 ? 0 : c == 1 ? 2 : c == 2 ? 0 : -1};
  const int kr[4] = {c == 1 ? 1 : c == 2 ? 2 : 0,
                     c == 1 || c == 2 ? 1 : 0,
                     c == 0 ? 2 : c == 3 ? 1 : 0,
                     c == 0 ? -1 : c == 3 ? 1 : 0};
  quad_round2(m, r, kl, kr);
}

__global__ void __launch_bounds__(THREADS)
ed25519_verify8_kernel(const int32_t* __restrict__ a_cols,
                       const int32_t* __restrict__ r_cols,
                       const int32_t* __restrict__ s_win,
                       const int32_t* __restrict__ k_win,
                       const int32_t* __restrict__ consts, int n,
                       uint8_t* __restrict__ ok) {
  __shared__ int32_t sc[K_TOTAL];
  __shared__ int32_t tab[16][L16][THREADS];
  for (int i = threadIdx.x; i < K_TOTAL; i += blockDim.x) sc[i] = consts[i];
  __syncthreads();
  const int tid = threadIdx.x;
  const int c = tid & (QUAD - 1);
  const int sig = (int)(((int64_t)blockIdx.x * THREADS + tid) / QUAD);
  const int lane = sig < n ? sig : n - 1;   // past the end: the last lane

  // A in threads 0 and 2, R in threads 1 and 3; then each thread's
  // -P = (-x, y, 1, T) with T = -x·y, and 2d·T
  f16 x, y, t, t2d, k;
  const bool p_ok = p16_decompress(x, y, (c & 1) ? r_cols : a_cols, n, lane,
                                   sc, tab + 11);
  f16_neg(x, x);
  f16_mul(t, x, y);
  f16_load(k, sc + K_2D);
  f16_mul(t2d, t, k);
  const bool a_ok = __shfl_sync(FULL, (int)p_ok, 0, QUAD) != 0;
  const bool r_ok = __shfl_sync(FULL, (int)p_ok, 1, QUAD) != 0;

  // coordinate c of -A (running point and entry) and of -R's entry.
  // Thread 1 takes y of A from thread 0, thread 3 T and 2d·T of A from
  // thread 2, thread 0 -x of R from thread 1.
  f16 s1, s2, s3;
  f16_select(s1, c == 0, y, t);
  f16_shfl(s1, s1, c == 1 ? 0 : 2);
  f16_shfl(s2, t2d, 2);
  f16_shfl(s3, x, 1);
  f16 m, e, one;
  f16_one(one);
  f16_select(m, c == 2, one, s1);
  f16_select(m, c == 0, x, m);                  // -A, running
  f16_select(e, c == 3, s2, m);                 // -A, entry 1
  f16_select(t2d, c == 2, one, t2d);
  f16_select(t2d, c == 1, y, t2d);
  f16_select(t2d, c == 0, s3, t2d);             // -R, entry

  // table of i·(-A), i = 1..15, entries (X, Y, Z, 2d·T).  Entry 0, the
  // identity (0, 1, 1, 0), is selected where the k window is 0, so its
  // slot holds the entry of -R for the tail.
#pragma unroll
  for (int i = 0; i < L16; ++i) {
    tab[0][i][tid] = t2d.v[i];
    tab[1][i][tid] = e.v[i];
  }
  __syncwarp();
#pragma unroll 1
  for (int j = 2; j < 16; ++j) {
    f16 q, qp;
#pragma unroll
    for (int i = 0; i < L16; ++i) {
      q.v[i] = tab[1][i][tid];
      qp.v[i] = tab[1][i][tid ^ 1];
    }
    quad_add(m, c, q, qp);
    f16_load(k, sc + K_2D);
    f16_mul(t, m, k);
    f16_select(t, c == 3, t, m);
#pragma unroll
    for (int i = 0; i < L16; ++i) tab[j][i][tid] = t.v[i];
  }
  __syncwarp();

  // 64 windows from the top: 4 doublings, an add of the B entry of the s
  // window, an add of the lane entry of the k window
  f16_zero(m);
  m.v[0] = c == 1 || c == 2;                   // the identity (0, 1, 1, 0)
#pragma unroll 1
  for (int j = 0; j < WINDOWS; ++j) {
    const int w = WINDOWS - 1 - j;
#pragma unroll 1
    for (int i = 0; i < 4; ++i) quad_double(m, c);
    const int sw = s_win[(size_t)w * n + lane] & 15;
    const int kw = k_win[(size_t)w * n + lane] & 15;
    f16 q, qp;
#pragma unroll
    for (int i = 0; i < L16; ++i) {
      q.v[i] = sc[K_BTAB + (i * 16 + sw) * 4 + c];
      qp.v[i] = sc[K_BTAB + (i * 16 + sw) * 4 + (c ^ 1)];
    }
    quad_add(m, c, q, qp);
#pragma unroll
    for (int i = 0; i < L16; ++i) {
      q.v[i] = kw ? tab[kw][i][tid] : i == 0 && (c == 1 || c == 2);
      qp.v[i] = kw ? tab[kw][i][tid ^ 1] : i == 0 && (c == 0 || c == 3);
    }
    quad_add(m, c, q, qp);
  }

  // add -R, double 3 times, test the identity: X == 0 and Y == Z in
  // thread 0
  {
    f16 q, qp;
#pragma unroll
    for (int i = 0; i < L16; ++i) {
      q.v[i] = tab[0][i][tid];
      qp.v[i] = tab[0][i][tid ^ 1];
    }
    quad_add(m, c, q, qp);
  }
#pragma unroll 1
  for (int i = 0; i < 3; ++i) quad_double(m, c);
  f16_shfl(y, m, 1);
  f16_shfl(t, m, 2);
  const bool good = f16_is_zero(m) && f16_eq(y, t) && a_ok && r_ok;
  if (c == 0 && sig < n) ok[sig] = good ? 1 : 0;
}

}  // namespace

extern "C" int ed25519_verify8_launch(const void* a_cols, const void* r_cols,
                                      const void* s_win, const void* k_win,
                                      const void* consts, int n, void* ok,
                                      void* stream) {
  if (n <= 0) return 0;
  const int blocks = (int)(((int64_t)n * QUAD + THREADS - 1) / THREADS);
  ed25519_verify8_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a_cols, (const int32_t*)r_cols, (const int32_t*)s_win,
      (const int32_t*)k_win, (const int32_t*)consts, n, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
