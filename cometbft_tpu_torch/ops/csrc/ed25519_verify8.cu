// Batch ed25519 verification (ZIP-215, cofactored) for Hopper (sm_90a),
// second kernel.
//
// Replaces the Pallas TPU kernel cometbft_tpu/ops/ed25519_pallas8.py
// (_kernel, :247; launched by _pallas_verify, :333), the first-generation
// kernel behind COMETBFT_TPU_KERNEL=pallas8.  Same function and the same
// public layout as ed25519_verify.cu: A and R as [32, n] int32 byte
// columns, s and k as [64, n] int32 4-bit windows; one verdict byte per
// lane out.  It is selected with COMETBFT_TPU_TORCH_KERNEL=cuda8.  The
// plain PyTorch version of every step is
// cometbft_tpu_torch/ops/ed25519_kernel8.py (verify_cols_plain) on
// ops/field16.py; the two agree limb for limb.
//
// It shares no code with ed25519_verify.cu, so each checks the other.
// From the TPU kernel it takes the function and the algorithmic choices,
// not the block structure:
//   * Field: 16 signed limbs of 16 bits in int32, products in int64, the
//     carry out of limb 15 folded into limb 0 at 38 (2^256 = 2p + 38).
//     Values reach 2^256, so canonical() sweeps to 255 bits and folds bit
//     255 at 19 before it compares with p.
//   * Overflow bound (pinned by tests/test_torch_field16.py): carry()
//     leaves RESTING limbs, |limb| <= 2^15 except limb 1 (< 2^17.6).
//     mul() takes operands that are sums of at most 4 resting values
//     (every call site stays inside that); every int64 accumulator is
//     then < 2^44, and carry() of anything < 2^44 is resting again.
//   * The B table holds full extended points (X, Y, Z = 1, T = xy) and is
//     added with the 9-multiply unified add; every double and add makes T.
//   * One thread per signature, as in ed25519_verify.cu.  The TPU
//     kernel's masked-sum selects (its vector unit cannot gather across
//     lanes) become indexed loads: the windows are public data.
//   * The per-lane table i·(-A), 16 x 4 x 16 int32 = 4 KB, lives in local
//     memory.  The constant block (D, 2D, sqrt(-1), the 16 x 4 x 16 B
//     table, 4,288 bytes) is copied to shared memory once per block.
//   * f16_mul, f16_sqr and the point functions are not inlined: a
//     point add with its operands and temporaries needs more than the
//     255 registers a thread has, and the unrolled 256-product multiply
//     at every call site would make the build slow.
//
// Bound on this card: integer issue, the same work as ed25519_verify.cu
// (same function).  This kernel does more of it: about 3,900 field
// multiplies per signature at 256 products (136 for a squaring).  The
// launch counts, inputs and the bound's formula are in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int L16 = 16;
constexpr int WINDOWS = 64;
constexpr int THREADS = 32;

// constant block layout (int32), built by ed25519_kernel8.CONSTS
constexpr int K_D = 0;
constexpr int K_2D = 16;
constexpr int K_SQRTM1 = 32;
constexpr int K_BTAB = 48;                       // [16][4][16]
constexpr int K_TOTAL = 48 + 16 * 4 * 16;        // 1072

struct f16 { int32_t v[L16]; };
struct p16 { f16 X, Y, Z, T; };                  // extended coordinates

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
__device__ __noinline__ void f16_mul(f16& out, const f16& f, const f16& g) {
  int32_t a[L16], b[L16];
#pragma unroll
  for (int i = 0; i < L16; ++i) { a[i] = f.v[i]; b[i] = g.v[i]; }
  int64_t lo[L16], hi[L16 - 1];
#pragma unroll
  for (int k = 0; k < L16; ++k) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < L16 - 1; ++k) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < L16; ++i) {
#pragma unroll
    for (int j = 0; j < L16; ++j) {
      const int64_t p = (int64_t)a[i] * b[j];
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
__device__ __noinline__ void f16_sqr(f16& out, const f16& f) {
  int32_t a[L16], a2[L16];
#pragma unroll
  for (int i = 0; i < L16; ++i) { a[i] = f.v[i]; a2[i] = 2 * a[i]; }
  int64_t lo[L16], hi[L16 - 1];
#pragma unroll
  for (int k = 0; k < L16; ++k) lo[k] = 0;
#pragma unroll
  for (int k = 0; k < L16 - 1; ++k) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < L16; ++i) {
    const int64_t d = (int64_t)a[i] * a[i];
    if (2 * i < L16) lo[2 * i] += d; else hi[2 * i - L16] += d;
#pragma unroll
    for (int j = i + 1; j < L16; ++j) {
      const int64_t p = (int64_t)a2[i] * a[j];
      if (i + j < L16) lo[i + j] += p; else hi[i + j - L16] += p;
    }
  }
  int64_t h[L16];
#pragma unroll
  for (int k = 0; k < L16 - 1; ++k) h[k] = lo[k] + 38 * hi[k];
  h[L16 - 1] = lo[L16 - 1];
  f16_carry(out, h);
}

__device__ __noinline__ void f16_pow2k(f16& x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) f16_sqr(x, x);
}

// x^((p-5)/8) = x^(2^252 - 3), same chain as ops/field16.pow_p58.
__device__ __noinline__ void f16_pow_p58(f16& out, const f16& x) {
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
__device__ __noinline__ void f16_canonical(f16& out, const f16& x) {
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
  int64_t g[L16];
#pragma unroll
  for (int i = 0; i < L16; ++i) g[i] = h[i];
  g[0] += 19;
  const bool ge_p = sweep255(g) != 0;
#pragma unroll
  for (int i = 0; i < L16; ++i) out.v[i] = (int32_t)(ge_p ? g[i] : h[i]);
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

// ---- point arithmetic (ops/ed25519_kernel8._ext_add etc.) -----------------

// Unified add (add-2008-hwcd-3), complete for a = -1; always makes T.
// out may alias p or q: both are read before out is written.
__device__ __noinline__ void p16_add(p16& out, const p16& p, const p16& q,
                                     const f16& two_d) {
  f16 a, b, c, d, t1, t2;
  f16_sub(t1, p.Y, p.X);
  f16_sub(t2, q.Y, q.X);
  f16_mul(a, t1, t2);
  f16_add(t1, p.Y, p.X);
  f16_add(t2, q.Y, q.X);
  f16_mul(b, t1, t2);
  f16_mul(c, p.T, q.T);
  f16_mul(c, c, two_d);
  f16_mul(d, p.Z, q.Z);
  f16_add(d, d, d);
  f16 e, f, g, h;
  f16_sub(e, b, a);
  f16_sub(f, d, c);
  f16_add(g, d, c);
  f16_add(h, b, a);
  f16_mul(out.X, e, f);
  f16_mul(out.Y, g, h);
  f16_mul(out.Z, f, g);
  f16_mul(out.T, e, h);
}

// dbl-2008-hwcd, a = -1; reads X, Y, Z and always makes T.
__device__ __noinline__ void p16_double(p16& out, const p16& p) {
  f16 a, b, c, e, f, g, h, t;
  f16_sqr(a, p.X);
  f16_sqr(b, p.Y);
  f16_sqr(c, p.Z);
  f16_add(c, c, c);
  f16_add(t, p.X, p.Y);
  f16_sqr(e, t);
  f16_sub(e, e, a);
  f16_sub(e, e, b);
  f16_sub(g, b, a);
  f16_sub(f, g, c);
  f16_add(h, a, b);
  f16_neg(h, h);
  f16_mul(out.X, e, f);
  f16_mul(out.Y, g, h);
  f16_mul(out.Z, f, g);
  f16_mul(out.T, e, h);
}

// ZIP-215 decompression of one lane's 32-byte column; returns validity.
// Bit 255 is the sign of x: it is cleared before y is read, and y >= p
// stays as it is.
__device__ __noinline__ bool p16_decompress(f16& x, f16& y,
                                            const int32_t* col, int n,
                                            int lane, const int32_t* sc) {
  int32_t b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) b[i] = col[(size_t)i * n + lane] & 0xFF;
  const int sign = b[31] >> 7;
  b[31] &= 0x7F;
  f16 one, d_const, sqrt_m1, yy, u, v, v3, v7, t, vxx, negu;
  f16_one(one);
  f16_load(d_const, sc + K_D);
  f16_load(sqrt_m1, sc + K_SQRTM1);
  {
    int64_t h[L16];
#pragma unroll
    for (int i = 0; i < L16; ++i) h[i] = b[2 * i] + (b[2 * i + 1] << 8);
    f16_carry(y, h);
  }
  f16_sqr(yy, y);
  f16_sub(u, yy, one);
  f16_mul(v, yy, d_const);
  f16_add(v, v, one);
  f16_sqr(t, v);
  f16_mul(v3, t, v);
  f16_sqr(t, v3);
  f16_mul(v7, t, v);
  f16_mul(t, u, v7);
  f16_pow_p58(t, t);
  f16_mul(x, u, v3);
  f16_mul(x, x, t);
  f16_sqr(t, x);
  f16_mul(vxx, v, t);
  const bool ok_direct = f16_eq(vxx, u);
  f16_neg(negu, u);
  const bool ok_flip = f16_eq(vxx, negu);
  if (ok_flip) f16_mul(x, x, sqrt_m1);
  if (f16_parity(x) != sign) f16_neg(x, x);
  return ok_direct || ok_flip;
}

__device__ __forceinline__ void p16_load(p16& p, const int32_t* src) {
  f16_load(p.X, src);
  f16_load(p.Y, src + L16);
  f16_load(p.Z, src + 2 * L16);
  f16_load(p.T, src + 3 * L16);
}

__global__ void __launch_bounds__(THREADS)
ed25519_verify8_kernel(const int32_t* __restrict__ a_cols,
                       const int32_t* __restrict__ r_cols,
                       const int32_t* __restrict__ s_win,
                       const int32_t* __restrict__ k_win,
                       const int32_t* __restrict__ consts, int n,
                       uint8_t* __restrict__ ok) {
  __shared__ int32_t sc[K_TOTAL];
  for (int i = threadIdx.x; i < K_TOTAL; i += blockDim.x) sc[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  f16 ax, ay, rx, ry, two_d;
  const bool a_ok = p16_decompress(ax, ay, a_cols, n, lane, sc);
  const bool r_ok = p16_decompress(rx, ry, r_cols, n, lane, sc);
  f16_load(two_d, sc + K_2D);

  // per-lane table of i·(-A), i = 0..15
  p16 tab[16];
  f16_zero(tab[0].X); f16_one(tab[0].Y); f16_one(tab[0].Z); f16_zero(tab[0].T);
  f16_neg(tab[1].X, ax);
  tab[1].Y = ay;
  f16_one(tab[1].Z);
  f16_mul(tab[1].T, tab[1].X, tab[1].Y);
#pragma unroll 1
  for (int i = 1; i < 15; ++i) p16_add(tab[i + 1], tab[i], tab[1], two_d);

  p16 acc = tab[0];
  p16 bq;
#pragma unroll 1
  for (int j = 0; j < WINDOWS; ++j) {
    const int w = WINDOWS - 1 - j;
#pragma unroll 1
    for (int i = 0; i < 4; ++i) p16_double(acc, acc);
    const int sw = s_win[(size_t)w * n + lane] & 15;
    const int kw = k_win[(size_t)w * n + lane] & 15;
    p16_load(bq, sc + K_BTAB + sw * 4 * L16);
    p16_add(acc, acc, bq, two_d);
    p16_add(acc, acc, tab[kw], two_d);
  }

  p16 neg_r;
  f16_neg(neg_r.X, rx);
  neg_r.Y = ry;
  f16_one(neg_r.Z);
  f16_mul(neg_r.T, neg_r.X, neg_r.Y);
  p16_add(acc, acc, neg_r, two_d);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) p16_double(acc, acc);
  const bool good = f16_is_zero(acc.X) && f16_eq(acc.Y, acc.Z) && a_ok && r_ok;
  ok[lane] = good ? 1 : 0;
}

}  // namespace

extern "C" int ed25519_verify8_launch(const void* a_cols, const void* r_cols,
                                      const void* s_win, const void* k_win,
                                      const void* consts, int n, void* ok,
                                      void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  ed25519_verify8_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a_cols, (const int32_t*)r_cols, (const int32_t*)s_win,
      (const int32_t*)k_win, (const int32_t*)consts, n, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
