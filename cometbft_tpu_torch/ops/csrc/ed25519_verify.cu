// Batch ed25519 verification (ZIP-215, cofactored) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cometbft_tpu/ops/ed25519_pallas.py
// (_kernel, :379; launched by _pallas_verify, :469).  Same function and
// the same public layout: A and R as [32, n] int32 byte columns, s and k
// as [64, n] int32 4-bit windows; one verdict byte per lane out.  The
// plain PyTorch version of every step below is
// cometbft_tpu_torch/ops/ed25519_kernel.py (verify_cols_plain) on
// ops/field.py; the two agree limb for limb.
//
// Design: one thread per signature.  The TPU kernel's where-trees (the
// vector unit cannot gather across lanes) become plain indexed loads.
// The field, the point formulas and decompression are in
// ed25519_field.cuh (shared with microbench.cu), with their overflow
// bound.
//   * The per-lane table i·(-A), 16 x 4 x 10 int32 = 2.5 KB, lives in
//     local memory (cached in L1): too large for registers.
//   * The constant block (D, 2D, sqrt(-1), the affine 16 x 3 B table) is
//     copied to shared memory once per block; lanes index it by their own
//     window, which constant memory would serialize.
//
// Bound on this card: integer issue.  3,585 field multiplies per
// signature (64 windows x 45, two decompressions of ~277, 14 table adds
// x 9), 1,546 of them squarings.  fe_sqr runs the 100 products of a
// general multiply where 55 would do.  The function moves 193 bytes per
// lane.  The launch counts, inputs and the bound's formula are in
// PERF.md.

#include "ed25519_field.cuh"

namespace {

constexpr int WINDOWS = 64;
constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
ed25519_verify_kernel(const int32_t* __restrict__ a_cols,
                      const int32_t* __restrict__ r_cols,
                      const int32_t* __restrict__ s_win,
                      const int32_t* __restrict__ k_win,
                      const int32_t* __restrict__ consts, int n,
                      uint8_t* __restrict__ ok) {
  __shared__ int32_t sc[C_TOTAL];
  for (int i = threadIdx.x; i < C_TOTAL; i += blockDim.x) sc[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  fe ax, ay, rx, ry, two_d;
  const bool a_ok = ge_decompress(ax, ay, a_cols, n, lane, sc);
  const bool r_ok = ge_decompress(rx, ry, r_cols, n, lane, sc);
  fe_load(two_d, sc + C_2D);

  // per-lane table of i·(-A), i = 0..15
  ge tab[16];
  fe_zero(tab[0].X); fe_one(tab[0].Y); fe_one(tab[0].Z); fe_zero(tab[0].T);
  fe_neg(tab[1].X, ax);
  tab[1].Y = ay;
  fe_one(tab[1].Z);
  fe_mul(tab[1].T, tab[1].X, tab[1].Y);
#pragma unroll 1
  for (int i = 1; i < 15; ++i) ge_add(tab[i + 1], tab[i], tab[1], two_d, true);

  ge acc = tab[0];
#pragma unroll 1
  for (int j = 0; j < WINDOWS; ++j) {
    const int w = WINDOWS - 1 - j;
#pragma unroll 1
    for (int i = 0; i < 4; ++i) ge_double(acc, acc, i == 3);
    const int sw = s_win[(size_t)w * n + lane] & 15;
    const int kw = k_win[(size_t)w * n + lane] & 15;
    ge_madd(acc, acc, sc + C_BTAB + sw * 3 * LIMBS);
    ge_add(acc, acc, tab[kw], two_d, true);
  }

  ge neg_r;
  fe_neg(neg_r.X, rx);
  neg_r.Y = ry;
  fe_one(neg_r.Z);
  fe_mul(neg_r.T, neg_r.X, neg_r.Y);
  ge_add(acc, acc, neg_r, two_d, false);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) ge_double(acc, acc, false);
  const bool good = fe_is_zero(acc.X) && fe_eq(acc.Y, acc.Z) && a_ok && r_ok;
  ok[lane] = good ? 1 : 0;
}

}  // namespace

extern "C" int ed25519_verify_launch(const void* a_cols, const void* r_cols,
                                     const void* s_win, const void* k_win,
                                     const void* consts, int n, void* ok,
                                     void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  ed25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a_cols, (const int32_t*)r_cols, (const int32_t*)s_win,
      (const int32_t*)k_win, (const int32_t*)consts, n, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
