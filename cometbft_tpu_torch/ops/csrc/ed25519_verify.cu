// Batch ed25519 verification (ZIP-215, cofactored) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cometbft_tpu/ops/ed25519_pallas.py
// (_kernel, :379; launched by _pallas_verify, :469).  Same function and
// the same public layout: A and R as [32, n] int32 byte columns, s and k
// as [64, n] int32 4-bit windows; one verdict byte per lane out.  The
// plain PyTorch version of the function is
// cometbft_tpu_torch/ops/ed25519_kernel.py (verify_cols_plain) on
// ops/field.py; the round formulas (ed25519_quad.cuh) are its _quad_*
// helpers.
//
// Bound on this card: integer issue.  The function takes 3,585 field
// multiplies a signature as verify_cols_plain counts them (1,546 of them
// squarings) and moves 193 bytes a lane; the bound's formula is in
// PERF.md.  One thread a signature left it latency-bound: 4,096 lanes are
// 128 warps on 528 schedulers, and one thread's chain of 3,585 dependent
// multiplies set the time.  So the design shortens the chain and fills
// the schedulers:
//
//   * A quad per signature.  Lanes 4q..4q+3 of a warp own one signature
//     and all hold the same accumulator.  Each round of the 4-way
//     extended-coordinate formulas (Hisil, Wong, Carter, Dawson,
//     "Twisted Edwards Curves Revisited", 2008) has each thread compute
//     one of four independent products, then __shfl_sync (width 4)
//     gathers the four results into every thread.  A doubling
//     (dbl-2008-hwcd) and an addition (add-2008-hwcd-3) are 2 rounds
//     each, so a window is 12 rounds; the chain is about 1,070 products
//     deep instead of 3,585.  A 4,096-lane tile is 512 warps.
//   * Every thread runs every shuffle: a thread past the last signature
//     computes on the last lane and only the store is guarded.  The
//     data-dependent selects of decompression hold no shuffle.
//   * Decompression of A (threads 0, 2) and R (threads 1, 3) runs side by
//     side, the same instructions on different data.
//   * The table i·(-A) is kept in cached form (Y-X, Y+X, 2d·T, 2Z); thread
//     c keeps coordinate c of each entry, 16 x 10 int32 = 640 B, in shared
//     memory ([entry][limb][thread]: conflict-free, indexed by the lane's
//     own window without going through the stack).  The window add then
//     needs one product per thread: (Y1-X1)·YmX, (Y1+X1)·YpX, T1·2dT and
//     Z1·2Z.  The mixed adds of an affine point (the B-table entry, -A
//     while the table is built, -R) form D = 2·Z1 without a product, and
//     thread 3 computes 2d·T1 in that slot: the last coordinate of the
//     table entry the running point becomes.
//   * The point steps are force-inlined and take the point by reference
//     inside the one function, so no operand crosses a call boundary.
//   * Every product operand stays within 4 resting values (MAX_LAZY, the
//     bound of ed25519_field.cuh), checked round by round on the plain
//     helpers by tests/test_torch_ed25519_quad.py.
//
// The constant block (D, 2D, sqrt(-1), the affine 16 x 3 B table) is
// copied to shared memory once per block.

#include "ed25519_quad.cuh"

namespace {

constexpr int WINDOWS = 64;
constexpr int THREADS = 64;               // 16 signatures a block

__global__ void __launch_bounds__(THREADS)
ed25519_verify_kernel(const int32_t* __restrict__ a_cols,
                      const int32_t* __restrict__ r_cols,
                      const int32_t* __restrict__ s_win,
                      const int32_t* __restrict__ k_win,
                      const int32_t* __restrict__ consts, int n,
                      uint8_t* __restrict__ ok) {
  __shared__ int32_t sc[C_TOTAL];
  __shared__ int32_t tab[16][LIMBS][THREADS];
  for (int i = threadIdx.x; i < C_TOTAL; i += blockDim.x) sc[i] = consts[i];
  __syncthreads();
  const int c = threadIdx.x & (QUAD - 1);
  const int sig = (blockIdx.x * THREADS + threadIdx.x) / QUAD;
  const int lane = sig < n ? sig : n - 1;   // past the end: the last lane

  fe two_d, two, zero, one;
  fe_load(two_d, sc + C_2D);
  fe_zero(zero);
  fe_one(one);
  fe_zero(two);
  two.v[0] = 2;

  // A in threads 0 and 2, R in threads 1 and 3; then each thread's
  // point -P = (-x, y, 1, T) and 2d·T, and the quad shares them
  fe x, y, t, t2d;
  const bool p_ok = ge_decompress(x, y, (c & 1) ? r_cols : a_cols, n, lane,
                                  sc);
  fe_neg(x, x);
  fe_mul(t, x, y);
  fe_mul(t2d, t, two_d);
  const bool a_ok = __shfl_sync(FULL, (int)p_ok, 0, QUAD) != 0;
  const bool r_ok = __shfl_sync(FULL, (int)p_ok, 1, QUAD) != 0;
  ge neg_a, neg_r;
  fe neg_a_t2d, neg_r_t2d;
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    neg_a.X.v[i] = __shfl_sync(FULL, x.v[i], 0, QUAD);
    neg_a.Y.v[i] = __shfl_sync(FULL, y.v[i], 0, QUAD);
    neg_a.T.v[i] = __shfl_sync(FULL, t.v[i], 0, QUAD);
    neg_a_t2d.v[i] = __shfl_sync(FULL, t2d.v[i], 0, QUAD);
    neg_r.X.v[i] = __shfl_sync(FULL, x.v[i], 1, QUAD);
    neg_r.Y.v[i] = __shfl_sync(FULL, y.v[i], 1, QUAD);
    neg_r_t2d.v[i] = __shfl_sync(FULL, t2d.v[i], 1, QUAD);
  }
  neg_a.Z = one;
  neg_r.Z = one;

  // table of i·(-A), i = 0..15, cached.  Entry 0 is (1, 1, 0, 2).  Each
  // mixed add of -A returns 2d·T of the running point i·(-A), the last
  // coordinate of entry i.
  fe mine, neg_a_mine;
  fe_pick(mine, c, one, one, zero, two);
  tab_store(tab, 0, mine);
  cached_coord(neg_a_mine, neg_a, c, neg_a_t2d);
  ge acc = neg_a;
#pragma unroll 1
  for (int i = 1; i < 15; ++i) {
    ge prev = acc;
    quad_madd(acc, c, neg_a_mine, two_d, t2d);
    cached_coord(mine, prev, c, t2d);           // entry i
    tab_store(tab, i, mine);
  }
  fe_mul(t2d, acc.T, two_d);                    // entry 15
  cached_coord(mine, acc, c, t2d);
  tab_store(tab, 15, mine);

  // 64 windows from the top: 4 doublings, a mixed add of the B-table
  // entry of the s window, an add of the lane-table entry of the k window
  acc.X = zero;
  acc.Y = one;
  acc.Z = one;
  acc.T = zero;
  const int bc = c < 3 ? c : 0;                 // thread 3 reads no entry
#pragma unroll 1
  for (int j = 0; j < WINDOWS; ++j) {
    const int w = WINDOWS - 1 - j;
#pragma unroll 1
    for (int i = 0; i < 4; ++i) quad_double(acc, c);
    const int sw = s_win[(size_t)w * n + lane] & 15;
    const int kw = k_win[(size_t)w * n + lane] & 15;
    fe_load(mine, sc + C_BTAB + (sw * 3 + bc) * LIMBS);
    quad_madd(acc, c, mine, two_d, t2d);
#pragma unroll
    for (int i = 0; i < LIMBS; ++i) mine.v[i] = tab[kw][i][threadIdx.x];
    quad_add_cached(acc, c, mine);
  }

  // add -R (affine), double 3 times, test the identity
  cached_coord(mine, neg_r, c, neg_r_t2d);
  quad_madd(acc, c, mine, two_d, t2d);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) quad_double(acc, c);
  const bool good = fe_is_zero(acc.X) && fe_eq(acc.Y, acc.Z) && a_ok && r_ok;
  if (c == 0 && sig < n) ok[sig] = good ? 1 : 0;
}

}  // namespace

extern "C" int ed25519_verify_launch(const void* a_cols, const void* r_cols,
                                     const void* s_win, const void* k_win,
                                     const void* consts, int n, void* ok,
                                     void* stream) {
  if (n <= 0) return 0;
  const int blocks = (int)(((int64_t)n * QUAD + THREADS - 1) / THREADS);
  ed25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a_cols, (const int32_t*)r_cols, (const int32_t*)s_win,
      (const int32_t*)k_win, (const int32_t*)consts, n, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

extern "C" const char* ed25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
