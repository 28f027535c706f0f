// Per-primitive microbenchmarks of the batch ed25519 verifier for Hopper
// (sm_90a): loops over the device code ed25519_verify.cu runs.  carry,
// mul and sqr loop over the field of ed25519_field.cuh, so their times
// are the cost of a verifier round's product; double, add, madd and
// window loop over the verifier's own four-thread rounds of
// ed25519_quad.cuh, so their times are the cost of its rounds.
//
// Replaces the Pallas TPU kernels of cometbft_tpu/ops/microbench.py
// (_make_kernel(op, reps), :82; launched by _bench_call, :178).  One
// template, mb_kernel<OP>, covers the nine ops; each runs `reps`
// iterations of one primitive per lane, every iteration feeding the
// next, and stores the result, so nothing is dead code:
//   noop      the seed only
//   carry     fe_carry of the value
//   mul       (u, w) -> (u·w, u)
//   sqr       u -> u²
//   double    quad_double
//   add       quad_add_cached of the seed point p in cached form
//   madd      quad_madd of the affine B-table entry 3
//   select16  sum of the y-x coordinate of B-table entry (x0 + j) & 15,
//             in int64 limbs (512 entries of up to 2^25 overflow int32),
//             carried once at the end
//   window    4 quad_doubles, quad_madd of B-table entry
//             w = (x0 + j) & 15, quad_add_cached of entry w of a
//             16-entry lane table made of 16 copies of p in cached form
// The seed is x = the 32 input bytes as a field element (bit 255 added
// at 19, since fe_from_bytes drops it), y = 2x, p = (x, y, 1, xy).  The
// output is [10, n] int32: the limbs of the value, or of X.  The plain
// PyTorch version is cometbft_tpu_torch/ops/microbench.bench_cols_plain;
// the two agree limb for limb.
//
// Bound on this card: integer issue, counted on the products and carries
// the output reads (chip_smoke.py; see PERF.md).  A chain is one lane's
// dependent products, so at 16,384 lanes the card runs short of warps to
// hide their latency:
//
//   * carry, mul, sqr, select16 and noop run one thread a lane, 32
//     threads a block: 512 warps at 16,384 lanes, about one a scheduler.
//   * The point ops run a quad a lane, 64 threads a block (16 lanes), as
//     the verifier runs a signature: lanes 4q..4q+3 of a warp own one
//     chain and each holds the whole point in registers; in each round
//     thread c computes product c and __shfl_sync (width 4) gathers the
//     four.  The chain is a quarter as deep, and 16,384 lanes are 2,048
//     warps, about four a scheduler.  Every thread reaches every shuffle:
//     a thread past the last lane runs on the last real lane, and only
//     thread 0 of a real quad stores.
//   * window keeps its 16-entry lane table in shared memory as the
//     verifier does, [entry][limb][thread] with thread c holding
//     coordinate c (640 B a thread, 40,960 B a block), and selects entry
//     w by the lane's own window; add reads its one entry from a shared
//     slot each step, as the verifier reads its table.

#include "ed25519_quad.cuh"

namespace {

constexpr int MB_THREADS = 32;
constexpr int QUAD_THREADS = 64;

enum : int {
  OP_NOOP, OP_CARRY, OP_MUL, OP_SQR, OP_DOUBLE, OP_ADD, OP_MADD,
  OP_SELECT16, OP_WINDOW
};

// the point ops run four threads a lane
template <int OP>
constexpr bool QUAD_OP =
    OP == OP_DOUBLE || OP == OP_ADD || OP == OP_MADD || OP == OP_WINDOW;
template <int OP>
constexpr int OP_THREADS = QUAD_OP<OP> ? QUAD_THREADS : MB_THREADS;
template <int OP>
constexpr int THREADS_A_LANE = QUAD_OP<OP> ? QUAD : 1;

template <int OP>
__global__ void __launch_bounds__(OP_THREADS<OP>)
mb_kernel(const int32_t* __restrict__ x_cols,
          const int32_t* __restrict__ consts, int n, int reps,
          int32_t* __restrict__ out) {
  __shared__ int32_t sc[C_TOTAL];
  for (int i = threadIdx.x; i < C_TOTAL; i += blockDim.x) sc[i] = consts[i];
  __syncthreads();
  const int id = (blockIdx.x * blockDim.x + threadIdx.x) / THREADS_A_LANE<OP>;
  if constexpr (!QUAD_OP<OP>) {
    if (id >= n) return;
  }
  const int lane = id < n ? id : n - 1;     // past the end: the last lane
  const int c = threadIdx.x & (QUAD - 1);

  int32_t b[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) b[i] = x_cols[(size_t)i * n + lane] & 0xFF;
  fe x, y, one, two_d;
  {
    fe raw;
    fe_from_bytes(raw, b);
    int64_t h[LIMBS];
#pragma unroll
    for (int i = 0; i < LIMBS; ++i) h[i] = raw.v[i];
    h[0] += 19 * (b[31] >> 7);
    fe_carry(x, h);
#pragma unroll
    for (int i = 0; i < LIMBS; ++i) h[i] = (int64_t)x.v[i] + x.v[i];
    fe_carry(y, h);
  }
  fe_one(one);
  fe_load(two_d, sc + C_2D);
  ge p;
  p.X = x;
  p.Y = y;
  p.Z = one;
  fe_mul(p.T, x, y);
  const int w0 = b[0] & 15;
  const int bc = c < 3 ? c : 0;             // thread 3 reads no B entry

  fe res;
  if constexpr (OP == OP_NOOP) {
    res = x;
  } else if constexpr (OP == OP_CARRY) {
    res = x;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      int64_t h[LIMBS];
#pragma unroll
      for (int i = 0; i < LIMBS; ++i) h[i] = res.v[i];
      fe_carry(res, h);
    }
  } else if constexpr (OP == OP_MUL) {
    fe u = x, w = y, t;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      fe_mul(t, u, w);
      w = u;
      u = t;
    }
    res = u;
  } else if constexpr (OP == OP_SQR) {
    res = x;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) fe_sqr(res, res);
  } else if constexpr (OP == OP_DOUBLE) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r) quad_double(p, c);
    res = p.X;
  } else if constexpr (OP == OP_ADD) {
    // p's cached form sits in a shared slot, read each step as the
    // verifier reads its table entry.  volatile keeps the read in the
    // loop: with the entry in registers across it, nvcc split each limb
    // product of round 1 into IMAD.WIDE.U32 and two IMADs (917
    // instructions a step, not 601), which the verifier never does.
    __shared__ int32_t slot[LIMBS][QUAD_THREADS];
    volatile int32_t(*entry)[QUAD_THREADS] = slot;
    fe t2d, mine;
    fe_mul(t2d, p.T, two_d);
    cached_coord(mine, p, c, t2d);
#pragma unroll
    for (int i = 0; i < LIMBS; ++i) entry[i][threadIdx.x] = mine.v[i];
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int i = 0; i < LIMBS; ++i) mine.v[i] = entry[i][threadIdx.x];
      quad_add_cached(p, c, mine);
    }
    res = p.X;
  } else if constexpr (OP == OP_MADD) {
    fe mine, t2d;
    fe_load(mine, sc + C_BTAB + (3 * 3 + bc) * LIMBS);
#pragma unroll 1
    for (int r = 0; r < reps; ++r) quad_madd(p, c, mine, two_d, t2d);
    res = p.X;
  } else if constexpr (OP == OP_SELECT16) {
    int64_t acc[LIMBS];
#pragma unroll
    for (int i = 0; i < LIMBS; ++i) acc[i] = 0;
#pragma unroll 1
    for (int j = 0; j < reps; ++j) {
      const int32_t* e = sc + C_BTAB + ((w0 + j) & 15) * 3 * LIMBS;
#pragma unroll
      for (int i = 0; i < LIMBS; ++i) acc[i] += e[i];
    }
    fe_carry(res, acc);
  } else if constexpr (OP == OP_WINDOW) {
    __shared__ int32_t tab[16][LIMBS][QUAD_THREADS];
    fe t2d, mine;
    fe_mul(t2d, p.T, two_d);
    cached_coord(mine, p, c, t2d);
#pragma unroll 1
    for (int e = 0; e < 16; ++e) tab_store(tab, e, mine);
#pragma unroll 1
    for (int j = 0; j < reps; ++j) {
#pragma unroll 1
      for (int i = 0; i < 4; ++i) quad_double(p, c);
      const int w = (w0 + j) & 15;
      fe_load(mine, sc + C_BTAB + (w * 3 + bc) * LIMBS);
      quad_madd(p, c, mine, two_d, t2d);
#pragma unroll
      for (int i = 0; i < LIMBS; ++i) mine.v[i] = tab[w][i][threadIdx.x];
      quad_add_cached(p, c, mine);
    }
    res = p.X;
  }
  if (!QUAD_OP<OP> || (c == 0 && id < n)) {
#pragma unroll
    for (int i = 0; i < LIMBS; ++i) out[(size_t)i * n + lane] = res.v[i];
  }
}

template <int OP>
int mb_launch(const void* x_cols, const void* consts, int n, int reps,
              void* out, void* stream) {
  const int blocks = (int)(((int64_t)n * THREADS_A_LANE<OP> + OP_THREADS<OP> -
                            1) / OP_THREADS<OP>);
  mb_kernel<OP><<<blocks, OP_THREADS<OP>, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x_cols, (const int32_t*)consts, n, reps,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// op is the index of the op in microbench.REPS (the order of the enum).
extern "C" int microbench_launch(int op, const void* x_cols,
                                 const void* consts, int n, int reps,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  switch (op) {
    case OP_NOOP: return mb_launch<OP_NOOP>(x_cols, consts, n, reps, out, stream);
    case OP_CARRY: return mb_launch<OP_CARRY>(x_cols, consts, n, reps, out, stream);
    case OP_MUL: return mb_launch<OP_MUL>(x_cols, consts, n, reps, out, stream);
    case OP_SQR: return mb_launch<OP_SQR>(x_cols, consts, n, reps, out, stream);
    case OP_DOUBLE: return mb_launch<OP_DOUBLE>(x_cols, consts, n, reps, out, stream);
    case OP_ADD: return mb_launch<OP_ADD>(x_cols, consts, n, reps, out, stream);
    case OP_MADD: return mb_launch<OP_MADD>(x_cols, consts, n, reps, out, stream);
    case OP_SELECT16: return mb_launch<OP_SELECT16>(x_cols, consts, n, reps, out, stream);
    case OP_WINDOW: return mb_launch<OP_WINDOW>(x_cols, consts, n, reps, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
