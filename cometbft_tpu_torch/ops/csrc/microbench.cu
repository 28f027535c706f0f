// Per-primitive microbenchmarks of the batch ed25519 verifier for Hopper
// (sm_90a): loops over the device functions of ed25519_field.cuh.  carry,
// mul and sqr are the field code ed25519_verify.cu runs, so their times
// are the cost of a verifier round's product; double, add, madd and
// window run the header's single-thread point formulas, which the
// verifier replaced by four-thread rounds.
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
//   double    ge_double (with T)
//   add       ge_add of the seed point p
//   madd      ge_madd of the affine B-table entry 3
//   select16  sum of the y-x coordinate of B-table entry (x0 + j) & 15,
//             in int64 limbs (512 entries of up to 2^25 overflow int32),
//             carried once at the end
//   window    4 doublings (T on the last), ge_madd of B-table entry
//             w = (x0 + j) & 15, ge_add of entry w of a 16-entry lane
//             table made of 16 copies of p
// The seed is x = the 32 input bytes as a field element (bit 255 added
// at 19, since fe_from_bytes drops it), y = 2x, p = (x, y, 1, xy).  The
// output is [10, n] int32: the limbs of the value, or of X.  The plain
// PyTorch version is cometbft_tpu_torch/ops/microbench.bench_cols_plain;
// the two agree limb for limb.
//
// One thread per lane, 32 threads a block.  A
// record at 16,384 lanes (512 warps) shows the latency of one lane's
// chain; more lanes show the issue rate.

#include "ed25519_field.cuh"

namespace {

constexpr int MB_THREADS = 32;

enum : int {
  OP_NOOP, OP_CARRY, OP_MUL, OP_SQR, OP_DOUBLE, OP_ADD, OP_MADD,
  OP_SELECT16, OP_WINDOW
};

template <int OP>
__global__ void __launch_bounds__(MB_THREADS)
mb_kernel(const int32_t* __restrict__ x_cols,
          const int32_t* __restrict__ consts, int n, int reps,
          int32_t* __restrict__ out) {
  __shared__ int32_t sc[C_TOTAL];
  for (int i = threadIdx.x; i < C_TOTAL; i += blockDim.x) sc[i] = consts[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

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
    ge q = p;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) ge_double(q, q, true);
    res = q.X;
  } else if constexpr (OP == OP_ADD) {
    ge q = p;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) ge_add(q, q, p, two_d, true);
    res = q.X;
  } else if constexpr (OP == OP_MADD) {
    ge q = p;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) ge_madd(q, q, sc + C_BTAB + 3 * 3 * LIMBS);
    res = q.X;
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
    ge lane_tab[16];
#pragma unroll 1
    for (int i = 0; i < 16; ++i) lane_tab[i] = p;
    ge q = p;
#pragma unroll 1
    for (int j = 0; j < reps; ++j) {
#pragma unroll 1
      for (int i = 0; i < 4; ++i) ge_double(q, q, i == 3);
      const int w = (w0 + j) & 15;
      ge_madd(q, q, sc + C_BTAB + w * 3 * LIMBS);
      ge_add(q, q, lane_tab[w], two_d, true);
    }
    res = q.X;
  }
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) out[(size_t)i * n + lane] = res.v[i];
}

template <int OP>
int mb_launch(const void* x_cols, const void* consts, int n, int reps,
              void* out, void* stream) {
  const int blocks = (n + MB_THREADS - 1) / MB_THREADS;
  mb_kernel<OP><<<blocks, MB_THREADS, 0, (cudaStream_t)stream>>>(
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
