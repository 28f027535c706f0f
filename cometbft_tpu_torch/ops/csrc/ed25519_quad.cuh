// The four-thread point rounds of the batch ed25519 verifier for Hopper
// (sm_90a), on the field of ed25519_field.cuh.  Lanes 4q..4q+3 of a warp
// own one point and all hold it whole.  Each round of the 4-way
// extended-coordinate formulas (Hisil, Wong, Carter, Dawson, "Twisted
// Edwards Curves Revisited", 2008) has thread c compute product c, then
// __shfl_sync (width 4) gathers the four results into every thread.  A
// doubling (dbl-2008-hwcd) and an addition (add-2008-hwcd-3) are 2 rounds
// each.  Every thread must reach every shuffle: a caller runs a thread
// past its last lane on the last real lane and guards only the store.
//
// Included by ed25519_verify.cu (the verify kernel, B1) and microbench.cu
// (its double, add, madd and window loops, B3), so both run one source.
// The plain PyTorch version of each round is ops/ed25519_kernel.py's
// _quad_* helpers; the two agree limb for limb.  Every product operand
// stays within 4 resting values (MAX_LAZY, the bound of
// ed25519_field.cuh), checked round by round on the plain helpers by
// tests/test_torch_ed25519_quad.py and tests/test_torch_microbench.py.

#pragma once

#include "ed25519_field.cuh"

namespace {

constexpr int QUAD = 4;
constexpr unsigned FULL = 0xffffffffu;

// Round result r of thread k lands in coordinate k of out, in every
// thread of the quad.
__device__ __forceinline__ void quad_gather(ge& out, const fe& r) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) {
    out.X.v[i] = __shfl_sync(FULL, r.v[i], 0, QUAD);
    out.Y.v[i] = __shfl_sync(FULL, r.v[i], 1, QUAD);
    out.Z.v[i] = __shfl_sync(FULL, r.v[i], 2, QUAD);
    out.T.v[i] = __shfl_sync(FULL, r.v[i], 3, QUAD);
  }
}

// out = the operand of thread c among four.
__device__ __forceinline__ void fe_pick(fe& out, int c, const fe& f0,
                                        const fe& f1, const fe& f2,
                                        const fe& f3) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i)
    out.v[i] = c == 0 ? f0.v[i] : c == 1 ? f1.v[i] : c == 2 ? f2.v[i]
                                                          : f3.v[i];
}

// Round 2 of an add or a double: thread c computes X3 = E·F, Y3 = G·H,
// Z3 = F·G or T3 = E·H (ed25519_kernel._quad_finish).
__device__ __forceinline__ void quad_finish(ge& p, int c, const fe& e,
                                            const fe& f, const fe& g,
                                            const fe& h) {
  fe lhs, rhs, r;
  fe_pick(lhs, c, e, g, f, e);
  fe_pick(rhs, c, f, h, g, h);
  fe_mul(r, lhs, rhs);
  quad_gather(p, r);
}

// p = 2p (ed25519_kernel._quad_double).  Round 1: X², Y², Z², (X+Y)².
__device__ __forceinline__ void quad_double(ge& p, int c) {
  fe s, r;
  fe_add(s, p.X, p.Y);
  fe_pick(s, c, p.X, p.Y, p.Z, s);
  fe_sqr(r, s);
  ge q;
  quad_gather(q, r);
  fe zz, e, f, g, h;
  fe_add(zz, q.Z, q.Z);
  fe_sub(e, q.T, q.X);
  fe_sub(e, e, q.Y);
  fe_sub(g, q.Y, q.X);
  fe_sub(f, g, zz);
  fe_add(h, q.X, q.Y);
  fe_neg(h, h);
  quad_finish(p, c, e, f, g, h);
}

// Round-1 operand of thread c for adding a point to p: Y1-X1, Y1+X1, T1
// or, for thread 3, `last`.
__device__ __forceinline__ void add_operand(fe& lhs, const ge& p, int c,
                                            const fe& last) {
  fe ymx, ypx;
  fe_sub(ymx, p.Y, p.X);
  fe_add(ypx, p.Y, p.X);
  fe_pick(lhs, c, ymx, ypx, p.T, last);
}

// Round 2 of an add from the gathered round-1 products (A, B, C, D).
__device__ __forceinline__ void add_finish(ge& p, int c, const ge& q) {
  fe e, f, g, h;
  fe_sub(e, q.Y, q.X);
  fe_sub(f, q.T, q.Z);
  fe_add(g, q.T, q.Z);
  fe_add(h, q.Y, q.X);
  quad_finish(p, c, e, f, g, h);
}

// p += Q, where mine is coordinate c of Q in cached form (Y-X, Y+X,
// 2d·T, 2Z): round 1 is (Y1-X1)·YmX, (Y1+X1)·YpX, T1·2dT, Z1·2Z
// (ed25519_kernel._quad_add_cached).
__device__ __forceinline__ void quad_add_cached(ge& p, int c, const fe& mine) {
  fe lhs, r;
  add_operand(lhs, p, c, p.Z);
  fe_mul(r, lhs, mine);
  ge q;
  quad_gather(q, r);
  add_finish(p, c, q);
}

// p += Q for an affine Q (y-x, y+x, 2d·x·y; Z = 1), mine = coordinate c
// of it for c < 3.  D = 2·Z1 needs no product, so thread 3's round-1 slot
// computes 2d·T1, which comes back in t2d_p: the cached coordinate of p
// before the add (ed25519_kernel._quad_madd).
__device__ __forceinline__ void quad_madd(ge& p, int c, const fe& mine,
                                          const fe& two_d, fe& t2d_p) {
  fe lhs, rhs, r;
  add_operand(lhs, p, c, p.T);
  fe_pick(rhs, c, mine, mine, mine, two_d);
  fe_mul(r, lhs, rhs);
  ge q;
  quad_gather(q, r);
  t2d_p = q.T;
  fe_add(q.T, p.Z, p.Z);
  add_finish(p, c, q);
}

// Coordinate c of the cached form of p, given 2d·T of p: thread c
// stores only its own coordinate.
__device__ __forceinline__ void cached_coord(fe& out, const ge& p, int c,
                                             const fe& t2d) {
  fe ymx, ypx, z2;
  fe_sub(ymx, p.Y, p.X);
  fe_add(ypx, p.Y, p.X);
  fe_add(z2, p.Z, p.Z);
  fe_pick(out, c, ymx, ypx, t2d, z2);
}

// Entry e of a lane table in shared memory laid out [entry][limb][thread]
// for a block of W threads: each thread writes its own column, so the
// accesses are conflict-free and need no barrier.
template <int W>
__device__ __forceinline__ void tab_store(int32_t (*tab)[LIMBS][W], int e,
                                          const fe& v) {
#pragma unroll
  for (int i = 0; i < LIMBS; ++i) tab[e][i][threadIdx.x] = v.v[i];
}

}  // namespace
