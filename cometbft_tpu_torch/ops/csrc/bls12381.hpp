// BLS12-381 pairing arithmetic in C++ — the native fast path for the
// engine's verify-side BLS (reference parity note: the reference's one
// native dependency is the blst C library; this is the analogous
// native component, built against OUR pure-python golden model in
// cometbft_tpu/crypto/_bls12381_math.py).
//
// The structure mirrors the python module one-to-one — same tower
// (Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-(1+u)), Fq12 = Fq6[w]/
// (w^2-v)) and the same RFC-9380 SSWU hash-to-curve as the python
// golden model, so every function is differentially tested against
// it.  Where this port diverges for speed — projective Fq2 Miller
// loop with sparse lines, Frobenius-decomposed final exponentiation
// with Granger-Scott cyclotomic squaring, psi-endomorphism subgroup
// checks and cofactor clearing — each fast path is proven equivalent
// to the plain formulation by the runtime selftest.  Fq uses 6x64
// Montgomery arithmetic (CIOS).
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

#include "sha256.hpp"

namespace bls {

// --- Fq: 6x64-limb Montgomery ----------------------------------------------

struct Fp {
    uint64_t v[6];
};

static const uint64_t P_LIMBS[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL,
    0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
    0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const uint64_t N0 = 0x89f3fffcfffcfffdULL;
static const uint64_t R1_LIMBS[6] = {
    0x760900000002fffdULL, 0xebf4000bc40c0002ULL,
    0x5f48985753c758baULL, 0x77ce585370525745ULL,
    0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL};
static const uint64_t R2_LIMBS[6] = {
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL,
    0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL,
    0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};

inline Fp fp_zero() { Fp r{}; return r; }
inline Fp fp_one() {
    Fp r;
    std::memcpy(r.v, R1_LIMBS, sizeof r.v);
    return r;
}

inline bool fp_is_zero(const Fp& a) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a.v[i];
    return acc == 0;
}

inline bool fp_eq(const Fp& a, const Fp& b) {
    uint64_t acc = 0;
    for (int i = 0; i < 6; i++) acc |= a.v[i] ^ b.v[i];
    return acc == 0;
}

inline int fp_cmp_raw(const uint64_t a[6], const uint64_t b[6]) {
    for (int i = 5; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

inline void raw_sub_p(uint64_t a[6]) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        unsigned __int128 d =
            (unsigned __int128)a[i] - P_LIMBS[i] - (uint64_t)borrow;
        a[i] = uint64_t(d);
        borrow = (d >> 64) ? 1 : 0;
    }
}

inline Fp fp_add(const Fp& a, const Fp& b) {
    Fp r;
    unsigned __int128 carry = 0;
    for (int i = 0; i < 6; i++) {
        unsigned __int128 s =
            (unsigned __int128)a.v[i] + b.v[i] + (uint64_t)carry;
        r.v[i] = uint64_t(s);
        carry = s >> 64;
    }
    if (carry || fp_cmp_raw(r.v, P_LIMBS) >= 0) raw_sub_p(r.v);
    return r;
}

inline Fp fp_sub(const Fp& a, const Fp& b) {
    Fp r;
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        unsigned __int128 d =
            (unsigned __int128)a.v[i] - b.v[i] - (uint64_t)borrow;
        r.v[i] = uint64_t(d);
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        unsigned __int128 carry = 0;
        for (int i = 0; i < 6; i++) {
            unsigned __int128 s =
                (unsigned __int128)r.v[i] + P_LIMBS[i] +
                (uint64_t)carry;
            r.v[i] = uint64_t(s);
            carry = s >> 64;
        }
    }
    return r;
}

inline Fp fp_neg(const Fp& a) {
    if (fp_is_zero(a)) return a;
    Fp p;
    std::memcpy(p.v, P_LIMBS, sizeof p.v);
    return fp_sub(p, a);
}

// CIOS Montgomery multiplication (portable; also the differential
// reference for the ADX path below)
inline Fp fp_mul_generic(const Fp& a, const Fp& b) {
    uint64_t t[8] = {0};
    for (int i = 0; i < 6; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < 6; j++) {
            unsigned __int128 cur =
                (unsigned __int128)a.v[i] * b.v[j] + t[j] +
                (uint64_t)carry;
            t[j] = uint64_t(cur);
            carry = cur >> 64;
        }
        unsigned __int128 s =
            (unsigned __int128)t[6] + (uint64_t)carry;
        t[6] = uint64_t(s);
        t[7] = uint64_t(s >> 64);

        uint64_t m = t[0] * N0;
        carry = 0;
        {
            unsigned __int128 cur =
                (unsigned __int128)m * P_LIMBS[0] + t[0];
            carry = cur >> 64;
        }
        for (int j = 1; j < 6; j++) {
            unsigned __int128 cur =
                (unsigned __int128)m * P_LIMBS[j] + t[j] +
                (uint64_t)carry;
            t[j - 1] = uint64_t(cur);
            carry = cur >> 64;
        }
        s = (unsigned __int128)t[6] + (uint64_t)carry;
        t[5] = uint64_t(s);
        t[6] = t[7] + uint64_t(s >> 64);
        t[7] = 0;
    }
    Fp r;
    std::memcpy(r.v, t, sizeof r.v);
    if (t[6] || fp_cmp_raw(r.v, P_LIMBS) >= 0) raw_sub_p(r.v);
    return r;
}

#if defined(__ADX__) && defined(__BMI2__)
// MULX/ADCX/ADOX interleaved-CIOS Montgomery multiply.  Two carry
// chains ride CF (adcx) and OF (adox) as the ISA intends — the
// compiler cannot be coaxed into this from __int128 code (it folds
// both chains onto CF), so the two per-round blocks are hand-written.
// Window analysis: t stays < 2p per round (standard CIOS bound), so
// seven limbs t0..t6 suffice and the chain-fold adds into t6 cannot
// overflow.  ~2x the generic CIOS on this class of core; the loader
// compiles -march=native so the gate matches the running machine.
// Differentially checked against fp_mul_generic in selftest().
inline Fp fp_mul(const Fp& a, const Fp& b) {
    uint64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0;
    const uint64_t* p = P_LIMBS;
    for (int i = 0; i < 6; i++) {
        asm volatile(
            "xorq %%r11, %%r11\n\t"          // clear CF+OF
            "mulxq 0(%[b]), %%r8, %%r9\n\t"  // rdx = a[i]
            "adcxq %%r8, %[t0]\n\t"
            "adoxq %%r9, %[t1]\n\t"
            "mulxq 8(%[b]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t1]\n\t"
            "adoxq %%r9, %[t2]\n\t"
            "mulxq 16(%[b]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t2]\n\t"
            "adoxq %%r9, %[t3]\n\t"
            "mulxq 24(%[b]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t3]\n\t"
            "adoxq %%r9, %[t4]\n\t"
            "mulxq 32(%[b]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t4]\n\t"
            "adoxq %%r9, %[t5]\n\t"
            "mulxq 40(%[b]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t5]\n\t"
            "adoxq %%r9, %[t6]\n\t"
            "movq $0, %%r8\n\t"
            "adcxq %%r8, %[t6]\n\t"
            : [t0] "+r"(t0), [t1] "+r"(t1), [t2] "+r"(t2),
              [t3] "+r"(t3), [t4] "+r"(t4), [t5] "+r"(t5),
              [t6] "+r"(t6)
            : [b] "r"(b.v), "d"(a.v[i]),
              "m"(*(const uint64_t(*)[6])b.v)  // asm READS *b.v: the
              // operand forces the stores to land before the block
            : "r8", "r9", "r11", "cc");
        uint64_t m = t0 * N0;
        asm volatile(
            "xorq %%r11, %%r11\n\t"
            "mulxq 0(%[p]), %%r8, %%r9\n\t"  // rdx = m; kills t0
            "adcxq %%r8, %[t0]\n\t"
            "adoxq %%r9, %[t1]\n\t"
            "mulxq 8(%[p]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t1]\n\t"
            "adoxq %%r9, %[t2]\n\t"
            "mulxq 16(%[p]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t2]\n\t"
            "adoxq %%r9, %[t3]\n\t"
            "mulxq 24(%[p]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t3]\n\t"
            "adoxq %%r9, %[t4]\n\t"
            "mulxq 32(%[p]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t4]\n\t"
            "adoxq %%r9, %[t5]\n\t"
            "mulxq 40(%[p]), %%r8, %%r9\n\t"
            "adcxq %%r8, %[t5]\n\t"
            "adoxq %%r9, %[t6]\n\t"
            "movq $0, %%r8\n\t"
            "adcxq %%r8, %[t6]\n\t"
            : [t0] "+r"(t0), [t1] "+r"(t1), [t2] "+r"(t2),
              [t3] "+r"(t3), [t4] "+r"(t4), [t5] "+r"(t5),
              [t6] "+r"(t6)
            : [p] "r"(p), "d"(m),
              "m"(*(const uint64_t(*)[6])p)
            : "r8", "r9", "r11", "cc");
        t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = 0;
    }
    Fp r;
    r.v[0] = t0; r.v[1] = t1; r.v[2] = t2;
    r.v[3] = t3; r.v[4] = t4; r.v[5] = t5;
    if (fp_cmp_raw(r.v, P_LIMBS) >= 0) raw_sub_p(r.v);
    return r;
}
#else
inline Fp fp_mul(const Fp& a, const Fp& b) {
    return fp_mul_generic(a, b);
}
#endif

inline Fp fp_sqr(const Fp& a) { return fp_mul(a, a); }

inline Fp fp_muli(const Fp& a, int k) {
    // double-and-add: the Miller loop multiplies by 8/16/18/27/36
    // per iteration — a linear add chain would burn ~200 adds/step
    Fp out = fp_zero();
    Fp base = a;
    while (k) {
        if (k & 1) out = fp_add(out, base);
        k >>= 1;
        if (k) base = fp_add(base, base);
    }
    return out;
}

// generic pow over a big-endian exponent byte string
inline Fp fp_pow_be(const Fp& a, const uint8_t* e, size_t elen) {
    Fp out = fp_one();
    bool started = false;
    for (size_t i = 0; i < elen; i++) {
        for (int b = 7; b >= 0; b--) {
            if (started) out = fp_sqr(out);
            if ((e[i] >> b) & 1) {
                if (started) out = fp_mul(out, a);
                else { out = a; started = true; }
            }
        }
    }
    return started ? out : fp_one();
}

static const uint8_t PM2_BE[48] = {
    0x1a,0x01,0x11,0xea,0x39,0x7f,0xe6,0x9a,0x4b,0x1b,0xa7,0xb6,
    0x43,0x4b,0xac,0xd7,0x64,0x77,0x4b,0x84,0xf3,0x85,0x12,0xbf,
    0x67,0x30,0xd2,0xa0,0xf6,0xb0,0xf6,0x24,0x1e,0xab,0xff,0xfe,
    0xb1,0x53,0xff,0xff,0xb9,0xfe,0xff,0xff,0xff,0xff,0xaa,0xa9};
static const uint8_t PP14_BE[48] = {
    0x06,0x80,0x44,0x7a,0x8e,0x5f,0xf9,0xa6,0x92,0xc6,0xe9,0xed,
    0x90,0xd2,0xeb,0x35,0xd9,0x1d,0xd2,0xe1,0x3c,0xe1,0x44,0xaf,
    0xd9,0xcc,0x34,0xa8,0x3d,0xac,0x3d,0x89,0x07,0xaa,0xff,0xff,
    0xac,0x54,0xff,0xff,0xee,0x7f,0xbf,0xff,0xff,0xff,0xea,0xab};
inline Fp fp_inv(const Fp& a) { return fp_pow_be(a, PM2_BE, 48); }

// from/to big-endian 48-byte standard form
inline bool fp_from_be48(const uint8_t* b, Fp* out) {
    uint64_t raw[6];
    for (int i = 0; i < 6; i++) {
        uint64_t v = 0;
        for (int j = 0; j < 8; j++)
            v = (v << 8) | b[(5 - i) * 8 + j];
        raw[i] = v;
    }
    if (fp_cmp_raw(raw, P_LIMBS) >= 0) return false;
    Fp t, r2;
    std::memcpy(t.v, raw, sizeof t.v);
    std::memcpy(r2.v, R2_LIMBS, sizeof r2.v);
    *out = fp_mul(t, r2);      // to Montgomery
    return true;
}

inline void fp_to_be48(const Fp& a, uint8_t* out) {
    // from Montgomery: multiply by 1
    Fp one{};
    one.v[0] = 1;
    Fp std_form = fp_mul(a, one);
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 8; j++)
            out[(5 - i) * 8 + j] =
                uint8_t(std_form.v[i] >> (56 - 8 * j));
}

inline Fp fp_from_u64(uint64_t x) {
    Fp t{}, r2;
    t.v[0] = x;
    std::memcpy(r2.v, R2_LIMBS, sizeof r2.v);
    return fp_mul(t, r2);
}

inline bool fp_is_odd(const Fp& a) {
    uint8_t be[48];
    fp_to_be48(a, be);
    return be[47] & 1;
}

// sqrt via (p+1)/4 (p % 4 == 3); false if non-square
inline bool fp_sqrt(const Fp& a, Fp* out) {
    Fp r = fp_pow_be(a, PP14_BE, 48);
    if (!fp_eq(fp_sqr(r), a)) return false;
    *out = r;
    return true;
}

// --- Fq2 --------------------------------------------------------------------

struct Fp2 {
    Fp c0, c1;
};

inline Fp2 f2_zero() { return {fp_zero(), fp_zero()}; }
inline Fp2 f2_one() { return {fp_one(), fp_zero()}; }
inline bool f2_is_zero(const Fp2& a) {
    return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
inline bool f2_eq(const Fp2& a, const Fp2& b) {
    return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}
inline Fp2 f2_add(const Fp2& a, const Fp2& b) {
    return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
inline Fp2 f2_sub(const Fp2& a, const Fp2& b) {
    return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
inline Fp2 f2_neg(const Fp2& a) {
    return {fp_neg(a.c0), fp_neg(a.c1)};
}
inline Fp2 f2_mul(const Fp2& a, const Fp2& b) {
    Fp t0 = fp_mul(a.c0, b.c0);
    Fp t1 = fp_mul(a.c1, b.c1);
    Fp s = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
    return {fp_sub(t0, t1), fp_sub(fp_sub(s, t0), t1)};
}
inline Fp2 f2_sqr(const Fp2& a) {
    Fp s = fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1));
    Fp d = fp_mul(a.c0, a.c1);
    return {s, fp_add(d, d)};
}
inline Fp2 f2_muli(const Fp2& a, int k) {
    return {fp_muli(a.c0, k), fp_muli(a.c1, k)};
}
inline Fp2 f2_inv(const Fp2& a) {
    Fp d = fp_inv(fp_add(fp_sqr(a.c0), fp_sqr(a.c1)));
    return {fp_mul(a.c0, d), fp_neg(fp_mul(a.c1, d))};
}
inline Fp2 f2_mul_xi(const Fp2& a) {
    // * (1 + u)
    return {fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}

// sqrt in Fq2, mirroring the python norm-trick implementation
inline bool f2_sqrt(const Fp2& a, Fp2* out) {
    if (fp_is_zero(a.c1)) {
        Fp r;
        if (fp_sqrt(a.c0, &r)) {
            *out = {r, fp_zero()};
            return true;
        }
        if (fp_sqrt(fp_neg(a.c0), &r)) {
            *out = {fp_zero(), r};
            return true;
        }
        return false;
    }
    Fp alpha;
    if (!fp_sqrt(fp_add(fp_sqr(a.c0), fp_sqr(a.c1)), &alpha))
        return false;
    static const Fp inv2 = fp_inv(fp_from_u64(2));
    Fp delta = fp_mul(fp_add(a.c0, alpha), inv2);
    Fp x0;
    if (!fp_sqrt(delta, &x0)) {
        delta = fp_mul(fp_sub(a.c0, alpha), inv2);
        if (!fp_sqrt(delta, &x0)) return false;
    }
    Fp x1 = fp_mul(a.c1, fp_inv(fp_add(x0, x0)));
    Fp2 cand = {x0, x1};
    if (!f2_eq(f2_sqr(cand), a)) return false;
    *out = cand;
    return true;
}

// --- Fq6, Fq12 --------------------------------------------------------------

struct Fp6 {
    Fp2 a0, a1, a2;
};
struct Fp12 {
    Fp6 b0, b1;
};

inline Fp6 f6_zero() { return {f2_zero(), f2_zero(), f2_zero()}; }
inline Fp6 f6_one() { return {f2_one(), f2_zero(), f2_zero()}; }
inline bool f6_eq(const Fp6& a, const Fp6& b) {
    return f2_eq(a.a0, b.a0) && f2_eq(a.a1, b.a1) &&
           f2_eq(a.a2, b.a2);
}
inline Fp6 f6_add(const Fp6& a, const Fp6& b) {
    return {f2_add(a.a0, b.a0), f2_add(a.a1, b.a1),
            f2_add(a.a2, b.a2)};
}
inline Fp6 f6_sub(const Fp6& a, const Fp6& b) {
    return {f2_sub(a.a0, b.a0), f2_sub(a.a1, b.a1),
            f2_sub(a.a2, b.a2)};
}
inline Fp6 f6_neg(const Fp6& a) {
    return {f2_neg(a.a0), f2_neg(a.a1), f2_neg(a.a2)};
}
inline Fp6 f6_mul(const Fp6& a, const Fp6& b) {
    Fp2 t0 = f2_mul(a.a0, b.a0);
    Fp2 t1 = f2_mul(a.a1, b.a1);
    Fp2 t2 = f2_mul(a.a2, b.a2);
    Fp2 c0 = f2_add(t0, f2_mul_xi(f2_sub(
        f2_mul(f2_add(a.a1, a.a2), f2_add(b.a1, b.a2)),
        f2_add(t1, t2))));
    Fp2 c1 = f2_add(f2_sub(
        f2_mul(f2_add(a.a0, a.a1), f2_add(b.a0, b.a1)),
        f2_add(t0, t1)), f2_mul_xi(t2));
    Fp2 c2 = f2_add(f2_sub(
        f2_mul(f2_add(a.a0, a.a2), f2_add(b.a0, b.a2)),
        f2_add(t0, t2)), t1);
    return {c0, c1, c2};
}
inline Fp6 f6_sqr(const Fp6& a) { return f6_mul(a, a); }
inline Fp6 f6_mul_v(const Fp6& a) {
    return {f2_mul_xi(a.a2), a.a0, a.a1};
}
inline Fp6 f6_inv(const Fp6& a) {
    Fp2 c0 = f2_sub(f2_sqr(a.a0), f2_mul_xi(f2_mul(a.a1, a.a2)));
    Fp2 c1 = f2_sub(f2_mul_xi(f2_sqr(a.a2)), f2_mul(a.a0, a.a1));
    Fp2 c2 = f2_sub(f2_sqr(a.a1), f2_mul(a.a0, a.a2));
    Fp2 t = f2_inv(f2_add(
        f2_mul(a.a0, c0),
        f2_mul_xi(f2_add(f2_mul(a.a2, c1), f2_mul(a.a1, c2)))));
    return {f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t)};
}

inline Fp12 f12_zero() { return {f6_zero(), f6_zero()}; }
inline Fp12 f12_one() { return {f6_one(), f6_zero()}; }
inline bool f12_eq(const Fp12& a, const Fp12& b) {
    return f6_eq(a.b0, b.b0) && f6_eq(a.b1, b.b1);
}
inline Fp12 f12_add(const Fp12& a, const Fp12& b) {
    return {f6_add(a.b0, b.b0), f6_add(a.b1, b.b1)};
}
inline Fp12 f12_sub(const Fp12& a, const Fp12& b) {
    return {f6_sub(a.b0, b.b0), f6_sub(a.b1, b.b1)};
}
inline Fp12 f12_neg(const Fp12& a) {
    return {f6_neg(a.b0), f6_neg(a.b1)};
}
inline Fp12 f12_mul(const Fp12& a, const Fp12& b) {
    Fp6 t0 = f6_mul(a.b0, b.b0);
    Fp6 t1 = f6_mul(a.b1, b.b1);
    Fp6 c0 = f6_add(t0, f6_mul_v(t1));
    Fp6 c1 = f6_sub(f6_mul(f6_add(a.b0, a.b1), f6_add(b.b0, b.b1)),
                    f6_add(t0, t1));
    return {c0, c1};
}
inline Fp12 f12_sqr(const Fp12& a) {
    // (b0 + b1 w)^2 with w^2 = v: 2 Fq6 muls (complex squaring)
    Fp6 t = f6_mul(a.b0, a.b1);
    Fp6 tv = f6_mul_v(t);
    Fp6 c0 = f6_sub(f6_sub(
        f6_mul(f6_add(a.b0, a.b1), f6_add(a.b0, f6_mul_v(a.b1))),
        t), tv);
    return {c0, f6_add(t, t)};
}

// f12 multiply by a sparse Miller line {b0.a0 = c0; b1.a1 = c3,
// b1.a2 = c4}: 12 Fq2 muls vs f12_mul's 18
inline Fp12 f12_mul_sparse(const Fp12& f, const Fp2& c0,
                           const Fp2& c3, const Fp2& c4) {
    // L = c0 + L1 w, L1 = (0, c3, c4):
    //   result = (f.b0 c0 + v·(f.b1 L1)) + (f.b0 L1 + f.b1 c0) w
    const Fp6& a = f.b0;
    const Fp6& b = f.b1;
    Fp6 ac0 = {f2_mul(a.a0, c0), f2_mul(a.a1, c0),
               f2_mul(a.a2, c0)};
    Fp6 bc0 = {f2_mul(b.a0, c0), f2_mul(b.a1, c0),
               f2_mul(b.a2, c0)};
    // x·L1 for x = (x0, x1, x2):  (xi(x1 c4 + x2 c3),
    //                              x0 c3 + xi(x2 c4),
    //                              x0 c4 + x1 c3)
    auto mul_l1 = [&](const Fp6& x) -> Fp6 {
        return {f2_mul_xi(f2_add(f2_mul(x.a1, c4),
                                 f2_mul(x.a2, c3))),
                f2_add(f2_mul(x.a0, c3),
                       f2_mul_xi(f2_mul(x.a2, c4))),
                f2_add(f2_mul(x.a0, c4), f2_mul(x.a1, c3))};
    };
    Fp6 bl1 = mul_l1(b);
    Fp6 al1 = mul_l1(a);
    return {f6_add(ac0, f6_mul_v(bl1)), f6_add(al1, bc0)};
}
inline Fp12 f12_inv(const Fp12& a) {
    Fp6 t = f6_inv(f6_sub(f6_sqr(a.b0), f6_mul_v(f6_sqr(a.b1))));
    return {f6_mul(a.b0, t), f6_neg(f6_mul(a.b1, t))};
}
inline Fp12 f12_conj(const Fp12& a) { return {a.b0, f6_neg(a.b1)}; }

inline Fp12 f12_pow_be(const Fp12& a, const uint8_t* e, size_t elen) {
    Fp12 out = f12_one();
    bool started = false;
    for (size_t i = 0; i < elen; i++) {
        for (int b = 7; b >= 0; b--) {
            if (started) out = f12_sqr(out);
            if ((e[i] >> b) & 1) {
                if (started) out = f12_mul(out, a);
                else { out = a; started = true; }
            }
        }
    }
    return started ? out : f12_one();
}

// --- affine points ----------------------------------------------------------

struct G1 {
    Fp x, y;
    bool inf;
};
struct G2 {
    Fp2 x, y;
    bool inf;
};
// one affine implementation per field, mirroring the python formulas

#define DEFINE_PT_OPS(PT, F, fadd, fsub, fmul, fsqr, fneg, finv,      \
                      fiszero, feq, fmuli)                            \
    inline PT PT##_neg(const PT& p) {                                 \
        if (p.inf) return p;                                          \
        return {p.x, fneg(p.y), false};                               \
    }                                                                 \
    inline PT PT##_double(const PT& p) {                              \
        if (p.inf) return p;                                          \
        if (fiszero(p.y)) return {p.x, p.y, true};                    \
        F m = fmul(fmuli(fsqr(p.x), 3),                               \
                   finv(fmuli(p.y, 2)));                              \
        F nx = fsub(fsqr(m), fmuli(p.x, 2));                          \
        F ny = fsub(fmul(m, fsub(p.x, nx)), p.y);                     \
        return {nx, ny, false};                                       \
    }                                                                 \
    inline PT PT##_add(const PT& a, const PT& b) {                    \
        if (a.inf) return b;                                          \
        if (b.inf) return a;                                          \
        if (feq(a.x, b.x)) {                                          \
            if (feq(a.y, b.y)) return PT##_double(a);                 \
            return {a.x, a.y, true};                                  \
        }                                                             \
        F m = fmul(fsub(b.y, a.y), finv(fsub(b.x, a.x)));             \
        F nx = fsub(fsub(fsqr(m), a.x), b.x);                         \
        F ny = fsub(fmul(m, fsub(a.x, nx)), a.y);                     \
        return {nx, ny, false};                                       \
    }                                                                 \

inline Fp fp_muli_(const Fp& a, int k) { return fp_muli(a, k); }
DEFINE_PT_OPS(G1, Fp, fp_add, fp_sub, fp_mul, fp_sqr, fp_neg, fp_inv,
              fp_is_zero, fp_eq, fp_muli_)
DEFINE_PT_OPS(G2, Fp2, f2_add, f2_sub, f2_mul, f2_sqr, f2_neg,
              f2_inv, f2_is_zero, f2_eq, f2_muli)

// Jacobian scalar multiplication (one inversion at the end instead of
// one per step): (X, Y, Z) with x = X/Z^2, y = Y/Z^3.  Used for the
// long multiplications (subgroup checks, cofactor clearing, signing);
// the result is normalized back to affine, so outputs are
// byte-identical to the affine ladder and the python golden model.
#define DEFINE_JAC_MUL(PT, F, fadd, fsub, fmul, fsqr, fneg, finv,     \
                       fiszero, feq, fone)                            \
    struct PT##Jac { F X, Y, Z; };                                    \
    inline PT##Jac PT##_jac_double(const PT##Jac& p) {                \
        if (fiszero(p.Z) || fiszero(p.Y)) return {p.X, p.Y,           \
                                                  F{} /*zero*/};      \
        F A = fsqr(p.X);                                              \
        F B = fsqr(p.Y);                                              \
        F C = fsqr(B);                                                \
        F D0 = fsub(fsqr(fadd(p.X, B)), fadd(A, C));                  \
        F D = fadd(D0, D0);                                           \
        F E = fadd(fadd(A, A), A);                                    \
        F X3 = fsub(fsqr(E), fadd(D, D));                             \
        F C8 = fadd(C, C);                                            \
        C8 = fadd(C8, C8);                                            \
        C8 = fadd(C8, C8);                                            \
        F Y3 = fsub(fmul(E, fsub(D, X3)), C8);                        \
        F Z3 = fmul(fadd(p.Y, p.Y), p.Z);                             \
        return {X3, Y3, Z3};                                          \
    }                                                                 \
    inline PT##Jac PT##_jac_add_affine(const PT##Jac& p,              \
                                       const PT& q) {                 \
        if (fiszero(p.Z)) {                                           \
            /* p = inf: lift q */                                     \
            return {q.x, q.y, fone()};                                \
        }                                                             \
        F Z2 = fsqr(p.Z);                                             \
        F U2 = fmul(q.x, Z2);                                         \
        F S2 = fmul(fmul(q.y, Z2), p.Z);                              \
        if (feq(p.X, U2)) {                                           \
            if (feq(p.Y, S2)) return PT##_jac_double(p);              \
            return {p.X, p.Y, F{}};        /* p + (-p) = inf */       \
        }                                                             \
        F H = fsub(U2, p.X);                                          \
        F HH = fsqr(H);                                               \
        F I = fadd(HH, HH);                                           \
        I = fadd(I, I);                                               \
        F J = fmul(H, I);                                             \
        F rr = fsub(S2, p.Y);                                         \
        rr = fadd(rr, rr);                                            \
        F V = fmul(p.X, I);                                           \
        F X3 = fsub(fsub(fsqr(rr), J), fadd(V, V));                   \
        F Y2J = fmul(p.Y, J);                                         \
        F Y3 = fsub(fmul(rr, fsub(V, X3)), fadd(Y2J, Y2J));           \
        F Z3 = fmul(fadd(p.Z, p.Z), H);                               \
        return {X3, Y3, Z3};                                          \
    }                                                                 \
    inline PT PT##_jac_to_affine(const PT##Jac& p) {                  \
        if (fiszero(p.Z)) return {F{}, F{}, true};                    \
        F zi = finv(p.Z);                                             \
        F zi2 = fsqr(zi);                                             \
        return {fmul(p.X, zi2), fmul(fmul(p.Y, zi2), zi), false};     \
    }                                                                 \
    inline PT PT##_mul_be_fast(const PT& p, const uint8_t* k,         \
                               size_t klen) {                         \
        if (p.inf) return p;                                          \
        PT##Jac acc = {F{}, F{}, F{}};      /* infinity (Z = 0) */    \
        bool started = false;                                         \
        for (size_t i = 0; i < klen; i++) {                           \
            for (int b = 7; b >= 0; b--) {                            \
                if (started) acc = PT##_jac_double(acc);              \
                if ((k[i] >> b) & 1) {                                \
                    acc = PT##_jac_add_affine(acc, p);                \
                    started = true;                                   \
                }                                                     \
            }                                                         \
        }                                                             \
        return PT##_jac_to_affine(acc);                               \
    }

DEFINE_JAC_MUL(G1, Fp, fp_add, fp_sub, fp_mul, fp_sqr, fp_neg,
               fp_inv, fp_is_zero, fp_eq, fp_one)
DEFINE_JAC_MUL(G2, Fp2, f2_add, f2_sub, f2_mul, f2_sqr, f2_neg,
               f2_inv, f2_is_zero, f2_eq, f2_one)
inline bool f12_is_zero(const Fp12& a) { return f12_eq(a, f12_zero()); }
// curve equations
inline bool g1_on_curve(const G1& p) {
    if (p.inf) return true;
    Fp b4 = fp_from_u64(4);
    return fp_eq(fp_sqr(p.y),
                 fp_add(fp_mul(fp_sqr(p.x), p.x), b4));
}
inline Fp2 g2_b() {
    // 4 * (1 + u)
    Fp f4 = fp_from_u64(4);
    return {f4, f4};
}
inline bool g2_on_curve(const G2& p) {
    if (p.inf) return true;
    return f2_eq(f2_sqr(p.y),
                 f2_add(f2_mul(f2_sqr(p.x), p.x), g2_b()));
}

static const uint8_t R_BE[32] = {
    0x73,0xed,0xa7,0x53,0x29,0x9d,0x7d,0x48,0x33,0x39,0xd8,0x08,
    0x09,0xa1,0xd8,0x05,0x53,0xbd,0xa4,0x02,0xff,0xfe,0x5b,0xfe,
    0xff,0xff,0xff,0xff,0x00,0x00,0x00,0x01};

inline bool g1_in_subgroup(const G1& p) {
    if (!g1_on_curve(p)) return false;
    if (p.inf) return true;
    return G1_mul_be_fast(p, R_BE, 32).inf;
}
inline bool g2_in_subgroup(const G2& p);

// --- pairing ----------------------------------------------------------------

// |x| = 0xD201000000010000; loop over bits below the leading one
static const uint64_t ATE_LOOP = 0xD201000000010000ULL;

inline Fp2 f2_scale(const Fp2& a, const Fp& s) {
    return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}

// A Miller line as a sparse Fp12.  With the untwist (x, y) ->
// (x w^-2, y w^-3) the line through points of E'(Fq2) evaluated at
// P in G1 is  c0 + c4·w^-1 + c3·w^-3;  w^-1 = xi^-1 v^2 w and
// w^-3 = xi^-1 v w, so multiplying the whole line by xi (an Fq2
// constant, annihilated by the final exponentiation's p^6-1 easy
// part) gives the sparse element below.
// Projective Miller loop: R in homogeneous (X, Y, Z) over Fq2 —
// NO inversions anywhere (the round-2 affine-Fq12 loop paid one Fq12
// inversion per step; that was the 26 ms).  Every line is scaled by
// an Fq2 factor (2YZ^2 for tangents, D for chords), which the final
// exponentiation kills, so verdicts are unchanged.  The projective
// doubling/addition formulas are derived directly from the affine
// chord-tangent law by clearing denominators (Z3 = 8Y^3Z^3 resp.
// D^3 Z); the python golden model remains the affine reference.
inline Fp12 miller_loop(const G2& q, const G1& p) {
    if (q.inf || p.inf) return f12_one();
    Fp2 X = q.x, Y = q.y, Z = f2_one();
    Fp12 f = f12_one();
    Fp neg_yp = fp_neg(p.y);
    Fp xp3 = fp_muli(p.x, 3);
    int top = 63;
    while (!((ATE_LOOP >> top) & 1)) top--;
    for (int i = top - 1; i >= 0; i--) {
        // tangent at R, scaled by 2YZ^2:
        //   -2YZ^2·yP + 3X^2·Z·xP·w^-1 + (2Y^2·Z - 3X^3)·w^-3
        Fp2 X2 = f2_sqr(X), Y2 = f2_sqr(Y), Z2 = f2_sqr(Z);
        Fp2 Xc = f2_mul(X2, X);                       // X^3
        Fp2 YZ2 = f2_mul(Y, Z2);
        Fp2 c0 = f2_scale(f2_add(YZ2, YZ2), neg_yp);
        Fp2 c4 = f2_scale(f2_mul(X2, Z), xp3);
        Fp2 c3 = f2_sub(f2_muli(f2_mul(Y2, Z), 2), f2_muli(Xc, 3));
        f = f12_mul_sparse(f12_sqr(f), f2_mul_xi(c0), c3, c4);
        // R = 2R:  X' = 18X^4·YZ - 16X·Y^3·Z^2,
        //          Y' = 36X^3·Y^2·Z - 27X^6 - 8Y^4·Z^2,
        //          Z' = 8Y^3·Z^3
        Fp2 X4 = f2_sqr(X2);
        Fp2 Yc = f2_mul(Y2, Y);                       // Y^3
        Fp2 nX = f2_sub(f2_muli(f2_mul(f2_mul(X4, Y), Z), 18),
                        f2_muli(f2_mul(f2_mul(X, Yc), Z2), 16));
        Fp2 nY = f2_sub(
            f2_sub(f2_muli(f2_mul(f2_mul(Xc, Y2), Z), 36),
                   f2_muli(f2_sqr(Xc), 27)),
            f2_muli(f2_mul(f2_sqr(Y2), Z2), 8));
        Fp2 nZ = f2_muli(f2_mul(Yc, f2_mul(Z2, Z)), 8);
        X = nX; Y = nY; Z = nZ;
        if ((ATE_LOOP >> i) & 1) {
            // chord through R and affine Q, scaled by D = Z·xQ - X:
            //   -D·yP + N·xP·w^-1 + (D·yQ - N·xQ)·w^-3
            Fp2 N = f2_sub(f2_mul(Z, q.y), Y);
            Fp2 D = f2_sub(f2_mul(Z, q.x), X);
            Fp2 c0a = f2_scale(D, neg_yp);
            Fp2 c4a = f2_scale(N, p.x);
            Fp2 c3a = f2_sub(f2_mul(D, q.y), f2_mul(N, q.x));
            f = f12_mul_sparse(f, f2_mul_xi(c0a), c3a, c4a);
            // R = R + Q:  W = N^2·Z - D^2·(X + xQ·Z),
            //   X' = D·W,  Y' = N·(X·D^2 - W) - Y·D^3,  Z' = D^3·Z
            Fp2 D2 = f2_sqr(D), D3 = f2_mul(D2, D);
            Fp2 W = f2_sub(f2_mul(f2_sqr(N), Z),
                           f2_mul(D2, f2_add(X, f2_mul(q.x, Z))));
            Fp2 aX = f2_mul(D, W);
            Fp2 aY = f2_sub(f2_mul(N, f2_sub(f2_mul(X, D2), W)),
                            f2_mul(Y, D3));
            Fp2 aZ = f2_mul(D3, Z);
            X = aX; Y = aY; Z = aZ;
        }
    }
    return f12_conj(f);        // x < 0 adjustment
}

// (p^6 + 1) / r, big-endian (the python module's folded exponent)
static const uint8_t FINAL_E_BE[254] = {
    0x28,0xb3,0x14,0x87,0x75,0x03,0x7b,0x6f,0x23,0x5c,0x55,0xca,
    0x75,0x66,0xdb,0xf8,0x5a,0xe6,0x64,0xcf,0x5b,0xb3,0x65,0x79,
    0xae,0xa8,0x3c,0x48,0xc1,0xda,0xe0,0xec,0x90,0x31,0x17,0x9b,
    0xde,0xcc,0xad,0x73,0x75,0xa3,0x76,0x3b,0xdf,0x7c,0xcf,0x56,
    0xfb,0x15,0x73,0xbe,0xaa,0x8c,0x54,0x8c,0xe0,0x80,0x9b,0xc5,
    0xf6,0x1a,0xfb,0x46,0xe1,0x97,0xbd,0x2f,0xa4,0x89,0x9f,0x0c,
    0x50,0x12,0x6c,0x80,0x2e,0xec,0x85,0xa2,0xe7,0x07,0xf0,0x84,
    0x18,0x55,0x47,0x44,0x49,0x7f,0x8b,0x2f,0x29,0x22,0x96,0x78,
    0x78,0xfe,0xbc,0xb9,0x5d,0x1f,0x13,0x04,0x27,0x5e,0xf4,0x99,
    0xdf,0xfb,0x12,0xd6,0xa8,0x74,0xd2,0x1b,0x73,0xda,0x2b,0x82,
    0x2f,0x51,0x4a,0x9c,0x4f,0x6f,0xee,0x6a,0x95,0xdb,0x11,0xe6,
    0x3f,0x56,0x5e,0x88,0x6c,0x94,0xc4,0xf8,0x23,0x84,0xc3,0xb5,
    0xe2,0xf5,0x57,0xc0,0xb1,0x5f,0x27,0xd7,0xbd,0x90,0x93,0x50,
    0x21,0xc3,0xf0,0x07,0xc0,0x1e,0x7e,0xbe,0x3a,0xfc,0x81,0x61,
    0x01,0xdd,0xd0,0x76,0x11,0x7d,0x1d,0x61,0x5d,0x49,0xe2,0x76,
    0x4d,0x7b,0xc3,0xb5,0xef,0x4b,0x18,0x8a,0x20,0xb0,0x38,0xee,
    0x1c,0xd4,0x77,0x8e,0x0d,0xe7,0x33,0x82,0x59,0xc2,0x2a,0x12,
    0xbd,0x40,0x22,0x47,0x41,0xb3,0x6f,0xec,0x77,0x60,0x2d,0x72,
    0x71,0x56,0x38,0x90,0xf1,0x33,0x3a,0x09,0xc4,0x49,0x79,0x03,
    0xf7,0x6e,0x9c,0xf0,0xf7,0x0a,0x61,0xc7,0x91,0xe2,0x09,0xa5,
    0x25,0x6d,0xe0,0x38,0x1a,0x16,0x87,0x39,0xe1,0xcd,0xc0,0x70,
    0x5d,0x6a};

inline Fp12 final_exponentiation_naive(const Fp12& f) {
    // easy part f^(p^6-1) = conj(f) * f^-1, then the folded pow
    Fp12 g = f12_mul(f12_conj(f), f12_inv(f));
    return f12_pow_be(g, FINAL_E_BE, sizeof FINAL_E_BE);
}

// --- Frobenius + fast final exponentiation ---------------------------------

// generic Fq2 pow over a big-endian exponent
inline Fp2 f2_pow_be(const Fp2& a, const uint8_t* e, size_t elen) {
    Fp2 out = f2_one();
    bool started = false;
    for (size_t i = 0; i < elen; i++) {
        for (int b = 7; b >= 0; b--) {
            if (started) out = f2_sqr(out);
            if ((e[i] >> b) & 1) {
                if (started) out = f2_mul(out, a);
                else { out = a; started = true; }
            }
        }
    }
    return started ? out : f2_one();
}

// (p - 1) / 6, big-endian — the Frobenius gamma exponent
static const uint8_t PM16_BE[48] = {
    0x04,0x55,0x82,0xfc,0x5e,0xea,0xa6,0x6f,0x0c,0x84,0x9b,0xf3,
    0xb5,0xe1,0xf2,0x23,0xe6,0x13,0xe1,0xeb,0x7d,0xeb,0x83,0x1f,
    0xe6,0x88,0x23,0x1a,0xd3,0xc8,0x29,0x06,0x05,0x1c,0xaa,0xaa,
    0x72,0xe3,0x55,0x55,0x49,0xaa,0x7f,0xff,0xff,0xff,0xf1,0xc7};

struct FrobConsts {
    Fp2 gamma[6];      // gamma[i] = xi^(i*(p-1)/6); gamma[0] = 1
};

inline const FrobConsts& frob_consts() {
    static FrobConsts k = [] {
        FrobConsts c;
        Fp2 xi = {fp_one(), fp_one()};            // 1 + u
        c.gamma[0] = f2_one();
        c.gamma[1] = f2_pow_be(xi, PM16_BE, 48);
        for (int i = 2; i < 6; i++)
            c.gamma[i] = f2_mul(c.gamma[i - 1], c.gamma[1]);
        return c;
    }();
    return k;
}

// f^p: conjugate each Fq2 coefficient, multiply the w^i coefficient
// by gamma[i].  Coefficient i of w^i:  [b0.a0, b1.a0, b0.a1, b1.a1,
// b0.a2, b1.a2]  (w^2 = v).
inline Fp12 f12_frobenius(const Fp12& f) {
    const FrobConsts& k = frob_consts();
    auto cm = [&](const Fp2& c, int i) {
        return f2_mul(Fp2{c.c0, fp_neg(c.c1)}, k.gamma[i]);
    };
    Fp12 r;
    r.b0.a0 = cm(f.b0.a0, 0);
    r.b1.a0 = cm(f.b1.a0, 1);
    r.b0.a1 = cm(f.b0.a1, 2);
    r.b1.a1 = cm(f.b1.a1, 3);
    r.b0.a2 = cm(f.b0.a2, 4);
    r.b1.a2 = cm(f.b1.a2, 5);
    return r;
}

// --- the psi endomorphism on E'(Fq2) ---------------------------------------
// psi = twist ∘ Frobenius ∘ untwist:  (x, y) -> (x̄·γ^-2, ȳ·γ^-3),
// γ = ξ^((p-1)/6) (= frob_consts().gamma[1]).  On G2 its eigenvalue
// is z (the BLS parameter), which gives the Scott subgroup check and
// the Budroni–Pintore cofactor clearing below; both are validated
// against the plain scalar-multiplication paths by the differential
// tests (the python golden model clears with h_eff and checks the
// subgroup with [r]P).

static const uint8_t Z_ABS_BE[8] = {
    0xd2,0x01,0x00,0x00,0x00,0x01,0x00,0x00};

struct PsiConsts {
    Fp2 c2, c3;
};

inline const PsiConsts& psi_consts() {
    static const PsiConsts k = [] {
        const FrobConsts& f = frob_consts();
        PsiConsts c;
        c.c2 = f2_inv(f.gamma[2]);
        c.c3 = f2_inv(f.gamma[3]);
        return c;
    }();
    return k;
}

inline G2 g2_psi(const G2& p) {
    if (p.inf) return p;
    const PsiConsts& k = psi_consts();
    return {f2_mul(Fp2{p.x.c0, fp_neg(p.x.c1)}, k.c2),
            f2_mul(Fp2{p.y.c0, fp_neg(p.y.c1)}, k.c3), false};
}

inline G2 g2_neg_pt(const G2& p) {
    return {p.x, f2_neg(p.y), p.inf};
}

// [z]P with z < 0: negate the |z| multiple
inline G2 g2_mul_z(const G2& p) {
    return g2_neg_pt(G2_mul_be_fast(p, Z_ABS_BE, sizeof Z_ABS_BE));
}

// Budroni–Pintore efficient cofactor clearing for BLS12 G2:
//   [z^2 - z - 1]P + [z - 1]ψ(P) + ψ^2(2P)   ( = [h_eff]P )
inline G2 g2_clear_cofactor(const G2& p) {
    if (p.inf) return p;
    G2 zp = g2_mul_z(p);                       // [z]P
    G2 z2p = g2_mul_z(zp);                     // [z^2]P
    G2 acc = G2_add(z2p, g2_neg_pt(zp));       // [z^2 - z]P
    acc = G2_add(acc, g2_neg_pt(p));           // [z^2 - z - 1]P
    G2 pp = g2_psi(p);
    G2 zpp = g2_mul_z(pp);                     // [z]ψ(P)
    acc = G2_add(acc, G2_add(zpp, g2_neg_pt(pp)));
    return G2_add(acc, g2_psi(g2_psi(G2_double(p))));
}

// Scott fast subgroup membership: P in G2 iff ψ(P) = [z]P (the ψ
// eigenvalue on G2 is z) — a 64-bit ladder instead of the 255-bit
// [r]P == O check
inline bool g2_in_subgroup(const G2& p) {
    if (!g2_on_curve(p)) return false;
    if (p.inf) return true;
    G2 zp = g2_mul_z(p);
    G2 ps = g2_psi(p);
    if (ps.inf || zp.inf) return ps.inf == zp.inf;
    return f2_eq(ps.x, zp.x) && f2_eq(ps.y, zp.y);
}

// Granger–Scott cyclotomic squaring — valid ONLY for unitary
// elements (the final exponentiation's post-easy-part values): 9 Fq2
// squarings instead of f12_sqr's 12 Fq2 muls.  The component mapping
// was derived numerically against the python golden model
// (cyc_sqr(g) == g^2 for g = f^((p^6-1)(p^2+1))) and is re-asserted
// by the runtime selftest.
inline Fp12 f12_sqr_cyc(const Fp12& x) {
    Fp2 t0 = f2_sqr(x.b1.a1), t1 = f2_sqr(x.b0.a0);
    Fp2 t6 = f2_sub(f2_sub(f2_sqr(f2_add(x.b1.a1, x.b0.a0)), t0),
                    t1);
    Fp2 t2 = f2_sqr(x.b0.a2), t3 = f2_sqr(x.b1.a0);
    Fp2 t7 = f2_sub(f2_sub(f2_sqr(f2_add(x.b0.a2, x.b1.a0)), t2),
                    t3);
    Fp2 t4 = f2_sqr(x.b1.a2), t5 = f2_sqr(x.b0.a1);
    Fp2 t8 = f2_mul_xi(f2_sub(
        f2_sub(f2_sqr(f2_add(x.b1.a2, x.b0.a1)), t4), t5));
    t0 = f2_add(f2_mul_xi(t0), t1);
    t2 = f2_add(f2_mul_xi(t2), t3);
    t4 = f2_add(f2_mul_xi(t4), t5);
    Fp12 z;
    z.b0.a0 = f2_sub(f2_muli(t0, 3), f2_muli(x.b0.a0, 2));
    z.b0.a1 = f2_sub(f2_muli(t2, 3), f2_muli(x.b0.a1, 2));
    z.b0.a2 = f2_sub(f2_muli(t4, 3), f2_muli(x.b0.a2, 2));
    z.b1.a0 = f2_add(f2_muli(t8, 3), f2_muli(x.b1.a0, 2));
    z.b1.a1 = f2_add(f2_muli(t6, 3), f2_muli(x.b1.a1, 2));
    z.b1.a2 = f2_add(f2_muli(t7, 3), f2_muli(x.b1.a2, 2));
    return z;
}

// m^u with u = |x| = 0xD201000000010000; m must be unitary (only the
// final exponentiation's hard part calls this)
inline Fp12 f12_pow_u(const Fp12& m) {
    Fp12 out = m;                     // leading bit
    for (int i = 62; i >= 0; i--) {
        out = f12_sqr_cyc(out);
        if ((ATE_LOOP >> i) & 1) out = f12_mul(out, m);
    }
    return out;
}

inline Fp12 final_exponentiation(const Fp12& f) {
    // easy part: g = f^((p^6-1)(p^2+1)) — in the cyclotomic subgroup,
    // where inverse == conjugate
    Fp12 g = f12_mul(f12_conj(f), f12_inv(f));          // ^(p^6-1)
    g = f12_mul(f12_frobenius(f12_frobenius(g)), g);    // ^(p^2+1)
    // hard part cubed (Hayashida-style decomposition; exact identity
    // verified offline:  3*((p^4-p^2+1)/r) =
    //   (x-1)^2 (x+p) (x^2+p^2-1) + 3,  x = -u):
    // the result is naive^3, and since gcd(3, r) = 1 the ==1 verdict
    // is unchanged (the module's only consumer).
    Fp12 t1 = f12_conj(f12_mul(f12_pow_u(g), g));       // g^(x-1)
    Fp12 t2 = f12_conj(f12_mul(f12_pow_u(t1), t1));     // ^(x-1)
    Fp12 t3 = f12_mul(f12_conj(f12_pow_u(t2)),          // ^(x+p)
                      f12_frobenius(t2));
    Fp12 t4 = f12_mul(
        f12_mul(f12_pow_u(f12_pow_u(t3)),               // ^(x^2)
                f12_frobenius(f12_frobenius(t3))),      // ^(p^2)
        f12_conj(t3));                                  // ^(-1)
    Fp12 g3 = f12_mul(f12_sqr(g), g);
    return f12_mul(t4, g3);
}

// startup self-check: Frobenius vs a plain ^p pow, and the fast final
// exponentiation (naive^3) vs the naive one, on a derived element —
// any algebra slip fails loudly before a verdict is ever produced
inline bool selftest() {
    // the ADX multiplier must agree with the generic CIOS on a
    // pseudo-random walk (covers carry/edge behavior cheaply; any
    // miscompiled or mis-scheduled asm fails before first use)
    {
        uint64_t s = 0x243f6a8885a308d3ULL;
        Fp x = fp_one(), y;
        for (int i = 0; i < 6; i++) {
            s = s * 6364136223846793005ULL + 1442695040888963407ULL;
            y.v[i] = s;
        }
        y.v[5] &= 0x0fffffffffffffffULL;
        for (int i = 0; i < 64; i++) {
            Fp fast = fp_mul(x, y);
            if (!fp_eq(fast, fp_mul_generic(x, y))) return false;
            x = fast;
            y = fp_add(y, fp_one());
        }
        Fp pm1;
        std::memcpy(pm1.v, P_LIMBS, sizeof pm1.v);
        pm1.v[0] -= 1;        // p-1 in raw form exercises top carries
        if (!fp_eq(fp_mul(pm1, pm1), fp_mul_generic(pm1, pm1)))
            return false;
    }
    // a "random" fp12 from small constants
    Fp12 f = f12_zero();
    uint64_t seed = 0x9e3779b97f4a7c15ULL;
    Fp2* coeffs[6] = {&f.b0.a0, &f.b1.a0, &f.b0.a1,
                      &f.b1.a1, &f.b0.a2, &f.b1.a2};
    for (int i = 0; i < 6; i++) {
        seed = seed * 6364136223846793005ULL + 1442695040888963407ULL;
        coeffs[i]->c0 = fp_from_u64(seed >> 8);
        seed = seed * 6364136223846793005ULL + 1442695040888963407ULL;
        coeffs[i]->c1 = fp_from_u64(seed >> 8);
    }
    // P big-endian = PM2 + 2
    uint8_t p_be[48];
    std::memcpy(p_be, PM2_BE, 48);
    p_be[47] = uint8_t(p_be[47] + 2);
    if (!f12_eq(f12_frobenius(f), f12_pow_be(f, p_be, 48)))
        return false;
    // cyclotomic squaring must agree with the generic squaring on a
    // unitary element (the easy-part image of f)
    Fp12 g = f12_mul(f12_conj(f), f12_inv(f));
    g = f12_mul(f12_frobenius(f12_frobenius(g)), g);
    if (!f12_eq(f12_sqr_cyc(g), f12_sqr(g))) return false;
    Fp12 naive = final_exponentiation_naive(f);
    Fp12 naive3 = f12_mul(f12_sqr(naive), naive);
    return f12_eq(final_exponentiation(f), naive3);
}

inline bool selftest_psi();   // defined after the hash-to-G2 block

struct Pair {
    G1 p;
    G2 q;
};

inline bool pairings_product_is_one(const std::vector<Pair>& pairs) {
    Fp12 f = f12_one();
    for (const Pair& pr : pairs) {
        if (pr.p.inf || pr.q.inf) continue;
        f = f12_mul(f, miller_loop(pr.q, pr.p));
    }
    return f12_eq(final_exponentiation(f), f12_one());
}

// --- hash to G2 (mirrors the python module's custom map) --------------------

inline void sha256_digest(const uint8_t* d, size_t n, uint8_t out[32]) {
    sha256::hash(d, n, out);
}

inline void expand_message_xmd(const uint8_t* msg, size_t msg_len,
                               const uint8_t* dst, size_t dst_len,
                               size_t out_len, uint8_t* out) {
    // RFC 9380 §5.3.1 with SHA-256 (lengths validated by the caller)
    size_t ell = (out_len + 31) / 32;
    std::vector<uint8_t> buf;
    buf.assign(64, 0);                         // z_pad
    buf.insert(buf.end(), msg, msg + msg_len);
    buf.push_back(uint8_t(out_len >> 8));
    buf.push_back(uint8_t(out_len));
    buf.push_back(0);
    buf.insert(buf.end(), dst, dst + dst_len);
    buf.push_back(uint8_t(dst_len));
    uint8_t b0[32];
    sha256_digest(buf.data(), buf.size(), b0);

    std::vector<uint8_t> round;
    round.assign(b0, b0 + 32);
    round.push_back(1);
    round.insert(round.end(), dst, dst + dst_len);
    round.push_back(uint8_t(dst_len));
    uint8_t prev[32];
    sha256_digest(round.data(), round.size(), prev);
    size_t written = 0;
    for (size_t i = 1; i <= ell && written < out_len; i++) {
        size_t take = out_len - written < 32 ? out_len - written : 32;
        std::memcpy(out + written, prev, take);
        written += take;
        if (i == ell) break;
        round.clear();
        for (int j = 0; j < 32; j++)
            round.push_back(b0[j] ^ prev[j]);
        round.push_back(uint8_t(i + 1));
        round.insert(round.end(), dst, dst + dst_len);
        round.push_back(uint8_t(dst_len));
        sha256_digest(round.data(), round.size(), prev);
    }
}

// 64-byte big-endian -> Fp (mod p), for hash_to_field
inline Fp fp_from_be64_mod(const uint8_t* b) {
    // incremental: r = r*256 + byte (in standard form via Montgomery)
    Fp r = fp_zero();
    Fp c256 = fp_from_u64(256);
    for (int i = 0; i < 64; i++) {
        r = fp_add(fp_mul(r, c256), fp_from_u64(b[i]));
    }
    return r;
}

inline int sgn0_fq2(const Fp2& a) {
    bool s0 = fp_is_odd(a.c0);
    bool z0 = fp_is_zero(a.c0);
    return s0 || (z0 && fp_is_odd(a.c1));
}

// h_eff = h2 * (3z^2 - 3) (RFC 9380 §8.8.2 cofactor clearing; the
// closed form is asserted against the curve's z parameter in the
// python golden model's tests)
static const uint8_t H_EFF_BE[80] = {
    0x0b,0xc6,0x9f,0x08,0xf2,0xee,0x75,0xb3,0x58,0x4c,0x6a,0x0e,
    0xa9,0x1b,0x35,0x28,0x88,0xe2,0xa8,0xe9,0x14,0x5a,0xd7,0x68,
    0x99,0x86,0xff,0x03,0x15,0x08,0xff,0xe1,0x32,0x9c,0x2f,0x17,
    0x87,0x31,0xdb,0x95,0x6d,0x82,0xbf,0x01,0x5d,0x12,0x12,0xb0,
    0x2e,0xc0,0xec,0x69,0xd7,0x47,0x7c,0x1a,0xe9,0x54,0xcb,0xc0,
    0x66,0x89,0xf6,0xa3,0x59,0x89,0x4c,0x0a,0xde,0xbb,0xf6,0xb4,
    0xe8,0x02,0x00,0x05,0xaa,0xa9,0x55,0x51};

// RFC 9380 §6.6.2 simplified SWU onto the 3-isogenous curve
//   E': y^2 = x^3 + A'x + B',  A' = 240i, B' = 1012(1+i), Z = -(2+i)
// then the Vélu-derived 3-isogeny to E (kernel x0 = (-6, 6); see the
// python golden model _bls12381_math.py for the offline derivation
// and its re-derivation test).
struct SswuConsts {
    Fp2 A, B, Z, x0, iso_t, iso_u, inv9, inv27;
};

inline const SswuConsts& sswu_consts() {
    static const SswuConsts c = [] {
        SswuConsts s;
        s.A = {fp_zero(), fp_from_u64(240)};
        s.B = {fp_from_u64(1012), fp_from_u64(1012)};
        s.Z = f2_neg({fp_from_u64(2), fp_one()});
        s.x0 = {fp_neg(fp_from_u64(6)), fp_from_u64(6)};
        // Vélu: t = 2(3 x0^2 + A'), u = 4(x0^3 + A' x0 + B')
        Fp2 x0sq = f2_sqr(s.x0);
        s.iso_t = f2_muli(f2_add(f2_muli(x0sq, 3), s.A), 2);
        s.iso_u = f2_muli(
            f2_add(f2_mul(x0sq, s.x0),
                   f2_add(f2_mul(s.A, s.x0), s.B)), 4);
        s.inv9 = {fp_inv(fp_from_u64(9)), fp_zero()};
        s.inv27 = {fp_inv(fp_from_u64(27)), fp_zero()};
        return s;
    }();
    return c;
}

inline G2 map_to_curve_g2(const Fp2& u) {
    const SswuConsts& cs = sswu_consts();
    Fp2 u2 = f2_sqr(u);
    Fp2 zu2 = f2_mul(cs.Z, u2);
    Fp2 tv1 = f2_add(f2_sqr(zu2), zu2);       // Z^2 u^4 + Z u^2
    Fp2 x1;
    if (f2_is_zero(tv1)) {
        x1 = f2_mul(cs.B, f2_inv(f2_mul(cs.Z, cs.A)));
    } else {
        x1 = f2_mul(f2_mul(f2_neg(cs.B), f2_inv(cs.A)),
                    f2_add(f2_one(), f2_inv(tv1)));
    }
    Fp2 gx1 = f2_add(f2_mul(f2_sqr(x1), x1),
                     f2_add(f2_mul(cs.A, x1), cs.B));
    Fp2 x = x1, y;
    if (!f2_sqrt(gx1, &y)) {
        x = f2_mul(zu2, x1);
        Fp2 gx2 = f2_add(f2_mul(f2_sqr(x), x),
                         f2_add(f2_mul(cs.A, x), cs.B));
        if (!f2_sqrt(gx2, &y))
            return {f2_zero(), f2_zero(), true};  // unreachable
    }
    if (sgn0_fq2(y) != sgn0_fq2(u)) y = f2_neg(y);
    // 3-isogeny: x_E = (x + t/d + u/d^2)/9,
    //            y_E = y (1 - t/d^2 - 2u/d^3)/27,  d = x - x0
    Fp2 d = f2_sub(x, cs.x0);
    if (f2_is_zero(d))
        return {f2_zero(), f2_zero(), true};      // kernel -> infinity
    Fp2 d2 = f2_sqr(d);
    Fp2 inv_d3 = f2_inv(f2_mul(d2, d));
    Fp2 inv_d2 = f2_mul(inv_d3, d);
    Fp2 inv_d = f2_mul(inv_d2, d);
    Fp2 xn = f2_add(x, f2_add(f2_mul(cs.iso_t, inv_d),
                              f2_mul(cs.iso_u, inv_d2)));
    Fp2 yn = f2_mul(y, f2_sub(
        f2_one(), f2_add(f2_mul(cs.iso_t, inv_d2),
                         f2_mul(f2_muli(cs.iso_u, 2), inv_d3))));
    // z = -3 isomorphism branch (y -> -y/27): RFC 9380's iso_map sign
    // convention, pinned by the J.10.1 vectors in the python golden
    // model's tests (the +3 branch yields -P for every message).
    return {f2_mul(xn, cs.inv9), f2_neg(f2_mul(yn, cs.inv27)), false};
}

inline G2 hash_to_g2(const uint8_t* msg, size_t msg_len,
                     const uint8_t* dst, size_t dst_len) {
    uint8_t data[256];
    expand_message_xmd(msg, msg_len, dst, dst_len, 256, data);
    Fp2 u0 = {fp_from_be64_mod(data), fp_from_be64_mod(data + 64)};
    Fp2 u1 = {fp_from_be64_mod(data + 128),
              fp_from_be64_mod(data + 192)};
    G2 q = G2_add(map_to_curve_g2(u0), map_to_curve_g2(u1));
    return g2_clear_cofactor(q);
}

// ψ machinery self-check: Budroni–Pintore cofactor clearing must
// equal the plain [h_eff]P on a non-subgroup curve point (an
// endomorphism identity — any slip in γ/ψ or the formula fails
// here), and the Scott subgroup check must agree with [r]P == O on
// --- ZCash-flag compressed-point parsing ------------------------------------
// (python golden model: _bls12381_math.py g1_uncompress/g2_uncompress;
// reference behavior: blst's Uncompress behind key_bls12381.go)

inline bool fp_y_larger(const Fp& y) {
    // y > (p-1)/2  ⟺  y > p - y in standard form (y = 0 -> false)
    uint8_t a[48], b[48];
    fp_to_be48(y, a);
    fp_to_be48(fp_neg(y), b);
    return std::memcmp(a, b, 48) > 0;
}

inline bool f2_y_larger(const Fp2& y) {
    if (!fp_is_zero(y.c1)) return fp_y_larger(y.c1);
    return fp_y_larger(y.c0);
}

// compressed 48B -> G1; 0 = point, 1 = infinity, -1 = invalid
inline int g1_uncompress(const uint8_t* in, G1* out) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return -1;
    if (flags & 0x40) {
        if (flags & 0x3f) return -1;
        for (int i = 1; i < 48; i++)
            if (in[i]) return -1;
        return 1;
    }
    uint8_t xbe[48];
    std::memcpy(xbe, in, 48);
    xbe[0] &= 0x1f;
    Fp x;
    if (!fp_from_be48(xbe, &x)) return -1;
    Fp gx = fp_add(fp_mul(fp_sqr(x), x), fp_from_u64(4));
    Fp y;
    if (!fp_sqrt(gx, &y)) return -1;
    if (fp_y_larger(y) != bool(flags & 0x20)) y = fp_neg(y);
    out->x = x;
    out->y = y;
    out->inf = false;
    return 0;
}

// compressed 96B -> G2; 0 = point, 1 = infinity, -1 = invalid
inline int g2_uncompress(const uint8_t* in, G2* out) {
    uint8_t flags = in[0];
    if (!(flags & 0x80)) return -1;
    if (flags & 0x40) {
        if (flags & 0x3f) return -1;
        for (int i = 1; i < 96; i++)
            if (in[i]) return -1;
        return 1;
    }
    uint8_t x1be[48];
    std::memcpy(x1be, in, 48);
    x1be[0] &= 0x1f;
    Fp2 x;
    if (!fp_from_be48(x1be, &x.c1)) return -1;
    if (!fp_from_be48(in + 48, &x.c0)) return -1;
    Fp f4 = fp_from_u64(4);
    Fp2 b2 = {f4, f4};                      // 4(1+i)
    Fp2 gx = f2_add(f2_mul(f2_sqr(x), x), b2);
    Fp2 y;
    if (!f2_sqrt(gx, &y)) return -1;
    if (f2_y_larger(y) != bool(flags & 0x20)) y = f2_neg(y);
    out->x = x;
    out->y = y;
    out->inf = false;
    return 0;
}

// both a G2 point and a non-subgroup point.
inline bool selftest_psi() {
    Fp2 u = {fp_from_u64(0x1234567), fp_from_u64(0x89abcd)};
    G2 h = map_to_curve_g2(u);
    G2 want = G2_mul_be_fast(h, H_EFF_BE, sizeof H_EFF_BE);
    G2 got = g2_clear_cofactor(h);
    if (want.inf != got.inf) return false;
    if (!want.inf &&
        (!f2_eq(want.x, got.x) || !f2_eq(want.y, got.y)))
        return false;
    if (!g2_in_subgroup(got)) return false;
    if (!G2_mul_be_fast(got, R_BE, 32).inf) return false;
    if (g2_in_subgroup(h) != G2_mul_be_fast(h, R_BE, 32).inf)
        return false;
    return true;
}

// --- many-point affine sum (aggregate-commit assembly/verify) ---------------
// Pairwise tree reduction with Montgomery-batched inversions: each
// round halves the point count, sharing ONE field inversion across
// every pairwise addition (~6 field muls per add vs ~16 for the
// Jacobian ladder).  This is the O(n) residue of aggregate-commit
// verification — the G1 pubkey sum — so constant factors matter.
// Field-overloaded helpers let one template serve G1 (Fp) and G2
// (Fp2).

inline Fp fld_add(const Fp& a, const Fp& b) { return fp_add(a, b); }
inline Fp fld_sub(const Fp& a, const Fp& b) { return fp_sub(a, b); }
inline Fp fld_mul(const Fp& a, const Fp& b) { return fp_mul(a, b); }
inline Fp fld_sqr(const Fp& a) { return fp_sqr(a); }
inline Fp fld_inv(const Fp& a) { return fp_inv(a); }
inline Fp fld_muli(const Fp& a, int k) { return fp_muli(a, k); }
inline bool fld_is_zero(const Fp& a) { return fp_is_zero(a); }
inline bool fld_eq(const Fp& a, const Fp& b) { return fp_eq(a, b); }
inline Fp2 fld_add(const Fp2& a, const Fp2& b) { return f2_add(a, b); }
inline Fp2 fld_sub(const Fp2& a, const Fp2& b) { return f2_sub(a, b); }
inline Fp2 fld_mul(const Fp2& a, const Fp2& b) { return f2_mul(a, b); }
inline Fp2 fld_sqr(const Fp2& a) { return f2_sqr(a); }
inline Fp2 fld_inv(const Fp2& a) { return f2_inv(a); }
inline Fp2 fld_muli(const Fp2& a, int k) { return f2_muli(a, k); }
inline bool fld_is_zero(const Fp2& a) { return f2_is_zero(a); }
inline bool fld_eq(const Fp2& a, const Fp2& b) { return f2_eq(a, b); }
inline void fld_set_one(Fp* out) { *out = fp_one(); }
inline void fld_set_one(Fp2* out) { *out = f2_one(); }

// one batched-inversion round: pts[0..n) -> pts[0..ceil(n/2)).
// Pairs with x1 == x2 take the doubling (denominator 2y) or cancel
// to infinity; infinities are compacted out between rounds.
template <typename PT, typename F>
inline size_t sum_affine_round(PT* pts, size_t n, F* den, F* pre) {
    size_t pairs = n / 2;
    // denominators: x2 - x1, or 2y for the doubling case; zero
    // denominators (cancellation) are replaced by 1 and the pair is
    // resolved without the inverse.
    for (size_t i = 0; i < pairs; i++) {
        const PT& a = pts[2 * i];
        const PT& b = pts[2 * i + 1];
        if (fld_eq(a.x, b.x)) {
            den[i] = fld_muli(a.y, 2);       // doubling: 2y
        } else {
            den[i] = fld_sub(b.x, a.x);      // chord: x2 - x1
        }
        // cancelling pairs (y2 = -y1, incl. the y = 0 order-2 case on
        // adversarial off-curve input) resolve to infinity without an
        // inverse; a 1 keeps the batched product invertible
        if (fld_is_zero(den[i])) fld_set_one(&den[i]);
    }
    // Montgomery batch inversion over den[0..pairs)
    if (pairs) {
        pre[0] = den[0];
        for (size_t i = 1; i < pairs; i++)
            pre[i] = fld_mul(pre[i - 1], den[i]);
        F inv_all = fld_inv(pre[pairs - 1]);
        for (size_t i = pairs; i-- > 1;) {
            F inv_i = fld_mul(inv_all, pre[i - 1]);
            inv_all = fld_mul(inv_all, den[i]);
            den[i] = inv_i;
        }
        den[0] = inv_all;
    }
    size_t out = 0;
    for (size_t i = 0; i < pairs; i++) {
        const PT& a = pts[2 * i];
        const PT& b = pts[2 * i + 1];
        F m;
        if (fld_eq(a.x, b.x)) {
            if (!fld_eq(a.y, b.y) || fld_is_zero(a.y))
                continue;                    // a + (-a) = infinity
            m = fld_mul(fld_muli(fld_sqr(a.x), 3), den[i]);  // 3x^2/2y
        } else {
            m = fld_mul(fld_sub(b.y, a.y), den[i]);
        }
        PT r;
        r.x = fld_sub(fld_sub(fld_sqr(m), a.x), b.x);
        r.y = fld_sub(fld_mul(m, fld_sub(a.x, r.x)), a.y);
        r.inf = false;
        pts[out++] = r;
    }
    if (n & 1) pts[out++] = pts[n - 1];      // odd leftover rides along
    return out;
}

template <typename PT, typename F>
inline PT sum_affine(PT* pts, size_t n, F* scratch_a, F* scratch_b) {
    while (n > 1)
        n = sum_affine_round<PT, F>(pts, n, scratch_a, scratch_b);
    if (n == 0) { PT r{}; r.inf = true; return r; }
    return pts[0];
}

}  // namespace bls
