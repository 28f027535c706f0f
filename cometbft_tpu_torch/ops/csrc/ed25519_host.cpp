// ed25519 on the host CPU, one signature at a time: the RFC 8032 sign
// and the ZIP-215 cofactored single verification.
//
// Counterpart of the JAX package's OpenSSL path (cometbft_tpu/crypto/
// ed25519.py:8-37), with a plain C interface and no Python object
// anywhere: ops/_build.py compiles this file with g++ into a host
// library of its own, and ops/ed25519_host.py calls it through ctypes,
// which drops the GIL for the call.  The pure-Python golden model
// (crypto/_ed25519_ref.py) is its plain version.
//
//   sign:    h = SHA-512(seed); a = clamp(h[0:32]); r = SHA-512(h[32:64]
//            || msg) mod L; R = r·B; k = SHA-512(R || A || msg) mod L;
//            S = r + k·a mod L
//   verify:  S < L (canonical S), A and R decoded permissively (y >= p
//            accepted, x = 0 with sign 1 accepted), then
//            [8](S·B - R - k·A) == identity
//
// The field (5 x 51-bit limbs), the extended-coordinate point formulas,
// the permissive decompression, the cofactored identity test and the
// scalar helpers are copies of the JAX package's native MSM code
// (native/ed25519_msm.hpp:48-415); SHA-512 and its 512-bit reduction mod
// L are the host prep's copies (sha512.hpp).  k·B runs on a table of
// d·16^w·B (64 windows x 16 digits, built once a process), k·A on a
// 4-bit fixed window.  ed25519_host_selftest checks RFC 8032's vectors
// and ZIP-215's edge cases; the loader refuses a library that fails it.

#include <cstdint>
#include <cstring>

#include "sha512.hpp"

namespace {

typedef unsigned __int128 u128;

// ---------------------------------------------------------------- fe

struct fe {
    uint64_t v[5];      // radix 2^51
};

const uint64_t MASK51 = (uint64_t(1) << 51) - 1;

inline fe fe_zero() { return fe{{0, 0, 0, 0, 0}}; }
inline fe fe_one() { return fe{{1, 0, 0, 0, 0}}; }

inline fe fe_add(const fe& a, const fe& b) {
    fe r;
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
    return r;
}

// a - b + 8p, nonnegative for any b with limbs < 2^54 - 152
inline fe fe_sub(const fe& a, const fe& b) {
    fe r;
    r.v[0] = a.v[0] + 0x3FFFFFFFFFFF68ull - b.v[0];
    r.v[1] = a.v[1] + 0x3FFFFFFFFFFFF8ull - b.v[1];
    r.v[2] = a.v[2] + 0x3FFFFFFFFFFFF8ull - b.v[2];
    r.v[3] = a.v[3] + 0x3FFFFFFFFFFFF8ull - b.v[3];
    r.v[4] = a.v[4] + 0x3FFFFFFFFFFFF8ull - b.v[4];
    return r;
}

// one carry sweep: limbs -> < 2^52 (top folds at 19)
inline void fe_carry(fe& a) {
    uint64_t c;
    for (int i = 0; i < 4; i++) {
        c = a.v[i] >> 51;
        a.v[i] &= MASK51;
        a.v[i + 1] += c;
    }
    c = a.v[4] >> 51;
    a.v[4] &= MASK51;
    a.v[0] += c * 19;
}

inline fe fe_mul(const fe& a, const fe& b) {
    u128 t0, t1, t2, t3, t4;
    uint64_t a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3],
             a4 = a.v[4];
    uint64_t b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3],
             b4 = b.v[4];
    uint64_t b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19,
             b4_19 = b4 * 19;
    t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 +
         (u128)a3 * b2_19 + (u128)a4 * b1_19;
    t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 +
         (u128)a3 * b3_19 + (u128)a4 * b2_19;
    t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
         (u128)a3 * b4_19 + (u128)a4 * b3_19;
    t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 +
         (u128)a3 * b0 + (u128)a4 * b4_19;
    t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 +
         (u128)a3 * b1 + (u128)a4 * b0;
    fe r;
    u128 c;
    r.v[0] = (uint64_t)t0 & MASK51; c = t0 >> 51;
    t1 += c;
    r.v[1] = (uint64_t)t1 & MASK51; c = t1 >> 51;
    t2 += c;
    r.v[2] = (uint64_t)t2 & MASK51; c = t2 >> 51;
    t3 += c;
    r.v[3] = (uint64_t)t3 & MASK51; c = t3 >> 51;
    t4 += c;
    r.v[4] = (uint64_t)t4 & MASK51; c = t4 >> 51;
    u128 f = c * 19 + r.v[0];
    r.v[0] = (uint64_t)f & MASK51;
    r.v[1] += (uint64_t)(f >> 51);
    return r;
}

inline fe fe_sq(const fe& a) { return fe_mul(a, a); }

// canonical little-endian bytes (fully reduced mod p)
inline void fe_tobytes(const fe& a, uint8_t out[32]) {
    static const uint64_t P[5] = {
        MASK51 - 18, MASK51, MASK51, MASK51, MASK51};
    fe t = a;
    fe_carry(t);
    fe_carry(t);
    for (int pass = 0; pass < 2; pass++) {
        bool ge = true;
        for (int i = 4; i >= 0; i--) {
            if (t.v[i] > P[i]) { ge = true; break; }
            if (t.v[i] < P[i]) { ge = false; break; }
        }
        if (!ge) break;
        uint64_t borrow = 0;
        for (int i = 0; i < 5; i++) {
            uint64_t sub = P[i] + borrow;
            if (t.v[i] >= sub) {
                t.v[i] -= sub;
                borrow = 0;
            } else {
                t.v[i] = t.v[i] + (uint64_t(1) << 51) - sub;
                borrow = 1;
            }
        }
    }
    uint64_t buf[4];
    buf[0] = t.v[0] | (t.v[1] << 51);
    buf[1] = (t.v[1] >> 13) | (t.v[2] << 38);
    buf[2] = (t.v[2] >> 26) | (t.v[3] << 25);
    buf[3] = (t.v[3] >> 39) | (t.v[4] << 12);
    std::memcpy(out, buf, 32);
}

// 255-bit little-endian load (bit 255 must be masked by the caller)
inline fe fe_frombytes(const uint8_t in[32]) {
    uint64_t buf[4];
    std::memcpy(buf, in, 32);
    fe r;
    r.v[0] = buf[0] & MASK51;
    r.v[1] = ((buf[0] >> 51) | (buf[1] << 13)) & MASK51;
    r.v[2] = ((buf[1] >> 38) | (buf[2] << 26)) & MASK51;
    r.v[3] = ((buf[2] >> 25) | (buf[3] << 39)) & MASK51;
    r.v[4] = (buf[3] >> 12) & MASK51;
    return r;
}

inline bool fe_is_zero(const fe& a) {
    uint8_t b[32];
    fe_tobytes(a, b);
    uint8_t acc = 0;
    for (int i = 0; i < 32; i++) acc |= b[i];
    return acc == 0;
}

inline bool fe_eq(const fe& a, const fe& b) {
    return fe_is_zero(fe_sub(a, b));
}

inline fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

inline bool fe_parity(const fe& a) {
    uint8_t b[32];
    fe_tobytes(a, b);
    return b[0] & 1;
}

inline fe fe_pow2k(fe a, int k) {
    while (k--) a = fe_sq(a);
    return a;
}

// a^((p-5)/8) = a^(2^252 - 3)
inline fe fe_pow22523(const fe& a) {
    fe x2 = fe_sq(a);
    fe x4 = fe_sq(x2);
    fe x8 = fe_sq(x4);
    fe z9 = fe_mul(a, x8);
    fe z11 = fe_mul(x2, z9);
    fe z22 = fe_sq(z11);
    fe z_5_0 = fe_mul(z9, z22);
    fe z_10_0 = fe_mul(fe_pow2k(z_5_0, 5), z_5_0);
    fe z_20_0 = fe_mul(fe_pow2k(z_10_0, 10), z_10_0);
    fe z_40_0 = fe_mul(fe_pow2k(z_20_0, 20), z_20_0);
    fe z_50_0 = fe_mul(fe_pow2k(z_40_0, 10), z_10_0);
    fe z_100_0 = fe_mul(fe_pow2k(z_50_0, 50), z_50_0);
    fe z_200_0 = fe_mul(fe_pow2k(z_100_0, 100), z_100_0);
    fe z_250_0 = fe_mul(fe_pow2k(z_200_0, 50), z_50_0);
    return fe_mul(fe_pow2k(z_250_0, 2), a);
}

// a^(p-2) = (a^(2^252-3))^8 · a^3
inline fe fe_invert(const fe& a) {
    return fe_mul(fe_pow2k(fe_pow22523(a), 3), fe_mul(fe_sq(a), a));
}

// ---------------------------------------------------------------- ge

struct ge {              // extended twisted Edwards (a = -1)
    fe X, Y, Z, T;
};

const uint8_t D_BYTES[32] = {
    0xa3, 0x78, 0x59, 0x13, 0xca, 0x4d, 0xeb, 0x75,
    0xab, 0xd8, 0x41, 0x41, 0x4d, 0x0a, 0x70, 0x00,
    0x98, 0xe8, 0x79, 0x77, 0x79, 0x40, 0xc7, 0x8c,
    0x73, 0xfe, 0x6f, 0x2b, 0xee, 0x6c, 0x03, 0x52};
const uint8_t SQRTM1_BYTES[32] = {
    0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4,
    0x78, 0xe4, 0x2f, 0xad, 0x06, 0x18, 0x43, 0x2f,
    0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00, 0x4d, 0x2b,
    0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b};
// compressed basepoint: y = 4/5, sign 0
const uint8_t B_BYTES[32] = {
    0x58, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66,
    0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66, 0x66};

inline ge ge_identity() {
    return ge{fe_zero(), fe_one(), fe_one(), fe_zero()};
}

inline const fe& fe_d2() {
    static const fe d2 = fe_add(fe_frombytes(D_BYTES),
                                fe_frombytes(D_BYTES));
    return d2;
}

// unified extended addition (complete for a = -1, d non-square)
inline ge ge_add(const ge& p, const ge& q) {
    const fe& d2 = fe_d2();
    fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    fe c = fe_mul(fe_mul(p.T, q.T), d2);
    fe dd = fe_add(fe_mul(p.Z, q.Z), fe_mul(p.Z, q.Z));
    fe e = fe_sub(b, a);
    fe f = fe_sub(dd, c);
    fe g = fe_add(dd, c);
    fe h = fe_add(b, a);
    return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

inline ge ge_double(const ge& p) {
    fe a = fe_sq(p.X);
    fe b = fe_sq(p.Y);
    fe zz = fe_sq(p.Z);
    fe c = fe_add(zz, zz);
    fe e = fe_sub(fe_sub(fe_sq(fe_add(p.X, p.Y)), a), b);
    fe g = fe_sub(b, a);
    fe f = fe_sub(g, c);
    fe h = fe_neg(fe_add(a, b));
    return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

inline ge ge_neg(const ge& p) {
    return ge{fe_neg(p.X), p.Y, p.Z, fe_neg(p.T)};
}

// ZIP-215 permissive decompression: accepts y >= p and x = 0 with
// sign = 1; rejects only encodings with no curve point.
inline bool ge_decompress(const uint8_t s[32], ge* out) {
    uint8_t yb[32];
    std::memcpy(yb, s, 32);
    int sign = yb[31] >> 7;
    yb[31] &= 0x7F;
    fe y = fe_frombytes(yb);
    fe yy = fe_sq(y);
    fe u = fe_sub(yy, fe_one());
    fe v = fe_add(fe_mul(yy, fe_frombytes(D_BYTES)), fe_one());
    fe v3 = fe_mul(fe_sq(v), v);
    fe v7 = fe_mul(fe_sq(v3), v);
    fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
    fe vxx = fe_mul(v, fe_sq(x));
    fe un = u;
    fe_carry(un);
    if (!fe_eq(vxx, un)) {
        if (fe_is_zero(fe_add(vxx, un))) {
            x = fe_mul(x, fe_frombytes(SQRTM1_BYTES));
        } else {
            return false;
        }
    }
    if ((int)fe_parity(x) != sign) x = fe_neg(x);
    out->X = x;
    out->Y = y;
    out->Z = fe_one();
    out->T = fe_mul(x, y);
    return true;
}

// the canonical 32-byte encoding: y with the parity of x in bit 255
inline void ge_compress(const ge& p, uint8_t out[32]) {
    fe zi = fe_invert(p.Z);
    fe x = fe_mul(p.X, zi);
    fe y = fe_mul(p.Y, zi);
    fe_tobytes(y, out);
    out[31] |= (uint8_t)(fe_parity(x) << 7);
}

// [8]p == identity?  (three doublings, then X == 0 && Y == Z)
inline bool ge_is_identity_cofactored(ge p) {
    p = ge_double(ge_double(ge_double(p)));
    return fe_is_zero(p.X) && fe_eq(p.Y, p.Z);
}

// d·16^w·B for w < 64, d < 16 (entry 0 of each row is the identity)
struct BaseTable {
    ge t[64][16];
    BaseTable() {
        ge b;
        ge_decompress(B_BYTES, &b);
        for (int w = 0; w < 64; w++) {
            t[w][0] = ge_identity();
            for (int d = 1; d < 16; d++) t[w][d] = ge_add(t[w][d - 1], b);
            b = ge_add(t[w][15], b);       // 16^(w+1)·B
        }
    }
};

const BaseTable& base_table() {
    static const BaseTable table;          // thread-safe one-time init
    return table;
}

// k·B for a 256-bit little-endian k: one addition a nonzero 4-bit digit
inline ge ge_scalarmult_base(const uint8_t k[32]) {
    const BaseTable& tb = base_table();
    ge acc = ge_identity();
    for (int i = 0; i < 32; i++) {
        int lo = k[i] & 0x0F, hi = k[i] >> 4;
        if (lo) acc = ge_add(acc, tb.t[2 * i][lo]);
        if (hi) acc = ge_add(acc, tb.t[2 * i + 1][hi]);
    }
    return acc;
}

// k·P for a 256-bit little-endian k: 4-bit fixed window, top down
inline ge ge_scalarmult(const ge& p, const uint8_t k[32]) {
    ge mult[16];
    mult[0] = ge_identity();
    for (int d = 1; d < 16; d++) mult[d] = ge_add(mult[d - 1], p);
    ge acc = ge_identity();
    for (int w = 63; w >= 0; w--) {
        if (w != 63)
            for (int j = 0; j < 4; j++) acc = ge_double(acc);
        int digit = (k[w >> 1] >> (4 * (w & 1))) & 0x0F;
        if (digit) acc = ge_add(acc, mult[digit]);
    }
    return acc;
}

// ------------------------------------------------------------ scalars

// L little-endian
const uint8_t L_BYTES[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58,
    0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};

// (a · b) mod L for 256-bit a, b: the 512-bit product through the
// SHA-512 digest reducer
inline void sc_mul(const uint8_t a[32], const uint8_t b[32],
                   uint8_t out[32]) {
    uint64_t al[4], bl[4];
    std::memcpy(al, a, 32);
    std::memcpy(bl, b, 32);
    uint64_t prod[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)al[i] * bl[j] + prod[i + j] + carry;
            prod[i + j] = (uint64_t)t;
            carry = t >> 64;
        }
        prod[i + 4] = (uint64_t)carry;
    }
    uint8_t wide[64];
    std::memcpy(wide, prod, 64);
    sha512::reduce_mod_l(wide, out);
}

// (a + b) mod L  (a, b < L)
inline void sc_add(const uint8_t a[32], const uint8_t b[32],
                   uint8_t out[32]) {
    uint64_t al[4], bl[4], ll[4], r[4];
    std::memcpy(al, a, 32);
    std::memcpy(bl, b, 32);
    std::memcpy(ll, L_BYTES, 32);
    unsigned char carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)al[i] + bl[i] + carry;
        r[i] = (uint64_t)t;
        carry = (unsigned char)(t >> 64);
    }
    bool ge = carry != 0;
    if (!ge) {
        ge = true;
        for (int i = 3; i >= 0; i--) {
            if (r[i] > ll[i]) { ge = true; break; }
            if (r[i] < ll[i]) { ge = false; break; }
        }
    }
    if (ge) {
        unsigned char borrow = 0;
        for (int i = 0; i < 4; i++) {
            u128 t = (u128)r[i] - ll[i] - borrow;
            r[i] = (uint64_t)t;
            borrow = (unsigned char)((t >> 64) & 1);
        }
    }
    std::memcpy(out, r, 32);
}

// s < L (canonical S, the ZIP-215 requirement)
inline bool sc_is_canonical(const uint8_t s[32]) {
    for (int i = 31; i >= 0; i--) {
        if (s[i] < L_BYTES[i]) return true;
        if (s[i] > L_BYTES[i]) return false;
    }
    return false;   // s == L
}

// SHA-512(a || b || c) mod L
inline void hash_mod_l(const uint8_t* a, size_t na, const uint8_t* b,
                       size_t nb, const uint8_t* c, size_t nc,
                       uint8_t out[32]) {
    sha512::Ctx ctx;
    sha512::init(&ctx);
    sha512::update(&ctx, a, na);
    sha512::update(&ctx, b, nb);
    sha512::update(&ctx, c, nc);
    uint8_t digest[64];
    sha512::final(&ctx, digest);
    sha512::reduce_mod_l(digest, out);
}

// the clamped secret scalar a and the nonce prefix of a 32-byte seed
inline void expand_seed(const uint8_t seed[32], uint8_t a[32],
                        uint8_t prefix[32]) {
    uint8_t h[64];
    sha512::hash(seed, 32, h);
    std::memcpy(a, h, 32);
    a[0] &= 248;
    a[31] &= 63;
    a[31] |= 64;
    std::memcpy(prefix, h + 32, 32);
}

int unhex(const char* s, uint8_t* out, size_t n) {
    for (size_t i = 0; i < n; i++) {
        int v = 0;
        for (int j = 0; j < 2; j++) {
            char c = s[2 * i + j];
            int d = c >= 'a' ? c - 'a' + 10 : c - '0';
            v = v * 16 + d;
        }
        out[i] = (uint8_t)v;
    }
    return 0;
}

}  // namespace

extern "C" {

// the public key (compressed a·B) of a 32-byte seed
int ed25519_host_public_key(const uint8_t* seed, uint8_t* pub) {
    uint8_t a[32], prefix[32];
    expand_seed(seed, a, prefix);
    ge_compress(ge_scalarmult_base(a), pub);
    return 0;
}

// the RFC 8032 signature of msg under seed, whose public key is pub
int ed25519_host_sign(const uint8_t* seed, const uint8_t* pub,
                      const uint8_t* msg, int64_t msg_len, uint8_t* sig) {
    uint8_t a[32], prefix[32], r[32], k[32], ka[32];
    expand_seed(seed, a, prefix);
    hash_mod_l(prefix, 32, msg, (size_t)msg_len, nullptr, 0, r);
    ge_compress(ge_scalarmult_base(r), sig);
    hash_mod_l(sig, 32, pub, 32, msg, (size_t)msg_len, k);
    sc_mul(k, a, ka);
    sc_add(r, ka, sig + 32);
    return 0;
}

// 1 if sig is a valid ZIP-215 signature of msg under pub, else 0
int ed25519_host_verify(const uint8_t* pub, const uint8_t* msg,
                        int64_t msg_len, const uint8_t* sig) {
    if (!sc_is_canonical(sig + 32)) return 0;
    ge A, R;
    if (!ge_decompress(pub, &A)) return 0;
    if (!ge_decompress(sig, &R)) return 0;
    uint8_t k[32];
    hash_mod_l(sig, 32, pub, 32, msg, (size_t)msg_len, k);
    ge chk = ge_add(ge_scalarmult_base(sig + 32),
                    ge_add(ge_neg(R), ge_neg(ge_scalarmult(A, k))));
    return ge_is_identity_cofactored(chk) ? 1 : 0;
}

// 1 if RFC 8032's test vectors 1-3 sign and verify as published and
// the ZIP-215 edge cases decide as the golden model does, else 0
int ed25519_host_selftest(void) {
    static const char* const VECTORS[3][4] = {
        {"9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
         "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
         "",
         "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
         "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"},
        {"4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
         "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
         "72",
         "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
         "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"},
        {"c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
         "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
         "af82",
         "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
         "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"},
    };
    for (const auto& v : VECTORS) {
        uint8_t seed[32], want_pub[32], msg[2], want_sig[64];
        uint8_t pub[32], sig[64];
        size_t msg_len = std::strlen(v[2]) / 2;
        unhex(v[0], seed, 32);
        unhex(v[1], want_pub, 32);
        unhex(v[2], msg, msg_len);
        unhex(v[3], want_sig, 64);
        ed25519_host_public_key(seed, pub);
        if (std::memcmp(pub, want_pub, 32) != 0) return 0;
        ed25519_host_sign(seed, pub, msg, (int64_t)msg_len, sig);
        if (std::memcmp(sig, want_sig, 64) != 0) return 0;
        if (ed25519_host_verify(pub, msg, (int64_t)msg_len, sig) != 1)
            return 0;
        sig[0] ^= 1;                               // a changed R
        if (ed25519_host_verify(pub, msg, (int64_t)msg_len, sig) != 0)
            return 0;
        sig[0] ^= 1;
        uint8_t s_plus_l[64];                      // S + L: not canonical
        std::memcpy(s_plus_l, sig, 32);
        uint8_t carry = 0;
        for (int i = 0; i < 32; i++) {
            unsigned t = sig[32 + i] + L_BYTES[i] + carry;
            s_plus_l[32 + i] = (uint8_t)t;
            carry = (uint8_t)(t >> 8);
        }
        if (ed25519_host_verify(pub, msg, (int64_t)msg_len, s_plus_l) != 0)
            return 0;
    }
    // ZIP-215: A and R the identity (small order, y = 1) and S = 0 verify
    // for every message under the cofactored equation; the non-canonical
    // encoding of the identity (y = p + 1) verifies too
    uint8_t ident[32] = {1}, zero_s[64] = {1};
    if (ed25519_host_verify(ident, (const uint8_t*)"m", 1, zero_s) != 1)
        return 0;
    uint8_t ident_nc[32];
    unhex("eeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
          ident_nc, 32);
    if (ed25519_host_verify(ident_nc, (const uint8_t*)"m", 1, zero_s) != 1)
        return 0;
    // y = 2 is not on the curve: no point, so no signature verifies
    uint8_t off_curve[32] = {2};
    if (ed25519_host_verify(off_curve, (const uint8_t*)"m", 1, zero_s) != 0)
        return 0;
    return 1;
}

}  // extern "C"
