// BLS12-381 on the host, with a plain C interface.
//
// Counterpart of the bls_* functions of the JAX package's native module
// (native/_native.cpp:535-760): the same eleven operations over
// bls12381.hpp (a verbatim copy), with no Python object anywhere.
// ops/_build.py compiles this file with g++ into a host library of its
// own, and ops/bls_native.py calls it through ctypes, which drops the
// GIL for the call.
//
// Points travel as the reference's raw wire form: big-endian affine
// coordinates, x || y for G1 (96 bytes) and x.c0 || x.c1 || y.c0 || y.c1
// for G2 (192 bytes).  A point argument comes with its length, and a
// length of 0 is the point at infinity; an output point is written to a
// full-width buffer and the return code says whether it is infinity.
//
// Return codes:
//   predicates       1 true, 0 false
//   point results    0 a point, 1 infinity
//   every function  -1 a coordinate >= p, -2 a wrong length,
//                   -3 an invalid compressed encoding, -4 DST too long

#include <cstdint>
#include <cstring>
#include <vector>

#include "bls12381.hpp"

namespace {

constexpr int kCoord = -1;
constexpr int kLength = -2;
constexpr int kEncoding = -3;
constexpr int kDst = -4;

int parse_g1(const uint8_t* b, int64_t len, bls::G1* out) {
    if (len == 0) {
        out->inf = true;
        return 0;
    }
    if (len != 96) return kLength;
    out->inf = false;
    if (!bls::fp_from_be48(b, &out->x) || !bls::fp_from_be48(b + 48, &out->y))
        return kCoord;
    return 0;
}

int parse_g2(const uint8_t* b, int64_t len, bls::G2* out) {
    if (len == 0) {
        out->inf = true;
        return 0;
    }
    if (len != 192) return kLength;
    out->inf = false;
    if (!bls::fp_from_be48(b, &out->x.c0) ||
        !bls::fp_from_be48(b + 48, &out->x.c1) ||
        !bls::fp_from_be48(b + 96, &out->y.c0) ||
        !bls::fp_from_be48(b + 144, &out->y.c1))
        return kCoord;
    return 0;
}

int put_g1(const bls::G1& p, uint8_t* out) {
    if (p.inf) return 1;
    bls::fp_to_be48(p.x, out);
    bls::fp_to_be48(p.y, out + 48);
    return 0;
}

int put_g2(const bls::G2& p, uint8_t* out) {
    if (p.inf) return 1;
    bls::fp_to_be48(p.x.c0, out);
    bls::fp_to_be48(p.x.c1, out + 48);
    bls::fp_to_be48(p.y.c0, out + 96);
    bls::fp_to_be48(p.y.c1, out + 144);
    return 0;
}

}  // namespace

extern "C" {

// bls::selftest() && bls::selftest_psi(): the field, Frobenius, final
// exponentiation and psi fast paths against their plain formulations
int bls_selftest(void) {
    return bls::selftest() && bls::selftest_psi() ? 1 : 0;
}

// prod e(P_i, Q_i) == 1 over n pairs: g1s holds n 96-byte slots and
// g2s n 192-byte slots, g1_lens / g2_lens each point's length (0 or the
// slot's width)
int bls_pairings_product_is_one(const uint8_t* g1s, const int64_t* g1_lens,
                                const uint8_t* g2s, const int64_t* g2_lens,
                                int64_t n) {
    std::vector<bls::Pair> pairs(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) {
        int rc = parse_g1(g1s + 96 * i, g1_lens[i], &pairs[size_t(i)].p);
        if (rc == 0) rc = parse_g2(g2s + 192 * i, g2_lens[i], &pairs[size_t(i)].q);
        if (rc != 0) return rc;
    }
    return bls::pairings_product_is_one(pairs) ? 1 : 0;
}

int bls_g1_in_subgroup(const uint8_t* p, int64_t len) {
    bls::G1 pt;
    int rc = parse_g1(p, len, &pt);
    if (rc != 0) return rc;
    return bls::g1_in_subgroup(pt) ? 1 : 0;
}

int bls_g2_in_subgroup(const uint8_t* p, int64_t len) {
    bls::G2 pt;
    int rc = parse_g2(p, len, &pt);
    if (rc != 0) return rc;
    return bls::g2_in_subgroup(pt) ? 1 : 0;
}

// RFC 9380 hash_to_curve (BLS12381G2_XMD:SHA-256_SSWU_RO_) into out
int bls_hash_to_g2(const uint8_t* msg, int64_t msg_len, const uint8_t* dst,
                   int64_t dst_len, uint8_t* out) {
    if (dst_len > 255) return kDst;
    return put_g2(bls::hash_to_g2(msg, size_t(msg_len), dst, size_t(dst_len)),
                  out);
}

// ZCash-flag compressed 48 bytes -> raw G1
int bls_g1_uncompress(const uint8_t* in, uint8_t* out) {
    bls::G1 pt;
    int rc = bls::g1_uncompress(in, &pt);
    if (rc < 0) return kEncoding;
    return rc == 1 ? 1 : put_g1(pt, out);
}

// ZCash-flag compressed 96 bytes -> raw G2
int bls_g2_uncompress(const uint8_t* in, uint8_t* out) {
    bls::G2 pt;
    int rc = bls::g2_uncompress(in, &pt);
    if (rc < 0) return kEncoding;
    return rc == 1 ? 1 : put_g2(pt, out);
}

// [k]P for a big-endian scalar k of klen bytes
int bls_g1_mul(const uint8_t* p, int64_t len, const uint8_t* k, int64_t klen,
               uint8_t* out) {
    bls::G1 pt;
    int rc = parse_g1(p, len, &pt);
    if (rc != 0) return rc;
    return put_g1(pt.inf ? pt : bls::G1_mul_be_fast(pt, k, size_t(klen)), out);
}

int bls_g2_mul(const uint8_t* p, int64_t len, const uint8_t* k, int64_t klen,
               uint8_t* out) {
    bls::G2 pt;
    int rc = parse_g2(p, len, &pt);
    if (rc != 0) return rc;
    return put_g2(pt.inf ? pt : bls::G2_mul_be_fast(pt, k, size_t(klen)), out);
}

// the sum of n raw points (no infinities) laid end to end, by rounds of
// batched-inversion affine adds
int bls_g1_sum(const uint8_t* blob, int64_t n, uint8_t* out) {
    std::vector<bls::G1> pts(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) {
        int rc = parse_g1(blob + 96 * i, 96, &pts[size_t(i)]);
        if (rc != 0) return rc;
    }
    std::vector<bls::Fp> sa(static_cast<size_t>(n) / 2 + 1);
    std::vector<bls::Fp> sb(static_cast<size_t>(n) / 2 + 1);
    return put_g1(bls::sum_affine<bls::G1, bls::Fp>(
                      pts.data(), size_t(n), sa.data(), sb.data()),
                  out);
}

int bls_g2_sum(const uint8_t* blob, int64_t n, uint8_t* out) {
    std::vector<bls::G2> pts(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) {
        int rc = parse_g2(blob + 192 * i, 192, &pts[size_t(i)]);
        if (rc != 0) return rc;
    }
    std::vector<bls::Fp2> sa(static_cast<size_t>(n) / 2 + 1);
    std::vector<bls::Fp2> sb(static_cast<size_t>(n) / 2 + 1);
    return put_g2(bls::sum_affine<bls::G2, bls::Fp2>(
                      pts.data(), size_t(n), sa.data(), sb.data()),
                  out);
}

}  // extern "C"
