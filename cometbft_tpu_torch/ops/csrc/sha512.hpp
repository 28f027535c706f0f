// Self-contained SHA-512 (FIPS 180-4) + the ed25519 "k scalar"
// helper: SHA-512(R || A || msg) reduced mod the ed25519 group order
// L.  Used to batch the host-side prep of the TPU batch verifier.
#pragma once

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace sha512 {

struct Ctx {
    uint64_t state[8];
    uint64_t bitlen_lo;      // messages here are far below 2^64 bits
    uint8_t buf[128];
    size_t buflen;
};

static const uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL,
    0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL,
    0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL,
    0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL,
    0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL,
    0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL,
    0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL,
    0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL,
    0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL,
    0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL,
    0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL,
    0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL,
    0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL,
    0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

static inline uint64_t rotr(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

inline void init(Ctx* c) {
    c->state[0] = 0x6a09e667f3bcc908ULL;
    c->state[1] = 0xbb67ae8584caa73bULL;
    c->state[2] = 0x3c6ef372fe94f82bULL;
    c->state[3] = 0xa54ff53a5f1d36f1ULL;
    c->state[4] = 0x510e527fade682d1ULL;
    c->state[5] = 0x9b05688c2b3e6c1fULL;
    c->state[6] = 0x1f83d9abfb41bd6bULL;
    c->state[7] = 0x5be0cd19137e2179ULL;
    c->bitlen_lo = 0;
    c->buflen = 0;
}

inline void compress(Ctx* c, const uint8_t* p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) {
        uint64_t v = 0;
        for (int j = 0; j < 8; j++) v = (v << 8) | p[i * 8 + j];
        w[i] = v;
    }
    for (int i = 16; i < 80; i++) {
        uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^
                      (w[i - 15] >> 7);
        uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^
                      (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = c->state[0], b = c->state[1], cc = c->state[2],
             d = c->state[3], e = c->state[4], f = c->state[5],
             g = c->state[6], h = c->state[7];
    for (int i = 0; i < 80; i++) {
        uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + K[i] + w[i];
        uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
        uint64_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        uint64_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->state[0] += a; c->state[1] += b; c->state[2] += cc;
    c->state[3] += d; c->state[4] += e; c->state[5] += f;
    c->state[6] += g; c->state[7] += h;
}

inline void update(Ctx* c, const uint8_t* data, size_t len) {
    c->bitlen_lo += uint64_t(len) * 8;
    if (c->buflen) {
        size_t need = 128 - c->buflen;
        size_t take = len < need ? len : need;
        std::memcpy(c->buf + c->buflen, data, take);
        c->buflen += take;
        data += take;
        len -= take;
        if (c->buflen == 128) {
            compress(c, c->buf);
            c->buflen = 0;
        }
    }
    while (len >= 128) {
        compress(c, data);
        data += 128;
        len -= 128;
    }
    if (len) {
        std::memcpy(c->buf, data, len);
        c->buflen = len;
    }
}

inline void final(Ctx* c, uint8_t out[64]) {
    uint64_t bitlen = c->bitlen_lo;
    uint8_t pad = 0x80;
    update(c, &pad, 1);
    uint8_t zero = 0;
    while (c->buflen != 112)
        update(c, &zero, 1);
    // 128-bit length; high 8 bytes are zero for our input sizes
    std::memset(c->buf + 112, 0, 8);
    for (int i = 0; i < 8; i++)
        c->buf[120 + i] = uint8_t(bitlen >> (56 - 8 * i));
    compress(c, c->buf);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = uint8_t(c->state[i] >> (56 - 8 * j));
}

inline void hash(const uint8_t* data, size_t len, uint8_t out[64]) {
    Ctx c;
    init(&c);
    update(&c, data, len);
    final(&c, out);
}

// ---------------------------------------------------------------------------
// reduce a 512-bit little-endian value mod the ed25519 group order
// L = 2^252 + 27742317777372353535851937790883648493, via Barrett
// reduction (HAC 14.42) with b = 2^64, k = 4:
//   mu = floor(b^8 / L)            (5 limbs, precomputed)
//   q  = ((x >> 64*(k-1)) * mu) >> 64*(k+1)
//   r  = (x - q*L) mod b^(k+1); then at most a few subtractions of L.

static const uint64_t L_LIMBS[4] = {
    0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
    0x0000000000000000ULL, 0x1000000000000000ULL,
};
static const uint64_t MU_LIMBS[5] = {   // floor(2^512 / L)
    0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL,
    0xffffffffffffffebULL, 0xffffffffffffffffULL,
    0x000000000000000fULL,
};

// out[no] = a[na] * b[nb] (schoolbook, truncated to no limbs)
inline void mul_trunc(const uint64_t* a, int na, const uint64_t* b,
                      int nb, uint64_t* out, int no) {
    for (int i = 0; i < no; i++) out[i] = 0;
    for (int i = 0; i < na; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < nb && i + j < no; j++) {
            unsigned __int128 cur = (unsigned __int128)a[i] * b[j] +
                                    out[i + j] + (uint64_t)carry;
            out[i + j] = uint64_t(cur);
            carry = cur >> 64;
        }
        if (i + nb < no) {
            int k = i + nb;
            while (carry && k < no) {
                unsigned __int128 cur = (unsigned __int128)out[k] +
                                        (uint64_t)carry;
                out[k] = uint64_t(cur);
                carry = cur >> 64;
                k++;
            }
        }
    }
}

inline bool geq_l(const uint64_t x[4]) {
    for (int i = 3; i >= 0; i--) {
        if (x[i] > L_LIMBS[i]) return true;
        if (x[i] < L_LIMBS[i]) return false;
    }
    return true;
}

inline void sub_l(uint64_t x[4]) {
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d = (unsigned __int128)x[i] - L_LIMBS[i] -
                              (uint64_t)borrow;
        x[i] = uint64_t(d);
        borrow = (d >> 64) ? 1 : 0;
    }
}

// digest: 64 bytes little-endian; out: 32 bytes little-endian (mod L)
inline void reduce_mod_l(const uint8_t digest[64], uint8_t out[32]) {
    uint64_t x[8];
    for (int i = 0; i < 8; i++) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; j--) v = (v << 8) | digest[i * 8 + j];
        x[i] = v;
    }
    // q1 = x >> 64*3 (5 limbs); q2 = q1 * mu (10 limbs);
    // q3 = q2 >> 64*5 (5 limbs)
    uint64_t q2[10];
    mul_trunc(x + 3, 5, MU_LIMBS, 5, q2, 10);
    const uint64_t* q3 = q2 + 5;
    // r = (x - q3*L) mod 2^(64*5): 5-limb truncated arithmetic
    uint64_t q3l[5];
    mul_trunc(q3, 5, L_LIMBS, 4, q3l, 5);
    uint64_t r5[5];
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 5; i++) {
        unsigned __int128 d = (unsigned __int128)x[i] - q3l[i] -
                              (uint64_t)borrow;
        r5[i] = uint64_t(d);
        borrow = (d >> 64) ? 1 : 0;
    }
    // Barrett guarantees 0 <= r < 3L < 2^254, so limb 4 is zero after
    // the subtractions below and r fits 4 limbs
    uint64_t r[4] = {r5[0], r5[1], r5[2], r5[3]};
    while (r5[4] || geq_l(r)) {
        unsigned __int128 b2 = 0;
        for (int i = 0; i < 4; i++) {
            unsigned __int128 d = (unsigned __int128)r[i] -
                                  L_LIMBS[i] - (uint64_t)b2;
            r[i] = uint64_t(d);
            b2 = (d >> 64) ? 1 : 0;
        }
        if (b2)
            r5[4] -= 1;     // borrow consumed the limb-4 excess
    }
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = uint8_t(r[i] >> (8 * j));
}

}  // namespace sha512
