// Self-contained SHA-256 (FIPS 180-4).  Written from the spec for the
// merkle/native module — no external crypto dependency (the build
// image ships no OpenSSL headers).
#pragma once

#include <cstdint>
#include <cstring>
#include <cstddef>

#include "sha256_ni.hpp"

namespace sha256 {

struct Ctx {
    uint32_t state[8];
    uint64_t bitlen;
    uint8_t buf[64];
    size_t buflen;
};

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

static inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

inline void init(Ctx* c) {
    c->state[0] = 0x6a09e667; c->state[1] = 0xbb67ae85;
    c->state[2] = 0x3c6ef372; c->state[3] = 0xa54ff53a;
    c->state[4] = 0x510e527f; c->state[5] = 0x9b05688c;
    c->state[6] = 0x1f83d9ab; c->state[7] = 0x5be0cd19;
    c->bitlen = 0;
    c->buflen = 0;
}

inline void compress_scalar(Ctx* c, const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
               (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                      (w[i - 15] >> 3);
        uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                      (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = c->state[0], b = c->state[1], cc = c->state[2],
             d = c->state[3], e = c->state[4], f = c->state[5],
             g = c->state[6], h = c->state[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K[i] + w[i];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->state[0] += a; c->state[1] += b; c->state[2] += cc;
    c->state[3] += d; c->state[4] += e; c->state[5] += f;
    c->state[6] += g; c->state[7] += h;
}

inline void compress(Ctx* c, const uint8_t* p) {
#if COMETBFT_SHA_NI_POSSIBLE
    static const bool ni = sha256ni::supported();
    if (ni) {
        sha256ni::compress(c->state, p);
        return;
    }
#endif
    compress_scalar(c, p);
}

inline void update(Ctx* c, const uint8_t* data, size_t len) {
    c->bitlen += uint64_t(len) * 8;
    if (c->buflen) {
        size_t need = 64 - c->buflen;
        size_t take = len < need ? len : need;
        std::memcpy(c->buf + c->buflen, data, take);
        c->buflen += take;
        data += take;
        len -= take;
        if (c->buflen == 64) {
            compress(c, c->buf);
            c->buflen = 0;
        }
    }
    while (len >= 64) {
        compress(c, data);
        data += 64;
        len -= 64;
    }
    if (len) {
        std::memcpy(c->buf, data, len);
        c->buflen = len;
    }
}

inline void final(Ctx* c, uint8_t out[32]) {
    uint64_t bitlen = c->bitlen;
    uint8_t pad = 0x80;
    update(c, &pad, 1);
    uint8_t zero = 0;
    while (c->buflen != 56)
        update(c, &zero, 1);  // bitlen counter is advanced but unused
    uint8_t lenbuf[8];
    for (int i = 0; i < 8; i++)
        lenbuf[i] = uint8_t(bitlen >> (56 - 8 * i));
    // write the length block directly (update would change bitlen)
    std::memcpy(c->buf + 56, lenbuf, 8);
    compress(c, c->buf);
    for (int i = 0; i < 8; i++) {
        out[i * 4] = uint8_t(c->state[i] >> 24);
        out[i * 4 + 1] = uint8_t(c->state[i] >> 16);
        out[i * 4 + 2] = uint8_t(c->state[i] >> 8);
        out[i * 4 + 3] = uint8_t(c->state[i]);
    }
}

inline void hash(const uint8_t* data, size_t len, uint8_t out[32]) {
    Ctx c;
    init(&c);
    update(&c, data, len);
    final(&c, out);
}

// hash of prefix-byte + payload (merkle leaf) without copying
inline void hash_prefixed(uint8_t prefix, const uint8_t* data,
                          size_t len, uint8_t out[32]) {
    Ctx c;
    init(&c);
    update(&c, &prefix, 1);
    update(&c, data, len);
    final(&c, out);
}

}  // namespace sha256
