// ChaCha20-Poly1305 AEAD (RFC 8439) on the host, behind a plain C ABI.
//
// The seal and open of every 1,044-byte secret-connection frame
// (p2p/secret_connection.py).  Built with g++ into a library of its own
// by ops/_build.load_aead(), which runs aead_selftest() on the RFC 8439
// section 2.8.2 vector at load and raises if it fails.  The cipher below
// is a copy of the reference's native/chacha20poly1305.hpp, unchanged;
// crypto/_aead_ref.py is its plain version.
//
//   aead_seal(key, nonce, aad, aad_len, pt, pt_len, out): out holds
//       pt_len + 16 bytes (ciphertext || tag); returns 1.
//   aead_open(key, nonce, aad, aad_len, ct, ct_len, out): out holds
//       ct_len - 16 bytes; returns 1, or 0 when the tag does not match
//       or ct_len < 16 (out is then untouched).
//   aead_selftest(): 1 when the RFC 8439 vector seals and opens, and a
//       flipped tag bit is refused.

#include <cstdint>
#include <cstring>
#include <vector>

namespace ccp {

static inline uint32_t rotl32(uint32_t x, int n) {
    return (x << n) | (x >> (32 - n));
}

static inline uint32_t le32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

static inline void st32(uint8_t* p, uint32_t v) {
    p[0] = v & 0xff; p[1] = (v >> 8) & 0xff;
    p[2] = (v >> 16) & 0xff; p[3] = (v >> 24) & 0xff;
}

#define CCP_QR(a, b, c, d)                                    \
    a += b; d ^= a; d = rotl32(d, 16);                        \
    c += d; b ^= c; b = rotl32(b, 12);                        \
    a += b; d ^= a; d = rotl32(d, 8);                         \
    c += d; b ^= c; b = rotl32(b, 7);

inline void chacha20_block(const uint8_t key[32], uint32_t counter,
                           const uint8_t nonce[12], uint8_t out[64]) {
    uint32_t s[16] = {0x61707865u, 0x3320646eu, 0x79622d32u,
                      0x6b206574u};
    for (int i = 0; i < 8; i++) s[4 + i] = le32(key + 4 * i);
    s[12] = counter;
    for (int i = 0; i < 3; i++) s[13 + i] = le32(nonce + 4 * i);
    uint32_t x[16];
    std::memcpy(x, s, sizeof(x));
    for (int r = 0; r < 10; r++) {
        CCP_QR(x[0], x[4], x[8], x[12]);
        CCP_QR(x[1], x[5], x[9], x[13]);
        CCP_QR(x[2], x[6], x[10], x[14]);
        CCP_QR(x[3], x[7], x[11], x[15]);
        CCP_QR(x[0], x[5], x[10], x[15]);
        CCP_QR(x[1], x[6], x[11], x[12]);
        CCP_QR(x[2], x[7], x[8], x[13]);
        CCP_QR(x[3], x[4], x[9], x[14]);
    }
    for (int i = 0; i < 16; i++) st32(out + 4 * i, x[i] + s[i]);
}

inline void chacha20_xor(const uint8_t key[32], uint32_t counter,
                         const uint8_t nonce[12], const uint8_t* in,
                         uint8_t* out, size_t n) {
    uint8_t block[64];
    size_t off = 0;
    while (off < n) {
        chacha20_block(key, counter++, nonce, block);
        size_t take = (n - off < 64) ? n - off : 64;
        for (size_t i = 0; i < take; i++)
            out[off + i] = in[off + i] ^ block[i];
        off += take;
    }
}

// ---- Poly1305 over 26-bit limbs (portable, no __int128 needed) ------
struct Poly1305 {
    uint32_t r[5], h[5] = {0, 0, 0, 0, 0}, pad[4];

    explicit Poly1305(const uint8_t key[32]) {
        r[0] = (le32(key + 0)) & 0x3ffffff;
        r[1] = (le32(key + 3) >> 2) & 0x3ffff03;
        r[2] = (le32(key + 6) >> 4) & 0x3ffc0ff;
        r[3] = (le32(key + 9) >> 6) & 0x3f03fff;
        r[4] = (le32(key + 12) >> 8) & 0x00fffff;
        for (int i = 0; i < 4; i++) pad[i] = le32(key + 16 + 4 * i);
    }

    void blocks(const uint8_t* m, size_t n, uint32_t hibit) {
        const uint32_t s1 = r[1] * 5, s2 = r[2] * 5, s3 = r[3] * 5,
                       s4 = r[4] * 5;
        uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3],
                 h4 = h[4];
        while (n >= 16) {
            h0 += (le32(m + 0)) & 0x3ffffff;
            h1 += (le32(m + 3) >> 2) & 0x3ffffff;
            h2 += (le32(m + 6) >> 4) & 0x3ffffff;
            h3 += (le32(m + 9) >> 6) & 0x3ffffff;
            h4 += (le32(m + 12) >> 8) | hibit;
            uint64_t d0 = (uint64_t)h0 * r[0] + (uint64_t)h1 * s4 +
                          (uint64_t)h2 * s3 + (uint64_t)h3 * s2 +
                          (uint64_t)h4 * s1;
            uint64_t d1 = (uint64_t)h0 * r[1] + (uint64_t)h1 * r[0] +
                          (uint64_t)h2 * s4 + (uint64_t)h3 * s3 +
                          (uint64_t)h4 * s2;
            uint64_t d2 = (uint64_t)h0 * r[2] + (uint64_t)h1 * r[1] +
                          (uint64_t)h2 * r[0] + (uint64_t)h3 * s4 +
                          (uint64_t)h4 * s3;
            uint64_t d3 = (uint64_t)h0 * r[3] + (uint64_t)h1 * r[2] +
                          (uint64_t)h2 * r[1] + (uint64_t)h3 * r[0] +
                          (uint64_t)h4 * s4;
            uint64_t d4 = (uint64_t)h0 * r[4] + (uint64_t)h1 * r[3] +
                          (uint64_t)h2 * r[2] + (uint64_t)h3 * r[1] +
                          (uint64_t)h4 * r[0];
            uint32_t c = (uint32_t)(d0 >> 26); h0 = d0 & 0x3ffffff;
            d1 += c; c = (uint32_t)(d1 >> 26); h1 = d1 & 0x3ffffff;
            d2 += c; c = (uint32_t)(d2 >> 26); h2 = d2 & 0x3ffffff;
            d3 += c; c = (uint32_t)(d3 >> 26); h3 = d3 & 0x3ffffff;
            d4 += c; c = (uint32_t)(d4 >> 26); h4 = d4 & 0x3ffffff;
            h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
            h1 += c;
            m += 16;
            n -= 16;
        }
        h[0] = h0; h[1] = h1; h[2] = h2; h[3] = h3; h[4] = h4;
    }

    void finish(uint8_t tag[16]) {
        uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3],
                 h4 = h[4];
        uint32_t c = h1 >> 26; h1 &= 0x3ffffff;
        h2 += c; c = h2 >> 26; h2 &= 0x3ffffff;
        h3 += c; c = h3 >> 26; h3 &= 0x3ffffff;
        h4 += c; c = h4 >> 26; h4 &= 0x3ffffff;
        h0 += c * 5; c = h0 >> 26; h0 &= 0x3ffffff;
        h1 += c;
        // compute h + -p
        uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
        uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
        uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
        uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
        uint32_t g4 = h4 + c - (1u << 26);
        uint32_t mask = (g4 >> 31) - 1;   // all-ones when h >= p
        h0 = (h0 & ~mask) | (g0 & mask);
        h1 = (h1 & ~mask) | (g1 & mask);
        h2 = (h2 & ~mask) | (g2 & mask);
        h3 = (h3 & ~mask) | (g3 & mask);
        h4 = (h4 & ~mask) | (g4 & mask);
        h0 = (h0 | (h1 << 26)) & 0xffffffff;
        h1 = ((h1 >> 6) | (h2 << 20)) & 0xffffffff;
        h2 = ((h2 >> 12) | (h3 << 14)) & 0xffffffff;
        h3 = ((h3 >> 18) | (h4 << 8)) & 0xffffffff;
        uint64_t f;
        f = (uint64_t)h0 + pad[0]; h0 = (uint32_t)f;
        f = (uint64_t)h1 + pad[1] + (f >> 32); h1 = (uint32_t)f;
        f = (uint64_t)h2 + pad[2] + (f >> 32); h2 = (uint32_t)f;
        f = (uint64_t)h3 + pad[3] + (f >> 32); h3 = (uint32_t)f;
        st32(tag + 0, h0); st32(tag + 4, h1);
        st32(tag + 8, h2); st32(tag + 12, h3);
    }
};

inline void aead_tag(const uint8_t key[32], const uint8_t nonce[12],
                     const uint8_t* aad, size_t aad_len,
                     const uint8_t* ct, size_t ct_len,
                     uint8_t tag[16]) {
    uint8_t block0[64];
    chacha20_block(key, 0, nonce, block0);
    Poly1305 mac(block0);
    // AEAD mac input: aad || pad16 || ct || pad16 || le64 lens
    mac.blocks(aad, aad_len & ~(size_t)15, 1u << 24);
    if (aad_len & 15) {
        uint8_t last[16] = {0};
        std::memcpy(last, aad + (aad_len & ~(size_t)15), aad_len & 15);
        mac.blocks(last, 16, 1u << 24);
    }
    mac.blocks(ct, ct_len & ~(size_t)15, 1u << 24);
    if (ct_len & 15) {
        uint8_t last[16] = {0};
        std::memcpy(last, ct + (ct_len & ~(size_t)15), ct_len & 15);
        mac.blocks(last, 16, 1u << 24);
    }
    uint8_t lens[16];
    for (int i = 0; i < 8; i++) {
        lens[i] = (uint8_t)(((uint64_t)aad_len) >> (8 * i));
        lens[8 + i] = (uint8_t)(((uint64_t)ct_len) >> (8 * i));
    }
    mac.blocks(lens, 16, 1u << 24);
    mac.finish(tag);
}

// seal: out must hold pt_len + 16
inline void seal(const uint8_t key[32], const uint8_t nonce[12],
                 const uint8_t* aad, size_t aad_len,
                 const uint8_t* pt, size_t pt_len, uint8_t* out) {
    chacha20_xor(key, 1, nonce, pt, out, pt_len);
    aead_tag(key, nonce, aad, aad_len, out, pt_len, out + pt_len);
}

// open: returns false on tag mismatch; out must hold ct_len - 16
inline bool open(const uint8_t key[32], const uint8_t nonce[12],
                 const uint8_t* aad, size_t aad_len,
                 const uint8_t* ct, size_t ct_len, uint8_t* out) {
    if (ct_len < 16) return false;
    size_t pt_len = ct_len - 16;
    uint8_t tag[16];
    aead_tag(key, nonce, aad, aad_len, ct, pt_len, tag);
    uint8_t diff = 0;
    for (int i = 0; i < 16; i++) diff |= tag[i] ^ ct[pt_len + i];
    if (diff) return false;
    chacha20_xor(key, 1, nonce, ct, out, pt_len);
    return true;
}

}  // namespace ccp

extern "C" {

int aead_seal(const uint8_t* key, const uint8_t* nonce, const uint8_t* aad,
              int64_t aad_len, const uint8_t* pt, int64_t pt_len,
              uint8_t* out) {
    ccp::seal(key, nonce, aad, (size_t)aad_len, pt, (size_t)pt_len, out);
    return 1;
}

int aead_open(const uint8_t* key, const uint8_t* nonce, const uint8_t* aad,
              int64_t aad_len, const uint8_t* ct, int64_t ct_len,
              uint8_t* out) {
    if (ct_len < 16) return 0;
    return ccp::open(key, nonce, aad, (size_t)aad_len, ct, (size_t)ct_len,
                     out) ? 1 : 0;
}

static int hexval(char c) {
    return c <= '9' ? c - '0' : c - 'a' + 10;
}

int aead_selftest() {
    // RFC 8439 section 2.8.2
    static const char* kPt =
        "Ladies and Gentlemen of the class of '99: If I could offer you "
        "only one tip for the future, sunscreen would be it.";
    static const char* kCtHex =
        "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
        "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
        "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
        "3ff4def08e4b7a9de576d26586cec64b6116"
        "1ae10b594f09e26a7e902ecbd0600691";
    uint8_t key[32], nonce[12] = {7, 0, 0, 0};
    uint8_t aad[12] = {0x50, 0x51, 0x52, 0x53, 0xc0, 0xc1,
                       0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7};
    for (int i = 0; i < 32; i++) key[i] = (uint8_t)(0x80 + i);
    for (int i = 0; i < 8; i++) nonce[4 + i] = (uint8_t)(0x40 + i);
    const size_t n = std::strlen(kPt);
    if (n != 114 || std::strlen(kCtHex) != 2 * (n + 16)) return 0;
    std::vector<uint8_t> want(n + 16), got(n + 16), back(n);
    for (size_t i = 0; i < n + 16; i++)
        want[i] = (uint8_t)(hexval(kCtHex[2 * i]) << 4 |
                            hexval(kCtHex[2 * i + 1]));
    ccp::seal(key, nonce, aad, sizeof(aad), (const uint8_t*)kPt, n,
              got.data());
    if (std::memcmp(got.data(), want.data(), n + 16) != 0) return 0;
    if (!ccp::open(key, nonce, aad, sizeof(aad), got.data(), n + 16,
                   back.data()))
        return 0;
    if (std::memcmp(back.data(), kPt, n) != 0) return 0;
    got[n] ^= 1;  // a flipped tag bit
    if (ccp::open(key, nonce, aad, sizeof(aad), got.data(), n + 16,
                  back.data()))
        return 0;
    return 1;
}

}  // extern "C"
