// 8-way multi-buffer SHA-512 (AVX-512): eight independent messages
// hashed in the 64-bit lanes of ZMM registers.  This is the standard
// wide-lane construction (one logical SHA-512 round executed on 8
// lanes at once) — the batch verifier's k = SHA-512(R||A||msg) prep
// is embarrassingly parallel across signatures, and the scalar loop
// alone (~9 ms at 10k sigs) blows the < 5 ms end-to-end budget.
// Runtime-gated on AVX-512F; callers fall back to sha512::hash.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "sha512.hpp"

#if defined(__x86_64__) || defined(_M_X64)
#define COMETBFT_SHA512MB_X86 1
#include <immintrin.h>
#endif

namespace sha512mb {

inline bool available() {
#if COMETBFT_SHA512MB_X86
    return __builtin_cpu_supports("avx512f");
#else
    return false;
#endif
}

// number of 128-byte blocks for a total message length (bytes)
inline size_t block_count(size_t total_len) {
    return (total_len + 17 + 127) / 128;
}

// write the FIPS-180-4 padding for a message already copied at buf
// (buf must be zeroed, nblocks*128 bytes)
inline void write_padding(uint8_t* buf, size_t total_len,
                          size_t nblocks) {
    buf[total_len] = 0x80;
    uint64_t bitlen = uint64_t(total_len) * 8;
    uint8_t* p = buf + nblocks * 128 - 8;
    for (int i = 0; i < 8; i++)
        p[i] = uint8_t(bitlen >> (56 - 8 * i));
}

#if COMETBFT_SHA512MB_X86

#define MB_TARGET __attribute__((target("avx512f")))

MB_TARGET static inline __m512i mb_ror(__m512i x, int n) {
    return _mm512_or_si512(_mm512_srli_epi64(x, n),
                           _mm512_slli_epi64(x, 64 - n));
}

MB_TARGET static inline __m512i mb_shr(__m512i x, int n) {
    return _mm512_srli_epi64(x, n);
}

MB_TARGET static inline __m512i mb_add(__m512i a, __m512i b) {
    return _mm512_add_epi64(a, b);
}

MB_TARGET static inline __m512i mb_xor3(__m512i a, __m512i b,
                                        __m512i c) {
    return _mm512_xor_si512(_mm512_xor_si512(a, b), c);
}

// hash 8 equal-block-count messages: lane l's padded message starts
// at base[l] (nblocks * 128 bytes, padding already written).  Digests
// out as 64 big-endian bytes per lane.
MB_TARGET inline void hash8(const uint8_t* const base[8],
                            size_t nblocks, uint8_t out[8][64]) {
    static const uint64_t H0[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
        0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
        0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
    };
    __m512i h[8];
    for (int i = 0; i < 8; i++) h[i] = _mm512_set1_epi64(int64_t(H0[i]));

    alignas(64) uint64_t lanes[8];
    for (size_t blk = 0; blk < nblocks; blk++) {
        __m512i w[16];
        for (int t = 0; t < 16; t++) {
            for (int l = 0; l < 8; l++) {
                uint64_t v;
                std::memcpy(&v, base[l] + blk * 128 + t * 8, 8);
                lanes[l] = __builtin_bswap64(v);
            }
            w[t] = _mm512_load_si512(
                reinterpret_cast<const void*>(lanes));
        }
        __m512i a = h[0], b = h[1], c = h[2], d = h[3];
        __m512i e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int t = 0; t < 80; t++) {
            if (t >= 16) {
                __m512i w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
                __m512i s0 = mb_xor3(mb_ror(w15, 1), mb_ror(w15, 8),
                                     mb_shr(w15, 7));
                __m512i s1 = mb_xor3(mb_ror(w2, 19), mb_ror(w2, 61),
                                     mb_shr(w2, 6));
                w[t & 15] = mb_add(mb_add(w[t & 15], s0),
                                   mb_add(w[(t - 7) & 15], s1));
            }
            __m512i S1 = mb_xor3(mb_ror(e, 14), mb_ror(e, 18),
                                 mb_ror(e, 41));
            __m512i ch = _mm512_xor_si512(
                _mm512_and_si512(e, f),
                _mm512_andnot_si512(e, g));
            __m512i t1 = mb_add(
                mb_add(hh, S1),
                mb_add(mb_add(ch, _mm512_set1_epi64(
                    int64_t(sha512::K[t]))), w[t & 15]));
            __m512i S0 = mb_xor3(mb_ror(a, 28), mb_ror(a, 34),
                                 mb_ror(a, 39));
            __m512i maj = mb_xor3(_mm512_and_si512(a, b),
                                  _mm512_and_si512(a, c),
                                  _mm512_and_si512(b, c));
            __m512i t2 = mb_add(S0, maj);
            hh = g; g = f; f = e; e = mb_add(d, t1);
            d = c; c = b; b = a; a = mb_add(t1, t2);
        }
        h[0] = mb_add(h[0], a); h[1] = mb_add(h[1], b);
        h[2] = mb_add(h[2], c); h[3] = mb_add(h[3], d);
        h[4] = mb_add(h[4], e); h[5] = mb_add(h[5], f);
        h[6] = mb_add(h[6], g); h[7] = mb_add(h[7], hh);
    }
    for (int i = 0; i < 8; i++) {
        _mm512_store_si512(reinterpret_cast<void*>(lanes), h[i]);
        for (int l = 0; l < 8; l++)
            for (int j = 0; j < 8; j++)
                out[l][i * 8 + j] = uint8_t(lanes[l] >> (56 - 8 * j));
    }
}

#undef MB_TARGET

#endif  // COMETBFT_SHA512MB_X86

}  // namespace sha512mb
