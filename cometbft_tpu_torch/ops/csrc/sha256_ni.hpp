// SHA-256 compress using x86 SHA-NI intrinsics (runtime-detected).
// One 64-byte block per call; drop-in replacement for the scalar
// compress in sha256.hpp when the CPU supports it.  Written against
// the Intel SHA extensions programming reference round structure.
#pragma once

#if defined(__x86_64__) || defined(_M_X64)
#define COMETBFT_SHA_NI_POSSIBLE 1
#include <immintrin.h>
#if defined(__GNUC__)
#include <cpuid.h>
#endif

namespace sha256ni {

__attribute__((target("sha,sse4.1")))
inline void compress(uint32_t state[8], const uint8_t* data) {
    const __m128i MASK = _mm_set_epi64x(0x0c0d0e0f08090a0bULL,
                                        0x0405060700010203ULL);

    __m128i TMP =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[0]));
    __m128i STATE1 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[4]));
    TMP = _mm_shuffle_epi32(TMP, 0xB1);                   // CDAB
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);             // EFGH
    __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);     // ABEF
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);          // CDGH

    const __m128i ABEF_SAVE = STATE0;
    const __m128i CDGH_SAVE = STATE1;
    __m128i MSG, MSG0, MSG1, MSG2, MSG3;

    // rounds 0-3
    MSG0 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(data)), MASK);
    MSG = _mm_add_epi32(MSG0,
        _mm_set_epi64x(0xE9B5DBA5B5C0FBCFULL, 0x71374491428A2F98ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    // rounds 4-7
    MSG1 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 16)),
        MASK);
    MSG = _mm_add_epi32(MSG1,
        _mm_set_epi64x(0xAB1C5ED5923F82A4ULL, 0x59F111F13956C25BULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

    // rounds 8-11
    MSG2 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 32)),
        MASK);
    MSG = _mm_add_epi32(MSG2,
        _mm_set_epi64x(0x550C7DC3243185BEULL, 0x12835B01D807AA98ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

    // rounds 12-15
    MSG3 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 48)),
        MASK);
    MSG = _mm_add_epi32(MSG3,
        _mm_set_epi64x(0xC19BF1749BDC06A7ULL, 0x80DEB1FE72BE5D74ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
    MSG0 = _mm_add_epi32(MSG0, TMP);
    MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

    // rounds 16-51: the steady-state schedule, rotating MSG0..MSG3
#define QROUND(MA, MB, MC, MD, K1, K0)                                 \
    MSG = _mm_add_epi32(MA, _mm_set_epi64x(K1, K0));                   \
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);               \
    TMP = _mm_alignr_epi8(MA, MD, 4);                                  \
    MB = _mm_add_epi32(MB, TMP);                                       \
    MB = _mm_sha256msg2_epu32(MB, MA);                                 \
    MSG = _mm_shuffle_epi32(MSG, 0x0E);                                \
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);               \
    MD = _mm_sha256msg1_epu32(MD, MA);

    QROUND(MSG0, MSG1, MSG2, MSG3,
           0x240CA1CC0FC19DC6ULL, 0xEFBE4786E49B69C1ULL)  // 16-19
    QROUND(MSG1, MSG2, MSG3, MSG0,
           0x76F988DA5CB0A9DCULL, 0x4A7484AA2DE92C6FULL)  // 20-23
    QROUND(MSG2, MSG3, MSG0, MSG1,
           0xBF597FC7B00327C8ULL, 0xA831C66D983E5152ULL)  // 24-27
    QROUND(MSG3, MSG0, MSG1, MSG2,
           0x1429296706CA6351ULL, 0xD5A79147C6E00BF3ULL)  // 28-31
    QROUND(MSG0, MSG1, MSG2, MSG3,
           0x53380D134D2C6DFCULL, 0x2E1B213827B70A85ULL)  // 32-35
    QROUND(MSG1, MSG2, MSG3, MSG0,
           0x92722C8581C2C92EULL, 0x766A0ABB650A7354ULL)  // 36-39
    QROUND(MSG2, MSG3, MSG0, MSG1,
           0xC76C51A3C24B8B70ULL, 0xA81A664BA2BFE8A1ULL)  // 40-43
    QROUND(MSG3, MSG0, MSG1, MSG2,
           0x106AA070F40E3585ULL, 0xD6990624D192E819ULL)  // 44-47
    QROUND(MSG0, MSG1, MSG2, MSG3,
           0x34B0BCB52748774CULL, 0x1E376C0819A4C116ULL)  // 48-51
#undef QROUND

    // rounds 52-55 (last msg2 for MSG2; no more msg1)
    MSG = _mm_add_epi32(MSG1,
        _mm_set_epi64x(0x682E6FF35B9CCA4FULL, 0x4ED8AA4A391C0CB3ULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
    MSG2 = _mm_add_epi32(MSG2, TMP);
    MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    // rounds 56-59
    MSG = _mm_add_epi32(MSG2,
        _mm_set_epi64x(0x8CC7020884C87814ULL, 0x78A5636F748F82EEULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
    MSG3 = _mm_add_epi32(MSG3, TMP);
    MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    // rounds 60-63
    MSG = _mm_add_epi32(MSG3,
        _mm_set_epi64x(0xC67178F2BEF9A3F7ULL, 0xA4506CEB90BEFFFAULL));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

    TMP = _mm_shuffle_epi32(STATE0, 0x1B);                // FEBA
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);             // DCHG
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);          // DCBA
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);             // ABEF->HGFE

    _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[0]), STATE0);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[4]), STATE1);
}

inline bool supported() {
#if defined(__GNUC__) && !defined(__clang__) && __GNUC__ < 11
    // GCC 10's __builtin_cpu_supports rejects the "sha" feature
    // string at compile time (added in GCC 11) — the whole native
    // build died on it.  Probe cpuid directly instead.
    unsigned eax, ebx, ecx, edx;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx))
        return false;
    const bool sha = (ebx >> 29) & 1u;          // leaf 7.0 EBX[29]
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx))
        return false;
    const bool sse41 = (ecx >> 19) & 1u;        // leaf 1 ECX[19]
    return sha && sse41;
#else
    return __builtin_cpu_supports("sha") &&
           __builtin_cpu_supports("sse4.1");
#endif
}

}  // namespace sha256ni
#else
#define COMETBFT_SHA_NI_POSSIBLE 0
#endif
