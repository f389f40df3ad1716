// Multi-buffer BLAKE2s-256: hash independent byte streams in the uint32
// lanes of one SIMD register file (lane-major, the same layout
// ops/blake2s.py's plain version uses) — 16 lanes on AVX-512 (native
// vprord rotates), 8 on AVX2, runtime-dispatched.  This is the CPU-floor
// answer to the reference's strictly sequential per-block scrub hashing
// (ref src/block/repair.rs:438-490 → block.rs:66-78 verify): on the
// 1-core hosts this framework targets, thread pools cannot add
// parallelism, but SIMD lanes can (~2.9 GiB/s 16-lane vs 0.38 hashlib
// on the dev host).
//
// RFC 7693 exactly (digest_size=32, no key, no salt/personal);
// bit-identity against hashlib.blake2s is enforced by
// tests/test_native_blake2s.py.
//
// Lanes may have DIFFERENT lengths: the message counter t, the final-block
// flag f0, and the "still active" mask are all per-lane vectors, so a lane
// that finishes early simply stops updating its state words (blend) while
// the remaining lanes keep compressing.  The uniform interior of the
// streams (every lane still has a full non-final chunk) runs a fast loop
// with no per-lane bookkeeping.

#include <immintrin.h>
#include <stdint.h>
#include <string.h>

namespace {

const uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

const uint8_t SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

// Every SIMD function carries target("avx2") and the .so is built WITHOUT
// -march=native (see _FLAGS in ops/native.py): a prebuilt binary carried to a non-AVX2
// host must dlopen cleanly and report unsupported via blake2s_mb_supported
// instead of SIGILLing on first use.
#define B2_TARGET __attribute__((target("avx2")))

B2_TARGET inline __m256i ror16(__m256i x) {
    const __m256i m = _mm256_setr_epi8(
        2, 3, 0, 1, 6, 7, 4, 5, 10, 11, 8, 9, 14, 15, 12, 13,
        2, 3, 0, 1, 6, 7, 4, 5, 10, 11, 8, 9, 14, 15, 12, 13);
    return _mm256_shuffle_epi8(x, m);
}

B2_TARGET inline __m256i ror12(__m256i x) {
    return _mm256_or_si256(_mm256_srli_epi32(x, 12), _mm256_slli_epi32(x, 20));
}

B2_TARGET inline __m256i ror8(__m256i x) {
    const __m256i m = _mm256_setr_epi8(
        1, 2, 3, 0, 5, 6, 7, 4, 9, 10, 11, 8, 13, 14, 15, 12,
        1, 2, 3, 0, 5, 6, 7, 4, 9, 10, 11, 8, 13, 14, 15, 12);
    return _mm256_shuffle_epi8(x, m);
}

B2_TARGET inline __m256i ror7(__m256i x) {
    return _mm256_or_si256(_mm256_srli_epi32(x, 7), _mm256_slli_epi32(x, 25));
}

// Transpose 8 lanes x 8 consecutive uint32 (from ptrs[l] + off) into
// word-major vectors m[w], lane l of m[w] = word w of stream l.
B2_TARGET inline void transpose8x8(const uint8_t *const ptrs[8], size_t off,
                         __m256i m[8]) {
    __m256i r0 = _mm256_loadu_si256((const __m256i *)(ptrs[0] + off));
    __m256i r1 = _mm256_loadu_si256((const __m256i *)(ptrs[1] + off));
    __m256i r2 = _mm256_loadu_si256((const __m256i *)(ptrs[2] + off));
    __m256i r3 = _mm256_loadu_si256((const __m256i *)(ptrs[3] + off));
    __m256i r4 = _mm256_loadu_si256((const __m256i *)(ptrs[4] + off));
    __m256i r5 = _mm256_loadu_si256((const __m256i *)(ptrs[5] + off));
    __m256i r6 = _mm256_loadu_si256((const __m256i *)(ptrs[6] + off));
    __m256i r7 = _mm256_loadu_si256((const __m256i *)(ptrs[7] + off));
    __m256i t0 = _mm256_unpacklo_epi32(r0, r1);
    __m256i t1 = _mm256_unpackhi_epi32(r0, r1);
    __m256i t2 = _mm256_unpacklo_epi32(r2, r3);
    __m256i t3 = _mm256_unpackhi_epi32(r2, r3);
    __m256i t4 = _mm256_unpacklo_epi32(r4, r5);
    __m256i t5 = _mm256_unpackhi_epi32(r4, r5);
    __m256i t6 = _mm256_unpacklo_epi32(r6, r7);
    __m256i t7 = _mm256_unpackhi_epi32(r6, r7);
    __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
    __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
    __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
    __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
    __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
    __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
    __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
    __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
    m[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
    m[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
    m[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
    m[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
    m[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
    m[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
    m[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
    m[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
}

#define G(r, i, a, b, c, d)                                   \
    do {                                                      \
        a = _mm256_add_epi32(_mm256_add_epi32(a, b),          \
                             m[SIGMA[r][2 * (i)]]);           \
        d = ror16(_mm256_xor_si256(d, a));                    \
        c = _mm256_add_epi32(c, d);                           \
        b = ror12(_mm256_xor_si256(b, c));                    \
        a = _mm256_add_epi32(_mm256_add_epi32(a, b),          \
                             m[SIGMA[r][2 * (i) + 1]]);       \
        d = ror8(_mm256_xor_si256(d, a));                     \
        c = _mm256_add_epi32(c, d);                           \
        b = ror7(_mm256_xor_si256(b, c));                     \
    } while (0)

// One compression over 8 lanes; chunk pointers must each reference 64
// readable bytes.  t_lo/t_hi/f0 are per-lane vectors.
B2_TARGET inline void compress8(__m256i h[8], const uint8_t *const chunk[8],
                      __m256i t_lo, __m256i t_hi, __m256i f0) {
    __m256i m[16];
    transpose8x8(chunk, 0, m);
    transpose8x8(chunk, 32, m + 8);
    __m256i v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
    __m256i v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
    __m256i v8 = _mm256_set1_epi32((int)IV[0]);
    __m256i v9 = _mm256_set1_epi32((int)IV[1]);
    __m256i v10 = _mm256_set1_epi32((int)IV[2]);
    __m256i v11 = _mm256_set1_epi32((int)IV[3]);
    __m256i v12 = _mm256_xor_si256(_mm256_set1_epi32((int)IV[4]), t_lo);
    __m256i v13 = _mm256_xor_si256(_mm256_set1_epi32((int)IV[5]), t_hi);
    __m256i v14 = _mm256_xor_si256(_mm256_set1_epi32((int)IV[6]), f0);
    __m256i v15 = _mm256_set1_epi32((int)IV[7]);
    for (int r = 0; r < 10; ++r) {
        G(r, 0, v0, v4, v8, v12);
        G(r, 1, v1, v5, v9, v13);
        G(r, 2, v2, v6, v10, v14);
        G(r, 3, v3, v7, v11, v15);
        G(r, 4, v0, v5, v10, v15);
        G(r, 5, v1, v6, v11, v12);
        G(r, 6, v2, v7, v8, v13);
        G(r, 7, v3, v4, v9, v14);
    }
    h[0] = _mm256_xor_si256(h[0], _mm256_xor_si256(v0, v8));
    h[1] = _mm256_xor_si256(h[1], _mm256_xor_si256(v1, v9));
    h[2] = _mm256_xor_si256(h[2], _mm256_xor_si256(v2, v10));
    h[3] = _mm256_xor_si256(h[3], _mm256_xor_si256(v3, v11));
    h[4] = _mm256_xor_si256(h[4], _mm256_xor_si256(v4, v12));
    h[5] = _mm256_xor_si256(h[5], _mm256_xor_si256(v5, v13));
    h[6] = _mm256_xor_si256(h[6], _mm256_xor_si256(v6, v14));
    h[7] = _mm256_xor_si256(h[7], _mm256_xor_si256(v7, v15));
}

// Hash 8 streams of independent lengths; outs[l] receives 32 bytes.
B2_TARGET void hash8(const uint8_t *const ptrs[8], const uint64_t lens[8],
           uint8_t *const outs[8]) {
    __m256i h[8];
    // Parameter block word 0: digest_length=32 | fanout=1<<16 | depth=1<<24.
    h[0] = _mm256_set1_epi32((int)(IV[0] ^ 0x01010020u));
    for (int i = 1; i < 8; ++i) h[i] = _mm256_set1_epi32((int)IV[i]);

    uint64_t chunks[8], min_interior = UINT64_MAX, max_chunks = 0;
    for (int l = 0; l < 8; ++l) {
        chunks[l] = lens[l] == 0 ? 1 : (lens[l] + 63) / 64;
        uint64_t interior = lens[l] == 0 ? 0 : (lens[l] - 1) / 64;
        if (interior < min_interior) min_interior = interior;
        if (chunks[l] > max_chunks) max_chunks = chunks[l];
    }

    // Fast path: every lane has a full, non-final chunk at index c, so t is
    // uniform and f0 = 0 — no per-lane bookkeeping, no masking.
    uint64_t c = 0;
    for (; c < min_interior; ++c) {
        const uint8_t *cp[8];
        for (int l = 0; l < 8; ++l) cp[l] = ptrs[l] + c * 64;
        uint64_t t = (c + 1) * 64;
        compress8(h, cp, _mm256_set1_epi32((int)(uint32_t)t),
                  _mm256_set1_epi32((int)(uint32_t)(t >> 32)),
                  _mm256_setzero_si256());
    }

    // Tail: lanes diverge (final/partial chunks, early finishers).
    alignas(32) uint8_t padbuf[8][64];
    static const uint8_t zeros[64] = {0};
    for (; c < max_chunks; ++c) {
        const uint8_t *cp[8];
        alignas(32) uint32_t tl[8], th[8], fl[8], act[8];
        for (int l = 0; l < 8; ++l) {
            if (c >= chunks[l]) {  // lane already finished: freeze its state
                cp[l] = zeros;
                tl[l] = th[l] = fl[l] = 0;
                act[l] = 0;
                continue;
            }
            act[l] = 0xFFFFFFFFu;
            uint64_t off = c * 64;
            uint64_t remain = lens[l] - off;
            bool final_chunk = (c == chunks[l] - 1);
            if (remain >= 64) {
                cp[l] = ptrs[l] + off;
            } else {
                memset(padbuf[l], 0, 64);
                if (remain) memcpy(padbuf[l], ptrs[l] + off, remain);
                cp[l] = padbuf[l];
            }
            uint64_t t = final_chunk ? lens[l] : off + 64;
            tl[l] = (uint32_t)t;
            th[l] = (uint32_t)(t >> 32);
            fl[l] = final_chunk ? 0xFFFFFFFFu : 0;
        }
        __m256i mask = _mm256_load_si256((const __m256i *)act);
        __m256i hold[8];
        for (int i = 0; i < 8; ++i) hold[i] = h[i];
        compress8(h, cp, _mm256_load_si256((const __m256i *)tl),
                  _mm256_load_si256((const __m256i *)th),
                  _mm256_load_si256((const __m256i *)fl));
        for (int i = 0; i < 8; ++i)
            h[i] = _mm256_blendv_epi8(hold[i], h[i], mask);
    }

    // Output: word-major state → per-lane 32-byte digests (one more 8x8
    // transpose, through memory — negligible vs the stream itself).
    alignas(32) uint32_t words[8][8];
    for (int i = 0; i < 8; ++i)
        _mm256_store_si256((__m256i *)words[i], h[i]);
    for (int l = 0; l < 8; ++l) {
        uint32_t d[8];
        for (int w = 0; w < 8; ++w) d[w] = words[w][l];
        memcpy(outs[l], d, 32);
    }
}

// ---------------------------------------------------------------------------
// 16-lane AVX-512 path.  Same lane-major design, double the width, and the
// ISA gives native 32-bit rotates (vprord) so the G function drops the
// shuffle-based rotate emulation entirely.
// ---------------------------------------------------------------------------

#define B2_TARGET512 __attribute__((target("avx512f,avx512bw")))

// Transpose 16 lanes × 16 consecutive uint32 (one 64-byte chunk per lane)
// into word-major vectors m[w]: lane l of m[w] = word w of stream l.
// Classic 4-stage 16x16: epi32 unpack, epi64 unpack, then two rounds of
// 128-bit block shuffles (shuffle_i32x4).
B2_TARGET512 inline void transpose16x16(const uint8_t *const ptrs[16],
                                        __m512i m[16]) {
    __m512i r[16], t[16], u[16];
    for (int l = 0; l < 16; ++l)
        r[l] = _mm512_loadu_si512((const void *)ptrs[l]);
    for (int i = 0; i < 8; ++i) {
        t[2 * i] = _mm512_unpacklo_epi32(r[2 * i], r[2 * i + 1]);
        t[2 * i + 1] = _mm512_unpackhi_epi32(r[2 * i], r[2 * i + 1]);
    }
    for (int i = 0; i < 4; ++i) {
        u[4 * i + 0] = _mm512_unpacklo_epi64(t[4 * i + 0], t[4 * i + 2]);
        u[4 * i + 1] = _mm512_unpackhi_epi64(t[4 * i + 0], t[4 * i + 2]);
        u[4 * i + 2] = _mm512_unpacklo_epi64(t[4 * i + 1], t[4 * i + 3]);
        u[4 * i + 3] = _mm512_unpackhi_epi64(t[4 * i + 1], t[4 * i + 3]);
    }
    // u[g*4+k] now holds, for the 4 streams of group g (lanes 4g..4g+3),
    // words {k of sub-block j} across its four 128-bit sub-blocks j.
    // Gather equal 128-bit sub-blocks across groups:
    __m512i v[16];
    for (int k = 0; k < 4; ++k) {
        v[k + 0] = _mm512_shuffle_i32x4(u[k], u[4 + k], 0x88);      // j=0,2
        v[k + 4] = _mm512_shuffle_i32x4(u[8 + k], u[12 + k], 0x88); // j=0,2
        v[k + 8] = _mm512_shuffle_i32x4(u[k], u[4 + k], 0xDD);      // j=1,3
        v[k + 12] = _mm512_shuffle_i32x4(u[8 + k], u[12 + k], 0xDD);
    }
    for (int k = 0; k < 4; ++k) {
        m[k + 0] = _mm512_shuffle_i32x4(v[k + 0], v[k + 4], 0x88);   // j=0
        m[k + 8] = _mm512_shuffle_i32x4(v[k + 0], v[k + 4], 0xDD);   // j=2
        m[k + 4] = _mm512_shuffle_i32x4(v[k + 8], v[k + 12], 0x88);  // j=1
        m[k + 12] = _mm512_shuffle_i32x4(v[k + 8], v[k + 12], 0xDD); // j=3
    }
}

#define G16(r, i, a, b, c, d)                                  \
    do {                                                       \
        a = _mm512_add_epi32(_mm512_add_epi32(a, b),           \
                             m[SIGMA[r][2 * (i)]]);            \
        d = _mm512_ror_epi32(_mm512_xor_si512(d, a), 16);      \
        c = _mm512_add_epi32(c, d);                            \
        b = _mm512_ror_epi32(_mm512_xor_si512(b, c), 12);      \
        a = _mm512_add_epi32(_mm512_add_epi32(a, b),           \
                             m[SIGMA[r][2 * (i) + 1]]);        \
        d = _mm512_ror_epi32(_mm512_xor_si512(d, a), 8);       \
        c = _mm512_add_epi32(c, d);                            \
        b = _mm512_ror_epi32(_mm512_xor_si512(b, c), 7);       \
    } while (0)

B2_TARGET512 inline void compress16(__m512i h[8],
                                    const uint8_t *const chunk[16],
                                    __m512i t_lo, __m512i t_hi, __m512i f0) {
    __m512i m[16];
    transpose16x16(chunk, m);
    __m512i v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
    __m512i v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
    __m512i v8 = _mm512_set1_epi32((int)IV[0]);
    __m512i v9 = _mm512_set1_epi32((int)IV[1]);
    __m512i v10 = _mm512_set1_epi32((int)IV[2]);
    __m512i v11 = _mm512_set1_epi32((int)IV[3]);
    __m512i v12 = _mm512_xor_si512(_mm512_set1_epi32((int)IV[4]), t_lo);
    __m512i v13 = _mm512_xor_si512(_mm512_set1_epi32((int)IV[5]), t_hi);
    __m512i v14 = _mm512_xor_si512(_mm512_set1_epi32((int)IV[6]), f0);
    __m512i v15 = _mm512_set1_epi32((int)IV[7]);
    for (int r = 0; r < 10; ++r) {
        G16(r, 0, v0, v4, v8, v12);
        G16(r, 1, v1, v5, v9, v13);
        G16(r, 2, v2, v6, v10, v14);
        G16(r, 3, v3, v7, v11, v15);
        G16(r, 4, v0, v5, v10, v15);
        G16(r, 5, v1, v6, v11, v12);
        G16(r, 6, v2, v7, v8, v13);
        G16(r, 7, v3, v4, v9, v14);
    }
    h[0] = _mm512_xor_si512(h[0], _mm512_xor_si512(v0, v8));
    h[1] = _mm512_xor_si512(h[1], _mm512_xor_si512(v1, v9));
    h[2] = _mm512_xor_si512(h[2], _mm512_xor_si512(v2, v10));
    h[3] = _mm512_xor_si512(h[3], _mm512_xor_si512(v3, v11));
    h[4] = _mm512_xor_si512(h[4], _mm512_xor_si512(v4, v12));
    h[5] = _mm512_xor_si512(h[5], _mm512_xor_si512(v5, v13));
    h[6] = _mm512_xor_si512(h[6], _mm512_xor_si512(v6, v14));
    h[7] = _mm512_xor_si512(h[7], _mm512_xor_si512(v7, v15));
}

B2_TARGET512 void hash16(const uint8_t *const ptrs[16],
                         const uint64_t lens[16], uint8_t *const outs[16]) {
    __m512i h[8];
    h[0] = _mm512_set1_epi32((int)(IV[0] ^ 0x01010020u));
    for (int i = 1; i < 8; ++i) h[i] = _mm512_set1_epi32((int)IV[i]);

    uint64_t chunks[16], min_interior = UINT64_MAX, max_chunks = 0;
    for (int l = 0; l < 16; ++l) {
        chunks[l] = lens[l] == 0 ? 1 : (lens[l] + 63) / 64;
        uint64_t interior = lens[l] == 0 ? 0 : (lens[l] - 1) / 64;
        if (interior < min_interior) min_interior = interior;
        if (chunks[l] > max_chunks) max_chunks = chunks[l];
    }

    uint64_t c = 0;
    for (; c < min_interior; ++c) {
        const uint8_t *cp[16];
        for (int l = 0; l < 16; ++l) cp[l] = ptrs[l] + c * 64;
        uint64_t t = (c + 1) * 64;
        compress16(h, cp, _mm512_set1_epi32((int)(uint32_t)t),
                   _mm512_set1_epi32((int)(uint32_t)(t >> 32)),
                   _mm512_setzero_si512());
    }

    alignas(64) uint8_t padbuf[16][64];
    static const uint8_t zeros[64] = {0};
    for (; c < max_chunks; ++c) {
        const uint8_t *cp[16];
        alignas(64) uint32_t tl[16], th[16], fl[16];
        uint16_t act = 0;
        for (int l = 0; l < 16; ++l) {
            if (c >= chunks[l]) {
                cp[l] = zeros;
                tl[l] = th[l] = fl[l] = 0;
                continue;
            }
            act |= (uint16_t)(1u << l);
            uint64_t off = c * 64;
            uint64_t remain = lens[l] - off;
            bool final_chunk = (c == chunks[l] - 1);
            if (remain >= 64) {
                cp[l] = ptrs[l] + off;
            } else {
                memset(padbuf[l], 0, 64);
                if (remain) memcpy(padbuf[l], ptrs[l] + off, remain);
                cp[l] = padbuf[l];
            }
            uint64_t t = final_chunk ? lens[l] : off + 64;
            tl[l] = (uint32_t)t;
            th[l] = (uint32_t)(t >> 32);
            fl[l] = final_chunk ? 0xFFFFFFFFu : 0;
        }
        __m512i hold[8];
        for (int i = 0; i < 8; ++i) hold[i] = h[i];
        compress16(h, cp, _mm512_load_si512((const void *)tl),
                   _mm512_load_si512((const void *)th),
                   _mm512_load_si512((const void *)fl));
        for (int i = 0; i < 8; ++i)  // finished lanes keep frozen state
            h[i] = _mm512_mask_blend_epi32((__mmask16)act, hold[i], h[i]);
    }

    alignas(64) uint32_t words[8][16];
    for (int i = 0; i < 8; ++i)
        _mm512_store_si512((void *)words[i], h[i]);
    for (int l = 0; l < 16; ++l) {
        uint32_t d[8];
        for (int w = 0; w < 8; ++w) d[w] = words[w][l];
        memcpy(outs[l], d, 32);
    }
}

B2_TARGET512 void multi16(const uint8_t *const *ptrs, const uint64_t *lens,
                          uint8_t *out, int64_t n) {
    for (int64_t i = 0; i < n; i += 16) {
        const uint8_t *p[16];
        uint64_t L[16];
        uint8_t *o[16];
        uint8_t scratch[16][32];
        int64_t last = (i + 15 < n ? i + 15 : n - 1);
        for (int l = 0; l < 16; ++l) {
            int64_t j = i + l;
            if (j < n) {
                p[l] = ptrs[j];
                L[l] = lens[j];
                o[l] = out + j * 32;
            } else {  // pad lane: replay the last real stream (see multi8)
                p[l] = ptrs[last];
                L[l] = lens[last];
                o[l] = scratch[l];
            }
        }
        hash16(p, L, o);
    }
}

B2_TARGET void multi8(const uint8_t *const *ptrs, const uint64_t *lens,
                      uint8_t *out, int64_t n) {
    for (int64_t i = 0; i < n; i += 8) {
        const uint8_t *p[8];
        uint64_t L[8];
        uint8_t *o[8];
        uint8_t scratch[8][32];
        int64_t last = (i + 7 < n ? i + 7 : n - 1);
        for (int l = 0; l < 8; ++l) {
            int64_t j = i + l;
            if (j < n) {
                p[l] = ptrs[j];
                L[l] = lens[j];
                o[l] = out + j * 32;
            } else {
                // Pad lane: REPLAY the group's last real stream and discard
                // the digest.  An empty-string pad (len 0) would pull
                // min_interior to 0 and push the whole group — which the
                // caller's ascending length sort fills with the LONGEST
                // blocks — onto the masked per-lane tail path for every
                // chunk; replaying a real lane keeps the uniform fast loop
                // at zero extra compress cost.
                p[l] = ptrs[last];
                L[l] = lens[last];
                o[l] = scratch[l];
            }
        }
        hash8(p, L, o);
    }
}

}  // namespace

// Runtime support probe: the Python wrapper must call this before using
// blake2s256_multi and treat 0 as "kernel unavailable" (hashlib fallback).
// Returns the SIMD lane count (16 = AVX-512, 8 = AVX2); callers need only
// truthiness — blake2s256_multi dispatches on width internally.
extern "C" int blake2s_mb_supported() {
    if (__builtin_cpu_supports("avx512f") &&
        __builtin_cpu_supports("avx512bw"))
        return 16;
    return __builtin_cpu_supports("avx2") ? 8 : 0;
}

extern "C" void blake2s256_multi(const uint8_t *const *ptrs,
                                 const uint64_t *lens, uint8_t *out,
                                 int64_t n) {
    static const int lanes = blake2s_mb_supported();
    if (lanes == 16 && n > 8)
        multi16(ptrs, lens, out, n);
    else
        multi8(ptrs, lens, out, n);
}
