// Native GF(2^8) Reed-Solomon kernel — CPU baseline of the BlockCodec.
//
// Equivalent role to the reference's native Rust block-codec path
// (ref src/block/block.rs DataBlock verify/encode run at native speed);
// the device build keeps a native CPU floor beside the GPU kernels.
//
// Strategy: per (row, col) of the small GF matrix, precompute the 256-entry
// product table; the inner loop is then a table-lookup-XOR sweep over the
// shard bytes, parallelized over batch with OpenMP.  Field: poly 0x11D.
//
// Build: garage_tpu_torch/ops/native.py compiles it into build/native/ at
// first use and loads it via ctypes; python falls back to numpy if absent.

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

static uint8_t GF_EXP[512];
static int16_t GF_LOG[256];

static void init_tables() {
  static bool done = false;
  if (done) return;
  int x = 1;
  for (int i = 0; i < 255; i++) {
    GF_EXP[i] = (uint8_t)x;
    GF_LOG[x] = (int16_t)i;
    x <<= 1;
    if (x & 0x100) x ^= 0x11D;
  }
  for (int i = 255; i < 510; i++) GF_EXP[i] = GF_EXP[i - 255];
  GF_LOG[0] = 0;
  done = true;
}

static inline uint8_t gf_mul(uint8_t a, uint8_t b) {
  if (a == 0 || b == 0) return 0;
  return GF_EXP[GF_LOG[a] + GF_LOG[b]];
}

#if defined(__x86_64__)
// --- AVX2 split-nibble path (the ISA-L technique) -------------------------
//
// gfmul(c, x) = T_lo[x & 0xF] ^ T_hi[x >> 4] where T_lo[v] = gfmul(c, v)
// and T_hi[v] = gfmul(c, v<<4) — each table is 16 bytes, exactly one
// VPSHUFB operand.  32 input bytes per two shuffles + ors/xors; the
// column-chunked loop keeps the k source rows of the active chunk in L1
// while every output row consumes them.

__attribute__((target("avx2"))) static void gf_matmul_avx2(
    const uint8_t* mat, const uint8_t* nib_tables, const uint8_t* shards,
    uint8_t* out, int64_t batch, int64_t r, int64_t k, int64_t s) {
  const __m256i lo_mask = _mm256_set1_epi8(0x0F);
  int64_t svec = s & ~int64_t(31);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* in_b = shards + b * k * s;
    uint8_t* out_b = out + b * r * s;
    // column-vector outer loop: each output row accumulates in ONE ymm
    // register across all k inputs, stored once — dst carries no
    // read-modify-write traffic (`out` is zero-initialized by contract,
    // so the accumulator starts empty)
    for (int64_t v = 0; v < svec; v += 32) {
      for (int64_t i = 0; i < r; i++) {
        __m256i acc = _mm256_setzero_si256();
        for (int64_t j = 0; j < k; j++) {
          uint8_t coef = mat[i * k + j];
          if (coef == 0) continue;
          __m256i x =
              _mm256_loadu_si256((const __m256i*)(in_b + j * s + v));
          if (coef == 1) {
            acc = _mm256_xor_si256(acc, x);
            continue;
          }
          const uint8_t* nt = nib_tables + (i * k + j) * 32;
          __m256i tlo = _mm256_broadcastsi128_si256(
              _mm_loadu_si128((const __m128i*)nt));
          __m256i thi = _mm256_broadcastsi128_si256(
              _mm_loadu_si128((const __m128i*)(nt + 16)));
          __m256i xl = _mm256_and_si256(x, lo_mask);
          __m256i xh = _mm256_and_si256(_mm256_srli_epi16(x, 4), lo_mask);
          acc = _mm256_xor_si256(
              acc, _mm256_xor_si256(_mm256_shuffle_epi8(tlo, xl),
                                    _mm256_shuffle_epi8(thi, xh)));
        }
        _mm256_storeu_si256((__m256i*)(out_b + i * s + v), acc);
      }
    }
    // scalar tail for the last s % 32 columns
    for (int64_t v = svec; v < s; v++) {
      for (int64_t i = 0; i < r; i++) {
        uint8_t acc = 0;
        for (int64_t j = 0; j < k; j++) {
          if (mat[i * k + j] == 0) continue;
          const uint8_t* nt = nib_tables + (i * k + j) * 32;
          uint8_t x = in_b[j * s + v];
          acc ^= (uint8_t)(nt[x & 0x0F] ^ nt[16 + (x >> 4)]);
        }
        out_b[i * s + v] = acc;
      }
    }
  }
}

static bool have_avx2() {
  return __builtin_cpu_supports("avx2");
}

// --- GFNI + AVX512 path ----------------------------------------------------
//
// Multiplication by a constant c in GF(2^8) is GF(2)-linear, so it is one
// 8x8 bit matrix — exactly what VGF2P8AFFINEQB applies to 64 bytes per
// instruction.  The instruction is polynomial-agnostic (it is a bit-matrix
// product; only GF2P8MULB hardwires 0x11B), so it serves our 0x11D field
// directly: 1 load + 1 affine + 1 xor per 64 bytes per coefficient,
// vs ~6 ops per 32 bytes on the AVX2 split-nibble path.

// Pack multiply-by-c as the VGF2P8AFFINEQB matrix operand:
// dst.bit[i] = parity(A.byte[7-i] AND x), so A.byte[7-i] must hold row i
// of the bit matrix M where M[i][k] = bit i of (c * x^k mod 0x11D).
static uint64_t gf_affine_matrix(uint8_t c) {
  uint8_t col[8];
  for (int k = 0; k < 8; k++) col[k] = gf_mul(c, (uint8_t)(1 << k));
  uint64_t A = 0;
  for (int b = 0; b < 8; b++) {
    int i = 7 - b;
    uint8_t row = 0;
    for (int k = 0; k < 8; k++) row |= (uint8_t)(((col[k] >> i) & 1) << k);
    A |= (uint64_t)row << (8 * b);
  }
  return A;
}

// Register-blocking cap: preloading each 64-byte input column ONCE and
// keeping all k lanes live in zmm registers cuts loads r-fold (the
// column was re-read per output row).  k ≤ 16 covers every supported RS
// geometry with registers to spare (16 inputs + r accumulators < 32
// zmm); larger k falls back to the unblocked loop.
//
// NOTE the per-row accumulate (coef==0 skip / coef==1 xor / affine)
// appears FOUR times below — blocked+fallback in both the packed and
// the ptrs kernel.  Deliberate: the fallbacks are the pre-blocking
// loops kept verbatim, and templating target-attributed functions
// risks codegen drift.  A change to the GF math must touch all four.
#define GF_KMAX 16

__attribute__((target("gfni,avx512f,avx512bw"))) static void gf_matmul_gfni(
    const uint8_t* mat, const uint64_t* affine, const uint8_t* shards,
    uint8_t* out, int64_t batch, int64_t r, int64_t k, int64_t s) {
  int64_t svec = s & ~int64_t(63);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* in_b = shards + b * k * s;
    uint8_t* out_b = out + b * r * s;
    if (k <= GF_KMAX) {
      for (int64_t v = 0; v < svec; v += 64) {
        __m512i x[GF_KMAX];
        for (int64_t j = 0; j < k; j++)
          x[j] = _mm512_loadu_si512((const void*)(in_b + j * s + v));
        for (int64_t i = 0; i < r; i++) {
          __m512i acc = _mm512_setzero_si512();
          for (int64_t j = 0; j < k; j++) {
            uint8_t coef = mat[i * k + j];
            if (coef == 0) continue;
            if (coef == 1) {
              acc = _mm512_xor_si512(acc, x[j]);
              continue;
            }
            __m512i A = _mm512_set1_epi64((long long)affine[i * k + j]);
            acc = _mm512_xor_si512(
                acc, _mm512_gf2p8affine_epi64_epi8(x[j], A, 0));
          }
          _mm512_storeu_si512((void*)(out_b + i * s + v), acc);
        }
      }
    } else {
      for (int64_t v = 0; v < svec; v += 64) {
        for (int64_t i = 0; i < r; i++) {
          __m512i acc = _mm512_setzero_si512();
          for (int64_t j = 0; j < k; j++) {
            uint8_t coef = mat[i * k + j];
            if (coef == 0) continue;
            __m512i x = _mm512_loadu_si512((const void*)(in_b + j * s + v));
            if (coef == 1) {
              acc = _mm512_xor_si512(acc, x);
              continue;
            }
            __m512i A = _mm512_set1_epi64((long long)affine[i * k + j]);
            acc = _mm512_xor_si512(acc,
                                   _mm512_gf2p8affine_epi64_epi8(x, A, 0));
          }
          _mm512_storeu_si512((void*)(out_b + i * s + v), acc);
        }
      }
    }
    for (int64_t v = svec; v < s; v++) {
      for (int64_t i = 0; i < r; i++) {
        uint8_t acc = 0;
        for (int64_t j = 0; j < k; j++) {
          uint8_t coef = mat[i * k + j];
          if (coef == 0) continue;
          acc ^= gf_mul(coef, in_b[j * s + v]);
        }
        out_b[i * s + v] = acc;
      }
    }
  }
}

static bool have_gfni512() {
  return __builtin_cpu_supports("gfni") &&
         __builtin_cpu_supports("avx512f") &&
         __builtin_cpu_supports("avx512bw");
}

// Pointer-gather variant: shard (b, j) is its own buffer ptrs[b*k+j] of
// lens[b*k+j] bytes, zero-extended to the codeword width s.  This is the
// scrub/put encode hot path — blocks arrive as separate Python bytes
// objects, and packing them into one (B, k, S) array first costs a full
// extra pass over the data (measured: the pack memcpy alone was slower
// than the GFNI encode it fed).  Masked AVX512 loads zero-extend the
// ragged tails for free.
__attribute__((target("gfni,avx512f,avx512bw"))) static void gf_matmul_ptrs_gfni(
    const uint8_t* mat, const uint64_t* affine, const uint8_t* const* ptrs,
    const uint64_t* lens, uint8_t* out, int64_t B, int64_t r, int64_t k,
    int64_t s) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; b++) {
    const uint8_t* const* in_p = ptrs + b * k;
    const uint64_t* in_l = lens + b * k;
    uint8_t* out_b = out + b * r * s;
    for (int64_t v = 0; v < s; v += 64) {
      int64_t w = s - v < 64 ? s - v : 64;
      __mmask64 outmask =
          w == 64 ? ~(__mmask64)0 : ((((__mmask64)1) << w) - 1);
      if (k <= GF_KMAX) {
        // register-blocked: each (masked) input column loaded once,
        // reused across all r output rows
        __m512i x[GF_KMAX];
        bool zero[GF_KMAX];
        for (int64_t j = 0; j < k; j++) {
          uint64_t len = in_l[j];
          if ((uint64_t)v >= len) {  // zero-extended region
            zero[j] = true;
            continue;
          }
          zero[j] = false;
          uint64_t avail = len - (uint64_t)v;
          x[j] = avail >= 64
                     ? _mm512_loadu_si512((const void*)(in_p[j] + v))
                     : _mm512_maskz_loadu_epi8(
                           ((((__mmask64)1) << avail) - 1),
                           (const void*)(in_p[j] + v));
        }
        for (int64_t i = 0; i < r; i++) {
          __m512i acc = _mm512_setzero_si512();
          for (int64_t j = 0; j < k; j++) {
            uint8_t coef = mat[i * k + j];
            if (coef == 0 || zero[j]) continue;
            if (coef == 1) {
              acc = _mm512_xor_si512(acc, x[j]);
            } else {
              __m512i A = _mm512_set1_epi64((long long)affine[i * k + j]);
              acc = _mm512_xor_si512(
                  acc, _mm512_gf2p8affine_epi64_epi8(x[j], A, 0));
            }
          }
          _mm512_mask_storeu_epi8((void*)(out_b + i * s + v), outmask, acc);
        }
        continue;
      }
      for (int64_t i = 0; i < r; i++) {
        __m512i acc = _mm512_setzero_si512();
        for (int64_t j = 0; j < k; j++) {
          uint8_t coef = mat[i * k + j];
          if (coef == 0) continue;
          uint64_t len = in_l[j];
          if ((uint64_t)v >= len) continue;  // zero-extended region
          uint64_t avail = len - (uint64_t)v;
          __m512i x;
          if (avail >= 64) {
            x = _mm512_loadu_si512((const void*)(in_p[j] + v));
          } else {
            x = _mm512_maskz_loadu_epi8(((((__mmask64)1) << avail) - 1),
                                        (const void*)(in_p[j] + v));
          }
          if (coef == 1) {
            acc = _mm512_xor_si512(acc, x);
          } else {
            __m512i A = _mm512_set1_epi64((long long)affine[i * k + j]);
            acc = _mm512_xor_si512(acc,
                                   _mm512_gf2p8affine_epi64_epi8(x, A, 0));
          }
        }
        _mm512_mask_storeu_epi8((void*)(out_b + i * s + v), outmask, acc);
      }
    }
  }
}
#endif  // __x86_64__

extern "C" {

// out (B, r, S) = mat (r, k) * shards (B, k, S) over GF(2^8).
// `out` MUST be zero-initialized by the caller — under that contract the
// scalar path (which XOR-accumulates into out) and the AVX2 path (which
// overwrites it) are equivalent; passing a pre-populated buffer is NOT
// supported and would give machine-dependent results.
void gf_matmul_blocks(const uint8_t* mat, const uint8_t* shards, uint8_t* out,
                      int64_t batch, int64_t r, int64_t k, int64_t s) {
  init_tables();
#if defined(__x86_64__)
  if (have_gfni512()) {
    uint64_t* affine = new uint64_t[r * k];
    for (int64_t i = 0; i < r * k; i++) affine[i] = gf_affine_matrix(mat[i]);
    gf_matmul_gfni(mat, affine, shards, out, batch, r, k, s);
    delete[] affine;
    return;
  }
  if (have_avx2()) {
    // per-(i,j) nibble tables: 16 low-nibble products + 16 high-nibble
    // products (the two VPSHUFB operands)
    uint8_t* nib = new uint8_t[r * k * 32];
    for (int64_t i = 0; i < r; i++) {
      for (int64_t j = 0; j < k; j++) {
        uint8_t c = mat[i * k + j];
        uint8_t* t = nib + (i * k + j) * 32;
        for (int v = 0; v < 16; v++) {
          t[v] = gf_mul(c, (uint8_t)v);
          t[16 + v] = gf_mul(c, (uint8_t)(v << 4));
        }
      }
    }
    gf_matmul_avx2(mat, nib, shards, out, batch, r, k, s);
    delete[] nib;
    return;
  }
#endif
  // Precompute per-(i,j) multiplication tables: r*k*256 bytes.
  uint8_t* tables = new uint8_t[r * k * 256];
  for (int64_t i = 0; i < r; i++) {
    for (int64_t j = 0; j < k; j++) {
      uint8_t c = mat[i * k + j];
      uint8_t* t = tables + (i * k + j) * 256;
      if (c == 0) {
        memset(t, 0, 256);
      } else {
        int16_t lc = GF_LOG[c];
        t[0] = 0;
        for (int v = 1; v < 256; v++) t[v] = GF_EXP[lc + GF_LOG[v]];
      }
    }
  }
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* in_b = shards + b * k * s;
    uint8_t* out_b = out + b * r * s;
    for (int64_t i = 0; i < r; i++) {
      uint8_t* dst = out_b + i * s;
      for (int64_t j = 0; j < k; j++) {
        const uint8_t* t = tables + (i * k + j) * 256;
        const uint8_t* src = in_b + j * s;
        if (mat[i * k + j] == 0) continue;
        if (mat[i * k + j] == 1) {
          for (int64_t v = 0; v < s; v++) dst[v] ^= src[v];
        } else {
          for (int64_t v = 0; v < s; v++) dst[v] ^= t[src[v]];
        }
      }
    }
  }
  delete[] tables;
}

// Fast pointer-gather support probe: the Python wrapper only routes the
// per-buffer path here when the GFNI kernel backs it (the scalar fallback
// below exists for correctness on old hosts, but packing + the AVX2 block
// kernel is faster there).
int gf_ptrs_fast() {
#if defined(__x86_64__)
  return have_gfni512() ? 1 : 0;
#else
  return 0;
#endif
}

// out (B, r, S) = mat (r, k) applied to B codewords of k separate,
// zero-extended buffers.  Same zero-initialized-out contract as
// gf_matmul_blocks.
void gf_matmul_ptrs(const uint8_t* mat, const uint8_t* const* ptrs,
                    const uint64_t* lens, uint8_t* out, int64_t B, int64_t r,
                    int64_t k, int64_t s) {
  init_tables();
#if defined(__x86_64__)
  if (have_gfni512()) {
    uint64_t* affine = new uint64_t[r * k];
    for (int64_t i = 0; i < r * k; i++) affine[i] = gf_affine_matrix(mat[i]);
    gf_matmul_ptrs_gfni(mat, affine, ptrs, lens, out, B, r, k, s);
    delete[] affine;
    return;
  }
#endif
  for (int64_t b = 0; b < B; b++) {
    const uint8_t* const* in_p = ptrs + b * k;
    const uint64_t* in_l = lens + b * k;
    uint8_t* out_b = out + b * r * s;
    for (int64_t i = 0; i < r; i++) {
      uint8_t* dst = out_b + i * s;
      for (int64_t j = 0; j < k; j++) {
        uint8_t coef = mat[i * k + j];
        if (coef == 0) continue;
        int64_t n = (int64_t)in_l[j] < s ? (int64_t)in_l[j] : s;
        const uint8_t* src = in_p[j];
        if (coef == 1) {
          for (int64_t v = 0; v < n; v++) dst[v] ^= src[v];
        } else {
          int16_t lc = GF_LOG[coef];
          for (int64_t v = 0; v < n; v++)
            if (src[v]) dst[v] ^= GF_EXP[lc + GF_LOG[src[v]]];
        }
      }
    }
  }
}

}  // extern "C"
