// Batched BLAKE2s-256 for Hopper (sm_90a): one thread per message.
//
// Replaces the Pallas kernel `_kernel` / `blake2s_words_pallas` in
// garage_tpu/ops/pallas_blake2s.py (wrapper `blake2s_batch_pallas`).
//
// Semantics (RFC 7693, unkeyed, 32-byte digest): B messages, each
// zero-padded to row_bytes (a multiple of 64) and carrying its own byte
// length.  Message b hashes chunks j = 0 .. max(1, ceil(len/64)) - 1 with
// counter t = min(64 (j+1), len) and the final flag on its last chunk; a
// zero-length message hashes one all-zero chunk with t = 0, f = 1.
// Output: (B, 8) uint32 digest words in little-endian word order.
//
// Bound on the H100: BLAKE2s is sequential within a message, so the only
// parallel axis is across messages, one thread each.  Per 64-byte chunk a
// thread issues at least 970 32-bit instructions (12 per G with
// three-input adds), so a batch is bound by the SMs' issue rate when
// every SM is busy (moving the bytes takes ~1.5x less).  At the
// scrub's 256 messages only 8 warps exist on 132 SMs: the kernel then runs
// at a few percent of that bound, limited by one warp's dependent
// instruction chain (chain_probe_kernel below measures its latency), and
// no layout change fixes that short of splitting messages (a tree mode,
// which would change the hash).  What the design
// does about the rest: the 8 state and 16 working words stay in
// registers across all chunks (the Pallas kernel's VMEM-resident state),
// all 10 rounds x 8 G are unrolled with the message schedule resolved at
// compile time, rotates are single funnel shifts, and the next chunk's
// 64 bytes are loaded (4 x 16-byte loads) while the current chunk
// compresses, hiding the load latency that one warp per SM cannot.
// Bytes are read in the staged (B, C*64) layout: the word-major transpose
// of pallas_blake2s.py:171 served the TPU's (8, 128) lane tiles; here a
// transpose would cost a full extra pass over the batch, while the
// per-thread 16-byte loads of a row are full 32-byte sectors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define B2S_G(a, b, c, d, x, y) \
  do {                          \
    a = a + b + (x);            \
    d = rotr32(d ^ a, 16);      \
    c = c + d;                  \
    b = rotr32(b ^ c, 12);      \
    a = a + b + (y);            \
    d = rotr32(d ^ a, 8);       \
    c = c + d;                  \
    b = rotr32(b ^ c, 7);       \
  } while (0)

#define B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                                                               \
    B2S_G(v0, v4, v8, v12, m[s0], m[s1]);                                            \
    B2S_G(v1, v5, v9, v13, m[s2], m[s3]);                                            \
    B2S_G(v2, v6, v10, v14, m[s4], m[s5]);                                           \
    B2S_G(v3, v7, v11, v15, m[s6], m[s7]);                                           \
    B2S_G(v0, v5, v10, v15, m[s8], m[s9]);                                           \
    B2S_G(v1, v6, v11, v12, m[s10], m[s11]);                                         \
    B2S_G(v2, v7, v8, v13, m[s12], m[s13]);                                          \
    B2S_G(v3, v4, v9, v14, m[s14], m[s15]);                                          \
  } while (0)

constexpr uint32_t kIV0 = 0x6A09E667u, kIV1 = 0xBB67AE85u, kIV2 = 0x3C6EF372u,
                   kIV3 = 0xA54FF53Au, kIV4 = 0x510E527Fu, kIV5 = 0x9B05688Cu,
                   kIV6 = 0x1F83D9ABu, kIV7 = 0x5BE0CD19u;

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint32_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint32_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = kIV0, v9 = kIV1, v10 = kIV2, v11 = kIV3;
  uint32_t v12 = kIV4 ^ t, v13 = kIV5, v14 = last ? ~kIV6 : kIV6, v15 = kIV7;
  B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

__device__ __forceinline__ void unpack(const uint4 q[4], uint32_t m[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[4 * i + 0] = q[i].x;
    m[4 * i + 1] = q[i].y;
    m[4 * i + 2] = q[i].z;
    m[4 * i + 3] = q[i].w;
  }
}

__global__ void blake2s_kernel(const uint8_t* __restrict__ data,
                               const int32_t* __restrict__ lengths,
                               uint32_t* __restrict__ out, int64_t nmsg,
                               int64_t row_bytes) {
  const int64_t lane = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= nmsg) return;
  const uint32_t len = uint32_t(lengths[lane]);
  uint32_t nch = (len + 63u) / 64u;
  if (nch == 0) nch = 1;
  // a length past the row hashes the row's chunks without finalising,
  // as the reference scan does; never read beyond the row
  const uint32_t rowch = uint32_t(row_bytes / 64);
  const uint32_t steps = nch < rowch ? nch : rowch;
  const uint4* row = reinterpret_cast<const uint4*>(data + lane * row_bytes);

  uint32_t h[8] = {kIV0 ^ 0x01010020u, kIV1, kIV2, kIV3,
                   kIV4, kIV5, kIV6, kIV7};
  uint4 cur[4], nxt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cur[i] = __ldg(row + i);
  for (uint32_t j = 0; j < steps; ++j) {
    const bool last = (j + 1 == nch);
    if (j + 1 < steps) {
#pragma unroll
      for (int i = 0; i < 4; ++i) nxt[i] = __ldg(row + 4 * (j + 1) + i);
    }
    uint32_t m[16];
    unpack(cur, m);
    const uint32_t tend = 64u * (j + 1);
    compress(h, m, tend < len ? tend : len, last);
    if (j + 1 < steps) {
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    }
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[lane * 8 + w] = h[w];
}

// The latency behind the kernel's dependency bound, measured: one warp
// runs `ng` G's back to back on one state, each G's first add waiting on
// the last rotate of the G before, so the ng x 12 instructions are one
// dependent chain of the kernel's own instruction mix.  Thread 0 writes
// the SM clock cycles the chain took; every thread writes its state so
// that none of the chain is dead code.
__global__ void chain_probe_kernel(const uint32_t* __restrict__ seed,
                                   uint32_t* __restrict__ out,
                                   long long* __restrict__ cycles, int ng) {
  const uint32_t* s = seed + 6 * threadIdx.x;
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  const uint32_t x = s[4], y = s[5];
  const long long t0 = clock64();
#pragma unroll 16
  for (int j = 0; j < ng; ++j) B2S_G(a, b, c, d, x, y);
  const long long t1 = clock64();
  out[threadIdx.x] = a ^ b ^ c ^ d;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

}  // namespace

// Launches the kernel on `stream` without synchronising; returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int blake2s_launch(const void* data, const void* lengths, void* out,
                              int64_t nmsg, int64_t row_bytes, int threads,
                              void* stream) {
  if (nmsg <= 0) return 0;
  const int64_t blocks = (nmsg + threads - 1) / threads;
  blake2s_kernel<<<dim3(unsigned(blocks)), dim3(threads), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<uint32_t*>(out), nmsg, row_bytes);
  return int(cudaGetLastError());
}

// seed (32 x 6) u32, out (32,) u32, cycles (1,) i64 on the device: one
// warp of chain_probe_kernel over `ng` G's, on `stream` without
// synchronising; returns the cudaError_t of the launch.
extern "C" int blake2s_chain_probe_launch(const void* seed, void* out,
                                          void* cycles, int ng, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(seed), static_cast<uint32_t*>(out),
      static_cast<long long*>(cycles), ng);
  return int(cudaGetLastError());
}
