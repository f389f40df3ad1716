// GF(2^8)/0x11D matrix apply over codeword slabs for Hopper (sm_90a).
//
// Replaces both dispatch regimes of the Pallas GF kernel in
// garage_tpu/ops/pallas_gf.py: `_kernel_batched` (:116) via
// `_apply_batched` (:135) for wide shards, and `_kernel` (:60) via
// `_apply_flat` (:98) for narrow shards with the batch folded into the
// column axis.  One kernel indexes (codeword, column) directly, so wide
// and narrow shards both fill the grid with no fold or column padding.
//
// Math (bit-identical to pallas_gf.reference_apply):
//   out[c, p] = XOR_{i<k, b<8} mask(x[c, i], b) & (K[p, i, b] * 0x01010101)
// with K[p, i, b] = gfmul(M[p, i], 2^b) < 256, the scalar constants the
// wrapper hands over, byte-replicated here as they are staged, and
// mask(v, b) = 0xFF in each byte of v whose bit b is set.  The mask is
// one PRMT in sign-replicate mode (selector 0xBA98) of v << (7 - b),
// which puts bit b of every byte in that byte's top bit; the accumulate
// acc ^= mask & Krep is one three-input LOP3.
//
// Bound on the H100.  Per 4-byte column the function reads 4k and writes
// 4r bytes, the HBM side: 0.120 ms at the scrub's (32, 8, 262144) RS(8,4)
// encode.  The issue side: this form needs, per (i, b), one shift (an
// IMAD.SHL on the FMA pipe, which the compiler is free to pick), one PRMT
// and r LOP3s (only the integer ALU pipe runs these), so 8k (1 + r) ALU
// instructions per column, 320 at RS(8,4): the ALU pipe takes 64 lanes per
// SM per clock (chip_smoke.py checks the rate from this kernel's SASS
// census: ~57 lanes issued at RS(8,4) and RS(8,8) on an H100), so the
// issue side comes to ~0.16 ms at the scrub shape, above the bytes, and is
// what bounds the kernel.  Of the mask forms, m1 * 0xFF and (m1 << 8) - m1
// each cost an ALU instruction for m1 = (x >> b) & 0x01010101 and more
// besides; the PRMT costs one ALU instruction and the shift goes to the
// FMA pipe.  The design therefore spends its effort on the instruction
// count:
//   - (K, R) are template parameters for every shape the port launches
//     (GF_APPLY_INSTANTIATIONS below), so every loop is unrolled, every
//     constant offset is known at compile time, and no output lane is
//     predicated off.  Any other (k, r) takes the same body instantiated
//     with runtime k and output rows in passes of kRtRows (the RT path).
//   - The loop order of pallas_gf.py:60-80 (T1's `acc`): each (i, b) mask
//     is built once and consumed at once by all R accumulators.
//   - Each thread takes one 16-byte column of every input row (k LDG.128,
//     r STG.128): the four words give four independent chains, and each
//     constant read from shared memory (LDS.128, four b at a time, warp-
//     uniform, so no bank conflicts) serves four words.
//   - A 2-D grid, codewords on x and column tiles on y: no division per
//     element; the constants are staged once per block (r*k*8 words, at
//     most 2 KiB at (8, 8)).  One column per thread is one LDG.128 per
//     row in flight per thread, k per thread, enough bytes in flight at a
//     few resident blocks per SM to cover HBM latency.
//   - Shards whose row stride is not a multiple of 4 words take the same
//     body with four guarded word loads and stores (VEC = false).
// Why not TMA, cp.async or wgmma: each byte is read once into registers
// and never reused, so a shared-memory ring would add a copy and save
// nothing, and k independent 16-byte loads per thread already keep
// enough bytes in flight.  A GF(2) bit-matrix product on the int8 tensor
// cores (the shape of the reference's gf_bitmatmul, tpu_codec.py:41-55)
// would spend about as many unpack/pack instructions as it saves; it is
// an open question in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRtRows = 4;  // output rows per pass on the RT path
constexpr unsigned kMaxTiles = 65535;  // gridDim.y limit

__device__ __forceinline__ uint32_t sign_bytes(uint32_t v) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(v), "r"(0u), "r"(0xBA98u));
  return d;
}

template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ row,
                                       int64_t col, int64_t s4) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row) + col);
  const int64_t w = 4 * col;
  uint4 v;
  v.x = w + 0 < s4 ? __ldg(row + w + 0) : 0u;
  v.y = w + 1 < s4 ? __ldg(row + w + 1) : 0u;
  v.z = w + 2 < s4 ? __ldg(row + w + 2) : 0u;
  v.w = w + 3 < s4 ? __ldg(row + w + 3) : 0u;
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(uint32_t* __restrict__ row,
                                       int64_t col, int64_t s4, uint4 v) {
  if (VEC) {
    reinterpret_cast<uint4*>(row)[col] = v;
    return;
  }
  const int64_t w = 4 * col;
  if (w + 0 < s4) row[w + 0] = v.x;
  if (w + 1 < s4) row[w + 1] = v.y;
  if (w + 2 < s4) row[w + 2] = v.z;
  if (w + 3 < s4) row[w + 3] = v.w;
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// acc[p] ^= mask(x, b) & K[p, i, b] for the 8 bits of one input column
// of 4 words; kv points at the R rows' (i, 0..7) constants, 2 uint4 each,
// `kstride` uint4 apart; RT guards rows at or past `rows`.
template <int R, bool RT>
__device__ __forceinline__ void accumulate(uint4 (&acc)[R], const uint4 x,
                                           const uint4* kv, int kstride,
                                           int rows) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 kc[R];
#pragma unroll
    for (int p = 0; p < R; ++p)
      if (!RT || p < rows) kc[p] = kv[p * kstride + h];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int b = 4 * h + bb;
      const uint4 m = make_uint4(
          sign_bytes(x.x << (7 - b)), sign_bytes(x.y << (7 - b)),
          sign_bytes(x.z << (7 - b)), sign_bytes(x.w << (7 - b)));
#pragma unroll
      for (int p = 0; p < R; ++p) {
        if (RT && p >= rows) continue;
        const uint32_t kk = lane(kc[p], bb);
        acc[p].x ^= m.x & kk;  // one LOP3 each
        acc[p].y ^= m.y & kk;
        acc[p].z ^= m.z & kk;
        acc[p].w ^= m.w & kk;
      }
    }
  }
}

// Stage the (r, k, 8) scalar constants as byte-replicated words.
__device__ __forceinline__ void stage(uint32_t* sk,
                                      const uint32_t* __restrict__ consts,
                                      int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    sk[j] = consts[j] * 0x01010101u;
  __syncthreads();
}

// (K, R) fixed: block (codeword blockIdx.x, column tile blockIdx.y).
template <int K, int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gf_apply_kernel(const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ consts,
                    uint32_t* __restrict__ out, int64_t s4, int64_t ncol) {
  __shared__ uint4 sk4[R * K * 2];
  stage(reinterpret_cast<uint32_t*>(sk4), consts, R * K * 8);
  const uint32_t* xc = x + int64_t(blockIdx.x) * K * s4;
  uint32_t* oc = out + int64_t(blockIdx.x) * R * s4;
  const int64_t step = int64_t(gridDim.y) * blockDim.x;
  for (int64_t col = int64_t(blockIdx.y) * blockDim.x + threadIdx.x;
       col < ncol; col += step) {
    uint4 xs[K];
#pragma unroll
    for (int i = 0; i < K; ++i) xs[i] = load4<VEC>(xc + i * s4, col, s4);
    uint4 acc[R];
#pragma unroll
    for (int p = 0; p < R; ++p) acc[p] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < K; ++i)
      accumulate<R, false>(acc, xs[i], sk4 + i * 2, K * 2, R);
#pragma unroll
    for (int p = 0; p < R; ++p) store4<VEC>(oc + p * s4, col, s4, acc[p]);
  }
}

// Runtime (k, r): the same body, rows in passes of kRtRows.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    gf_apply_rt_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ consts,
                       uint32_t* __restrict__ out, int64_t s4, int64_t ncol,
                       int k, int r) {
  extern __shared__ uint4 sk4_dyn[];
  stage(reinterpret_cast<uint32_t*>(sk4_dyn), consts, r * k * 8);
  const uint32_t* xc = x + int64_t(blockIdx.x) * k * s4;
  uint32_t* oc = out + int64_t(blockIdx.x) * r * s4;
  const int64_t step = int64_t(gridDim.y) * blockDim.x;
  for (int64_t col = int64_t(blockIdx.y) * blockDim.x + threadIdx.x;
       col < ncol; col += step) {
    for (int p0 = 0; p0 < r; p0 += kRtRows) {
      const int rows = r - p0 < kRtRows ? r - p0 : kRtRows;
      uint4 acc[kRtRows];
#pragma unroll
      for (int p = 0; p < kRtRows; ++p) acc[p] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
      for (int i = 0; i < k; ++i) {
        const uint4 xi = load4<VEC>(xc + int64_t(i) * s4, col, s4);
        accumulate<kRtRows, true>(acc, xi, sk4_dyn + (p0 * k + i) * 2, k * 2,
                                  rows);
      }
#pragma unroll
      for (int p = 0; p < kRtRows; ++p)
        if (p < rows) store4<VEC>(oc + int64_t(p0 + p) * s4, col, s4, acc[p]);
    }
  }
}

struct Grid {
  dim3 grid, block;
  int64_t ncol;
};

Grid grid_for(int64_t ncw, int64_t s4, bool vec) {
  const int64_t ncol = vec ? s4 / 4 : (s4 + 3) / 4;
  // narrow shards: a block no wider than the row (whole warps)
  int threads = kThreads;
  if (ncol < kThreads) threads = int((ncol + 31) / 32 * 32);
  int64_t tiles = (ncol + threads - 1) / threads;
  if (tiles > kMaxTiles) tiles = kMaxTiles;  // the grid-stride loop covers the rest
  return {dim3(unsigned(ncw), unsigned(tiles)), dim3(threads), ncol};
}

template <int K, int R>
int launch(const void* x, const void* consts, void* out, int64_t ncw,
           int64_t s4, bool vec, cudaStream_t stream) {
  const Grid g = grid_for(ncw, s4, vec);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* cp = static_cast<const uint32_t*>(consts);
  auto* op = static_cast<uint32_t*>(out);
  if (vec)
    gf_apply_kernel<K, R, true><<<g.grid, g.block, 0, stream>>>(xp, cp, op, s4,
                                                                g.ncol);
  else
    gf_apply_kernel<K, R, false><<<g.grid, g.block, 0, stream>>>(xp, cp, op,
                                                                 s4, g.ncol);
  return int(cudaGetLastError());
}

// The instantiated (k, r): encode at RS(8,4) and RS(4,2), decode rows
// r = 1..m and the full decode r = k at k = 8 and k = 4.  The one list of
// them: ops/cuda_gf.py reads INSTANTIATIONS from this macro.
#define GF_APPLY_INSTANTIATIONS(X) \
  X(8, 1) X(8, 2) X(8, 3) X(8, 4) X(8, 8) X(4, 1) X(4, 2) X(4, 4)

// Returns -1 for a pair that is not instantiated.
int launch_fixed(int k, int r, const void* x, const void* consts, void* out,
                 int64_t ncw, int64_t s4, bool vec, cudaStream_t s) {
#define GF_APPLY_CASE(K, R) \
  if (k == K && r == R) return launch<K, R>(x, consts, out, ncw, s4, vec, s);
  GF_APPLY_INSTANTIATIONS(GF_APPLY_CASE)
#undef GF_APPLY_CASE
  return -1;
}

int launch_rt(int k, int r, const void* x, const void* consts, void* out,
              int64_t ncw, int64_t s4, bool vec, cudaStream_t stream) {
  const Grid g = grid_for(ncw, s4, vec);
  const size_t smem = size_t(r) * k * 8 * sizeof(uint32_t);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* cp = static_cast<const uint32_t*>(consts);
  auto* op = static_cast<uint32_t*>(out);
  if (smem > 48 * 1024) {
    cudaError_t e = vec ? cudaFuncSetAttribute(
                              gf_apply_rt_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem))
                        : cudaFuncSetAttribute(
                              gf_apply_rt_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
    if (e != cudaSuccess) return int(e);
  }
  if (vec)
    gf_apply_rt_kernel<true><<<g.grid, g.block, smem, stream>>>(
        xp, cp, op, s4, g.ncol, k, r);
  else
    gf_apply_rt_kernel<false><<<g.grid, g.block, smem, stream>>>(
        xp, cp, op, s4, g.ncol, k, r);
  return int(cudaGetLastError());
}

}  // namespace

// x (ncw, k, s4) u32, consts (r, k, 8) u32 scalar constants (< 256), out
// (ncw, r, s4) u32, all contiguous on the device, x and out 16-byte
// aligned.  `runtime` = 0 takes the (k, r) instantiation (an error,
// cudaErrorInvalidValue, if there is none), 1 the runtime-(k, r) path.
// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch (0 = cudaSuccess).
extern "C" int gf_apply_launch(const void* x, const void* consts, void* out,
                               int64_t ncw, int64_t s4, int k, int r,
                               int runtime, void* stream) {
  if (ncw <= 0 || s4 <= 0 || r <= 0) return 0;
  if (k <= 0 || ncw > 0x7FFFFFFF) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = s4 % 4 == 0;
  if (runtime) return launch_rt(k, r, x, consts, out, ncw, s4, vec, s);
  const int rc = launch_fixed(k, r, x, consts, out, ncw, s4, vec, s);
  return rc < 0 ? int(cudaErrorInvalidValue) : rc;
}
