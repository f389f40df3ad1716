// GF(2^8)/0x11D matrix apply in three loop orders, for the tuning sweep
// (garage_tpu_torch/tools/gf_tune.py), on Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference's sweep,
// scripts/pallas_tune.py `_pallas_once` (:96; bodies `_kernel_orig` :48,
// `_kernel_acc` :64, `_kernel_accs` :80).  It computes what that kernel
// computes: x is (k, n) uint32 — a group of codewords folded flat, row i
// holding data shard i of every codeword side by side — and consts the
// (r, k, 8) byte-replicated mask constants gfmul(M[p, i], 2^b) * 0x01010101;
// then
//   out[p, c] = XOR_{i<k, b<8} mask(x[i, c], b) & consts[p, i, b]
// where mask(v, b) has 0xFF in every byte of v whose bit b is set.  The
// three variants differ only in loop order and in how the mask is made,
// each written as the reference writes it:
//   ORIG: all 8k masks of a column computed first, then r output loops;
//   ACC:  each (i, b) mask consumed at once by r accumulators,
//         mask = m1 * 0xFF with m1 = (x >> b) & 0x01010101;
//   ACCS: ACC with mask = (m1 << 8) - m1 (equal for m1 bytes in {0, 1}: no
//         borrow crosses a byte).
//
// Bound on the H100.  At the sweep's shape (k = 8, r = 4, n = 2^20) the
// function reads 32 MiB and writes 16 MiB: 0.0150 ms at 3.35 TB/s.  The
// mask forms cost, per 4-byte word and per (i, b), a shift and an AND (the
// integer ALU pipe), the multiply (one IMAD, on the FMA pipe) and r
// AND-XORs (one LOP3 each, ALU pipe): the SASS has 385 ALU-pipe
// instructions per word at RS(8,4) (320 LOP3, 56 SHF).  The ALU pipe takes
// 64 lanes per SM per clock, so that work needs 0.024 ms at 1.98 GHz on
// 132 SMs: above the bytes, and what bounds this kernel, as it bounds
// csrc/gf_apply.cu.  The sweep records each variant's census and the issue
// bound it implies beside its time.
//
// What the design does about it.  The first port gave each tile to one
// thread block: at n = 2^20 that was 256, 128 and 64 blocks for tiles of
// 4096, 8192 and 16384 words, so the sweep's tile axis measured how much
// of the 132 SMs a launch filled.  Here a tile is split over tile / 1024
// blocks of 256 threads on a plain grid (tools/gf_tune.py `launch_shape`;
// a smaller tile is one block), so every tile launches the same 1024
// blocks at n = 2^20, four resident per SM at 64 registers, and the
// hardware's block scheduler keeps all 132 SMs busy to the end.  The
// Pallas tile keeps its meaning as the columns one unit of the grid owns;
// on this card it no longer changes the work of any SM.
//   - One thread-block cluster per tile (tile / 2048 blocks) was measured
//     and dropped: a cluster's blocks share one GPC, so the card holds 124
//     clusters of 4 blocks or 62 of 8, 496 blocks where a plain launch
//     holds 528, and the tiles of 8192 and 16384 words ran 18% slower than
//     on the plain grid (PERF.md).  A persistent grid would hand out in
//     software the same pieces that the block scheduler hands out in
//     hardware.
//   - Each thread owns a 16-byte column (k LDG.128 and r STG.128), so the
//     four words of a column are four independent chains of the same mask
//     arithmetic.  ORIG too: ptxas keeps its masks in 64 registers without
//     spills.
//   - The constants are staged once per block in shared memory and read
//     as LDS.128, four b at a time, warp-uniform (a broadcast, no bank
//     conflict), each serving the column's four words: 16 loads per word
//     beside 385 ALU instructions.  They go to the memory pipe, not the
//     ALU pipe that bounds the kernel; constant-bank operands would save
//     those loads and no ALU instruction.
//   - No TMA, cp.async or wgmma: each byte is read once into registers
//     and never reused, so a shared-memory ring would add a copy and save
//     nothing, and k independent 16-byte loads per thread keep enough
//     bytes in flight.
// The three variants do not survive nvcc as distinct code: their SASS is
// one instruction mix (1,924 instructions per thread at RS(8,4), 64
// registers, no spills).  The scheduler interleaves ORIG's 8k masks with
// their uses, which is ACC's order, and (m1 << 8) - m1 becomes the same
// IMAD by 255 as m1 * 0xFF: on this card the multiply is an FMA-pipe
// instruction, cheaper than a shift and a subtract on the ALU pipe.  The
// sweep's census per variant shows it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Variant { kOrig = 0, kAcc = 1, kAccs = 2 };

constexpr int kMaxThreads = 256;
constexpr int kWords = 4;  // words of a thread's column
constexpr uint32_t kOne = 0x01010101u;

__device__ __forceinline__ uint32_t& at(uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The variant's mask of bit b of every byte of v.
template <int VARIANT>
__device__ __forceinline__ uint32_t mask(uint32_t v, int b) {
  const uint32_t m1 = (v >> b) & kOne;
  return VARIANT == kAccs ? (m1 << 8) - m1 : m1 * 0xFFu;
}

// ORIG: the 8k masks of each word first, then each output row over them.
// sk4 holds the (r, k, 8) constants, 2 uint4 per (p, i).
template <int K, int R>
__device__ __forceinline__ void apply_orig(uint4 (&acc)[R], const uint4 (&xs)[K],
                                           const uint4* sk4) {
  uint32_t masks[K * 8][kWords];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        masks[i * 8 + b][j] = mask<kOrig>(lane(xs[i], j), b);
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 kc = sk4[(p * K + i) * 2 + h];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int j = 0; j < kWords; ++j)
            at(acc[p], j) ^= masks[i * 8 + 4 * h + bb][j] & lane(kc, bb);
      }
}

// ACC / ACCS: each (i, b) mask made once and consumed at once by the R
// accumulators.
template <int VARIANT, int K, int R>
__device__ __forceinline__ void apply_acc(uint4 (&acc)[R], const uint4 (&xs)[K],
                                          const uint4* sk4) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 kc[R];
#pragma unroll
      for (int p = 0; p < R; ++p) kc[p] = sk4[(p * K + i) * 2 + h];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          const uint32_t m = mask<VARIANT>(lane(xs[i], j), 4 * h + bb);
#pragma unroll
          for (int p = 0; p < R; ++p) at(acc[p], j) ^= m & lane(kc[p], bb);
        }
    }
}

// Block b owns words [b * block_words, (b + 1) * block_words) of every row;
// its threads walk the block's 16-byte columns, blockDim apart.
template <int VARIANT, int K, int R>
__global__ void __launch_bounds__(kMaxThreads)
    gf_tune_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ consts,
                   uint32_t* __restrict__ out, int64_t n, int block_words) {
  __shared__ uint4 sk4[R * K * 2];
  uint32_t* sk = reinterpret_cast<uint32_t*>(sk4);
  for (int j = threadIdx.x; j < R * K * 8; j += blockDim.x) sk[j] = consts[j];
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * block_words;
  const int ncol = block_words / kWords;
#pragma unroll 1
  for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
    const int64_t w0 = base + int64_t(c) * kWords;
    uint4 xs[K];
#pragma unroll
    for (int i = 0; i < K; ++i)
      xs[i] = __ldg(reinterpret_cast<const uint4*>(x + i * n + w0));
    uint4 acc[R];
#pragma unroll
    for (int p = 0; p < R; ++p) acc[p] = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (VARIANT == kOrig)
      apply_orig<K, R>(acc, xs, sk4);
    else
      apply_acc<VARIANT, K, R>(acc, xs, sk4);
#pragma unroll
    for (int p = 0; p < R; ++p)
      *reinterpret_cast<uint4*>(out + p * n + w0) = acc[p];
  }
}

template <int K, int R>
int launch(int variant, const uint32_t* x, const uint32_t* consts,
           uint32_t* out, int64_t n, int grid, int threads, int block_words,
           cudaStream_t stream) {
  if (variant == kOrig)
    gf_tune_kernel<kOrig, K, R><<<grid, threads, 0, stream>>>(x, consts, out, n,
                                                               block_words);
  else if (variant == kAcc)
    gf_tune_kernel<kAcc, K, R><<<grid, threads, 0, stream>>>(x, consts, out, n,
                                                              block_words);
  else if (variant == kAccs)
    gf_tune_kernel<kAccs, K, R><<<grid, threads, 0, stream>>>(x, consts, out, n,
                                                               block_words);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

}  // namespace

// x (k, n) u32, consts (r, k, 8) u32, out (r, n) u32, all contiguous on the
// device, x and out 16-byte aligned; (k, r) is (8, 4) or (4, 2), variant
// 0/1/2 = orig/acc/accs.  The launch: `grid` blocks of `threads` threads,
// each block owning `block_words` consecutive words of every row (a
// multiple of 4; grid * block_words = n).  Launches on `stream` without
// synchronising; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int gf_tune_launch(const void* x, const void* consts, void* out,
                              int64_t n, int k, int r, int variant, int grid,
                              int threads, int block_words, void* stream) {
  if (n <= 0) return 0;
  if (grid <= 0 || threads <= 0 || threads > kMaxThreads || block_words <= 0 ||
      block_words % kWords || int64_t(grid) * block_words != n ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return int(cudaErrorInvalidValue);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* cp = static_cast<const uint32_t*>(consts);
  auto* op = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 8 && r == 4)
    return launch<8, 4>(variant, xp, cp, op, n, grid, threads, block_words, st);
  if (k == 4 && r == 2)
    return launch<4, 2>(variant, xp, cp, op, n, grid, threads, block_words, st);
  return int(cudaErrorInvalidValue);
}
