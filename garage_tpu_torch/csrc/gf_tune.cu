// GF(2^8)/0x11D matrix apply in three loop orders, for the tuning sweep
// (garage_tpu_torch/tools/gf_tune.py), on Hopper (sm_90a).
//
// Replaces the Pallas kernel of the reference's sweep,
// scripts/pallas_tune.py `_pallas_once` (bodies `_kernel_orig`,
// `_kernel_acc`, `_kernel_accs`).  It computes what that kernel computes:
// x is (k, n) uint32 — a group of codewords folded flat, row i holding
// data shard i of every codeword side by side — and consts the (r, k, 8)
// byte-replicated mask constants gfmul(M[p, i], 2^b) * 0x01010101; then
//   out[p, c] = XOR_{i<k, b<8} mask(x[i, c], b) & consts[p, i, b]
// where mask(v, b) has 0xFF in every byte of v whose bit b is set.  The
// three variants differ only in loop order and in how the mask is made:
//   ORIG: all 8k masks of a column computed first, then r output loops
//         (8k + 1 live values);
//   ACC:  each (i, b) mask consumed at once by r accumulators (r + 1 live
//         values), mask = m1 * 0xFF;
//   ACCS: ACC with mask = (m1 << 8) - m1, a shift and a subtract in place
//         of the multiply (equal for m1 bytes in {0, 1}: no borrow crosses
//         a byte).
// The Pallas grid walked n in tiles of `tile` columns on one core; here a
// thread block covers TILE consecutive columns (the counterpart of the
// tile) with up to 256 threads, each thread one column at a time, strided
// by the block width, so loads and stores coalesce.  The constants are
// staged once per block in shared memory.
//
// Bound on the H100: HBM.  At the sweep's shape (k = 8, r = 4, n = 2^20)
// the function reads 32 MiB and writes 16 MiB, ~0.015 ms at 3.35 TB/s,
// while its r*k GF multiply-accumulates per 4-byte column come to 34 M
// instructions at least, ~0.001 ms at the SMs' issue rate.  The mask forms
// issue far more than that (8k masks and 8k*r and/xor pairs per column),
// which is what the sweep measures; this kernel is simple on purpose.
// Folding the winner into csrc/gf_apply.cu is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Variant { kOrig = 0, kAcc = 1, kAccs = 2 };

template <int VARIANT, int TILE, int K, int R>
__global__ void gf_tune_kernel(const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ consts,
                               uint32_t* __restrict__ out, int64_t n) {
  __shared__ uint32_t sk[R * K * 8];  // (r, k, 8) mask constants
  for (int i = threadIdx.x; i < R * K * 8; i += blockDim.x) sk[i] = consts[i];
  __syncthreads();

  const uint32_t one = 0x01010101u;
  const int64_t base = int64_t(blockIdx.x) * TILE;
  for (int c = threadIdx.x; c < TILE; c += blockDim.x) {
    const int64_t col = base + c;
    if (col >= n) return;
    uint32_t acc[R];
#pragma unroll
    for (int p = 0; p < R; ++p) acc[p] = 0u;
    if (VARIANT == kOrig) {
      uint32_t masks[K * 8];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const uint32_t xi = __ldg(x + int64_t(i) * n + col);
#pragma unroll
        for (int b = 0; b < 8; ++b) masks[i * 8 + b] = ((xi >> b) & one) * 0xFFu;
      }
#pragma unroll
      for (int p = 0; p < R; ++p) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
#pragma unroll
          for (int b = 0; b < 8; ++b)
            acc[p] ^= masks[i * 8 + b] & sk[(p * K + i) * 8 + b];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const uint32_t xi = __ldg(x + int64_t(i) * n + col);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t m1 = (xi >> b) & one;
          const uint32_t m = VARIANT == kAcc ? m1 * 0xFFu : (m1 << 8) - m1;
#pragma unroll
          for (int p = 0; p < R; ++p) acc[p] ^= m & sk[(p * K + i) * 8 + b];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < R; ++p) out[int64_t(p) * n + col] = acc[p];
  }
}

template <int VARIANT, int TILE, int K, int R>
int launch(const void* x, const void* consts, void* out, int64_t n,
           cudaStream_t stream) {
  constexpr int threads = TILE < 256 ? TILE : 256;
  const int64_t blocks = (n + TILE - 1) / TILE;
  gf_tune_kernel<VARIANT, TILE, K, R><<<dim3(unsigned(blocks)), dim3(threads),
                                         0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(consts),
      static_cast<uint32_t*>(out), n);
  return int(cudaGetLastError());
}

template <int VARIANT, int K, int R>
int by_tile(int tile, const void* x, const void* consts, void* out, int64_t n,
            cudaStream_t s) {
  switch (tile) {
    case 128: return launch<VARIANT, 128, K, R>(x, consts, out, n, s);
    case 4096: return launch<VARIANT, 4096, K, R>(x, consts, out, n, s);
    case 8192: return launch<VARIANT, 8192, K, R>(x, consts, out, n, s);
    case 16384: return launch<VARIANT, 16384, K, R>(x, consts, out, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int K, int R>
int by_variant(int variant, int tile, const void* x, const void* consts,
               void* out, int64_t n, cudaStream_t s) {
  switch (variant) {
    case kOrig: return by_tile<kOrig, K, R>(tile, x, consts, out, n, s);
    case kAcc: return by_tile<kAcc, K, R>(tile, x, consts, out, n, s);
    case kAccs: return by_tile<kAccs, K, R>(tile, x, consts, out, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (k, n) u32, consts (r, k, 8) u32, out (r, n) u32, all contiguous on the
// device; (k, r) is (8, 4) or (4, 2), variant 0/1/2 = orig/acc/accs, tile
// one of 128, 4096, 8192, 16384 and a divisor of n.  Launches on `stream`
// without synchronising; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unsupported combination).
extern "C" int gf_tune_launch(const void* x, const void* consts, void* out,
                              int64_t n, int k, int r, int variant, int tile,
                              void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || n % tile) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 8 && r == 4) return by_variant<8, 4>(variant, tile, x, consts, out, n, s);
  if (k == 4 && r == 2) return by_variant<4, 2>(variant, tile, x, consts, out, n, s);
  return int(cudaErrorInvalidValue);
}
