// int4 probe legs for Hopper (sm_90a): int4 widened to bf16 on the tensor cores.
//
// Replaces: scripts/probe_int4_tpu.py's two pallas_call legs (:42 and :72),
//   each `int4 [M, K] widened to bf16 @ bf16 [K, N] -> fp32`. Leg 1 takes the
//   int4 matrix one value per byte (int8 storage holding [-8, 7]: PyTorch has
//   no arithmetic int4 type); leg 2 packed two to a byte, uint8 [M/2, K], the
//   low nibble row 2i and the high nibble row 2i + 1, sign-extended by shifts.
//
// What bounds it on this card: at the probe's 128 x 128 x 128, nothing but
//   the launch: 4.2 MFLOP and ~110 KB take microseconds either way. The
//   question is whether int4 operands reach the tensor cores: wgmma has no
//   4-bit type and mma.sync multiplies s4 only by s4, so, as on the TPU, each
//   value widens to bf16 (exact for [-8, 7]) before a bf16 product with fp32
//   accumulation.
//
// What the design does: one warp per 16 x 16 output tile; each 16-deep
//   k-step the warp widens its A tile into shared memory (unpacking the
//   nibbles in leg 2), stages its B tile beside it, and issues one WMMA bf16
//   16x16x16 mma_sync. Simple first: no wgmma, no pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int WARPS = 4;

template <bool PACKED>
__global__ void __launch_bounds__(WARPS * 32)
int4_probe_kernel(const unsigned char* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                  float* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 as[WARPS][16 * 16];
  __shared__ __align__(32) __nv_bfloat16 bs[WARPS][16 * 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_n = N / 16;
  const int tile = blockIdx.x * WARPS + warp;
  if (tile >= (M / 16) * tiles_n) return;  // whole warps only: the kernel syncs warps, not blocks
  const int m0 = tile / tiles_n * 16, n0 = tile % tiles_n * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15, m = m0 + r, k = k0 + c;
      int v;
      if constexpr (PACKED) {
        const unsigned byte = a[(size_t)(m >> 1) * K + k];
        // The row's nibble moved to the top of 32 bits, then shifted back
        // arithmetically: the sign extension of a 4-bit value.
        v = (int)(byte << ((m & 1) ? 24 : 28)) >> 28;
      } else {
        v = (int)(signed char)a[(size_t)m * K + k];
      }
      as[warp][e] = __int2bfloat16_rn(v);
      bs[warp][e] = b[(size_t)(k0 + r) * N + n0 + c];
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
    wmma::load_matrix_sync(fa, as[warp], 16);
    wmma::load_matrix_sync(fb, bs[warp], 16);
    wmma::mma_sync(acc, fa, fb, acc);
    __syncwarp();
  }
  wmma::store_matrix_sync(out + (size_t)m0 * N + n0, acc, N, wmma::mem_row_major);
}

}  // namespace

// a: int8 [M, K] holding [-8, 7] (packed = 0) or uint8 [M / 2, K] of nibble
// pairs (packed = 1); b: bf16 [K, N]; out: fp32 [M, N]; all row-major on the
// device. M, N and K are multiples of 16. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int int4_probe_launch(const void* a, const void* b, float* out, int m, int n, int k, int packed,
                                 void* stream) {
  if (m < 16 || n < 16 || k < 16 || m % 16 || n % 16 || k % 16) return (int)cudaErrorInvalidValue;
  const int tiles = (m / 16) * (n / 16);
  const dim3 grid((tiles + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* a8 = static_cast<const unsigned char*>(a);
  const __nv_bfloat16* b16 = static_cast<const __nv_bfloat16*>(b);
  if (packed)
    int4_probe_kernel<true><<<grid, WARPS * 32, 0, st>>>(a8, b16, out, m, n, k);
  else
    int4_probe_kernel<false><<<grid, WARPS * 32, 0, st>>>(a8, b16, out, m, n, k);
  return (int)cudaGetLastError();
}
