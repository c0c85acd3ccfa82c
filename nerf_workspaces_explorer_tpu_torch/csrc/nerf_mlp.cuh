// Device code shared by the fused render kernels (fused_render.cu) and the
// fused training field kernels (train_field.cu): WMMA bf16 products of a
// 128-point activation tile against weights streamed through shared memory
// in slabs, their epilogues, and the polynomial sin/cos of the encoding.
//
// A block has 8 warps; warp w owns activation rows [16 w, 16 w + 16) of a
// 128-row tile. Activations are bf16 [128, *] in shared memory; weights are
// bf16 row-major [out, in] in device memory (L2-resident), staged through a
// [128 columns x 64 inputs] slab so each weight element is read once per
// block step, not once per warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MP 128                // activation rows (points) per block step
#define WIDTH 256             // trunk width
#define HALF (WIDTH / 2)      // view layer width
#define ENC 64                // point encoding rows: 3 + 6 * 10, padded to 64
#define PTS_FREQS 10
#define VENC 32               // view encoding rows: 3 + 6 * 4, padded to 32
#define VIEW_FREQS 4
#define LDA (WIDTH + 8)       // activation row stride (bf16), keeps 32 B alignment
#define LDE (ENC + 8)         // encoding row stride
#define KS 64                 // slab depth (inputs per staged weight slab)
#define LDS (KS + 8)          // slab row stride
#define NCH 128               // output columns per chunk
#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define LDST 20               // per-warp fp32 staging row stride

typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> Acc;

// acc[f] += A[this warp's 16 rows, 0:K] . W[n0 + 16 f + (0..15), 0:K]^T, with
// W row-major [*, K] and K a multiple of KS. All threads of the block must
// call it together.
template <int NF>
__device__ __forceinline__ void mma_accum(Acc (&acc)[NF], const bf16* A, int lda,
                                          const bf16* __restrict__ W, int K, int n0,
                                          bf16* slab) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  constexpr int VPR = KS / 8;  // 16-byte vectors per slab row
  for (int k0 = 0; k0 < K; k0 += KS) {
    for (int v = threadIdx.x; v < NF * 16 * VPR; v += NTHREADS) {
      const int r = v / VPR, c = (v % VPR) * 8;
      *reinterpret_cast<uint4*>(slab + r * LDS + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + warp * 16 * lda + k0 + kk, lda);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, slab + f * 16 * LDS + kk, LDS);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();
  }
}

enum { EPI_RELU = 0, EPI_LINEAR = 1, EPI_VIEW = 2, EPI_F32 = 3 };

// Bias (+ view term) (+ ReLU) on this warp's accumulators, written as bf16
// activations to dst, or as fp32 columns < ncols to out32. EPI_VIEW adds
// hvenc[(row % hv_period) * HALF + col], a view term shared by the rows
// that repeat with period hv_period.
template <int NF, int MODE>
__device__ __forceinline__ void epilogue(Acc (&acc)[NF], const float* __restrict__ bias,
                                         int n0, bf16* dst, float* stage,
                                         const float* hvenc, int hv_period, float* out32,
                                         int ostride, int ncols) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(stage, acc[f], LDST, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const int row = warp * 16 + r, col = n0 + f * 16 + c;
      float v = stage[r * LDST + c];
      if (MODE == EPI_VIEW) v += hvenc[(row % hv_period) * HALF + col];
      v += bias[col];
      if (MODE == EPI_RELU || MODE == EPI_VIEW) v = fmaxf(v, 0.f);
      if (MODE == EPI_F32) {
        if (col < ncols) out32[row * ostride + col] = v;
      } else {
        dst[row * LDA + col] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
}

template <int NF>
__device__ __forceinline__ void zero_acc(Acc (&acc)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) nvcuda::wmma::fill_fragment(acc[f], 0.f);
}

// dst[:, 0:n_out] = epi(A[:, 0:K] . W^T (+ E[:, 0:ENC] . W_skip^T)), in
// 128-column chunks.
template <int MODE>
__device__ void dense(const bf16* A, int lda, const bf16* W, int K, const bf16* E,
                      const bf16* W_skip, const float* bias, int n_out, bf16* dst,
                      bf16* slab, float* stage, const float* hvenc, int hv_period) {
  for (int n0 = 0; n0 < n_out; n0 += NCH) {
    Acc acc[8];
    zero_acc(acc);
    mma_accum<8>(acc, A, lda, W, K, n0, slab);
    if (W_skip != nullptr) mma_accum<8>(acc, E, LDE, W_skip, ENC, n0, slab);
    epilogue<8, MODE>(acc, bias, n0, dst, stage, hvenc, hv_period, nullptr, 0, 0);
  }
}

// One 16-column head (alpha or rgb) into fp32 columns < ncols of out32.
__device__ void head16(const bf16* A, const bf16* W, int K, const float* bias,
                       float* out32, int ostride, int ncols, bf16* slab, float* stage) {
  Acc acc[1];
  zero_acc(acc);
  mma_accum<1>(acc, A, LDA, W, K, 0, slab);
  epilogue<1, EPI_F32>(acc, bias, 0, nullptr, stage, nullptr, 1, out32, ostride, ncols);
}

// Quadrant-reduced polynomial sin/cos (cephes coefficients on [-pi/4, pi/4],
// two-term pi/2 split), the TPU kernels' _sincos_poly.
__device__ __forceinline__ void sincos_poly(float p, float& s, float& c) {
  const float PIO2_HI = 1.5707855224609375f;
  const float PIO2_LO = (float)(1.5707963267948966 - 1.5707855224609375);
  const float q = rintf(p * 0.6366197723675814f);
  const float r = (p - q * PIO2_HI) - q * PIO2_LO;
  const float r2 = r * r;
  const float s0 = r + r * r2 * (-1.6666654611e-1f + r2 * (8.3321608736e-3f + r2 * -1.9515295891e-4f));
  const float c0 = 1.f + r2 * (-0.5f + r2 * (4.166664568298827e-2f +
                                             r2 * (-1.388731625493765e-3f + r2 * 2.443315711809948e-5f)));
  const int qi = (int)q;
  const bool swap = (qi & 1) == 1;
  const float sign = (qi & 2) == 2 ? -1.f : 1.f;
  s = (swap ? c0 : s0) * sign;
  c = (swap ? -s0 : c0) * sign;
}

// One coordinate's encoding rows in kernel order from its base phase p:
// e[c] = p, e[3 + 3k + c] = sin(2^k p), e[3 + 3F + 3k + c] = cos(2^k p), by
// octave doubling from one polynomial sin/cos pair (the TPU kernels'
// _encode_ladder), each rounded to bf16.
template <int F>
__device__ __forceinline__ void encode_coord(bf16* e, int c, float p) {
  e[c] = __float2bfloat16(p);
  float sn, cs;
  sincos_poly(p, sn, cs);
  for (int k = 0; k < F; ++k) {
    e[3 + 3 * k + c] = __float2bfloat16(sn);
    e[3 + 3 * F + 3 * k + c] = __float2bfloat16(cs);
    const float s2 = 2.f * sn * cs;
    cs = 1.f - 2.f * sn * sn;
    sn = s2;
  }
}
