// Fused NeRF field evaluation + volume compositing for Hopper (sm_90a).
//
// Replaces: nerf_workspaces_explorer_tpu/ops/pallas_render.py::_render_kernel,
//   launched through nerf_render_pallas, in all its modes: bf16 density-only
//   for the coarse or proposal pass (the TPU path's K1) and bf16 full for the
//   fine pass (K3); and the int8 modes (K7): int8 trunk with bf16 heads
//   ("int8-trunk", _trunk :544-595) and int8 trunk and heads ("int8",
//   :719-724 and :765-783), with the encoding quantized in the same chain
//   (_encode_ladder's qscale, :539-540) and the per-ray view term carried in
//   the view accumulator's integer domain (:674-681).
//
// One library per network shape: this file compiles with -DRENDER_WIDTH=W
//   and -DRENDER_FREQS=F (point frequencies) for each shape the in-repo
//   checkpoints need (ops/_build.py: 64/6 density-only; 128/8, 192/10 and
//   256/10 in both modes), each holding the bf16, int8-trunk and int8 modes.
//   The int8 modes' fp32 chains (phase, sin/cos polynomial, octave ladder,
//   quantization, the rgb dequantization) are written with __fmul_rn and
//   __fadd_rn, which the compiler never contracts into FMAs, so they round
//   as the plain version's separate multiplies and adds do: a one-ulp phase
//   difference would otherwise flip an int8 level. Everything else compiles
//   with the default contraction, as the bf16 kernel always has.
//
// What bounds it on this card: tensor-core operations. A sample of the 8x256
//   fine net costs about 1.18 MFLOP against a few dozen bytes of per-ray
//   input and output, far above the H100's ridge (~295 bf16 FLOP per byte,
//   twice that for int8 at twice the rate). The weights (1.26 MB bf16 for the
//   8x256 fine net, half in int8) do not fit one SM's shared memory but stay
//   resident in the 50 MB L2.
//
// What the design does about it: a block owns 32 rays and walks their
//   samples front to back, 4 samples per step, so each step is a 128-point
//   batch whose activations never leave shared memory (two ping-pong tiles).
//   Every layer is a WMMA 16x16x16 product, bf16 with fp32 accumulation or
//   s8 with s32 accumulation; each warp owns 16 points and up to 128 output
//   columns at a time, and the layer's weights are staged through shared
//   memory in [columns x 64 inputs] slabs, so a weight element is read from
//   L2 once per block step, not once per warp. Column chunks are 128, 64, 32
//   or 16 wide, whichever divides the layer (192 = 3 x 64, 96 = 3 x 32); a
//   slab zero-fills inputs past the stored rows, so the 8-padded encoding
//   rows of the public layout (40 for F=6) feed WMMA's 16-deep k-steps.
//   The int8 epilogues are integer-only: clip((acc + b) >> k, 0, 127), the
//   skip accumulator shifted before the add, and only sigma and rgb
//   dequantize. Per-ray transmittance and the composite stay in shared
//   memory, and a block stops once every ray it owns has transmittance at or
//   below eps, exact up to eps because samples run front to back. Simple
//   first: no TMA, no wgmma, one block per SM.
//
// The density pass that feeds importance-only placement (`importance_only`
//   in nerf_render_launch) stops a block only once every ray has T <= min(eps,
//   PDF_GUARD / S). Why: the sampler's pdf is (w_i + g) / Z over the interior
//   bins, g = PDF_GUARD = 1e-5 (ops/importance_merge.py). Zeroing a stopped
//   ray's tail removes a mass t <= T of weight; every CDF entry then moves by
//   at most t / Z' (Z' the sum left), and since every bin holds at least
//   g / Z' of the CDF, a quantile moves by at most t / g bins. With
//   t <= g / S it moves by under 1/S of a bin wherever it sits, so the
//   placement is the unstopped pass's to that resolution; at the caller's eps
//   alone (1e-3) a quantile next to a density plateau could jump across it
//   (up to 100 bins). The merged placement keeps the coarse depths and stops
//   at eps.
//
// K8 (replaces scripts/profile_fine_ablation.py::_ablation_kernel, reached
//   through run_ablation): built with -DRENDER_ABLATE=1 into a library of its
//   own, `ablation_kernel<W, F, A>` is the int8 full pass with an ablation
//   mask A (the A_* bits below) as a template parameter, on the same 32-ray
//   block and 4-sample steps: no early stop, no depth or acc rows. The served
//   kernels compile from `render_body` with A = 0, where every ablation branch
//   is discarded at compile time.

#include <type_traits>

#include "nerf_mlp.cuh"

#ifndef RENDER_WIDTH
#define RENDER_WIDTH 256
#endif
#ifndef RENDER_FREQS
#define RENDER_FREQS 10
#endif
#ifndef RENDER_ABLATE
#define RENDER_ABLATE 0
#endif

#define RB 32                 // rays per block
#define SG 4                  // samples per step (RB * SG = MP points)
#define MAXD 16
#define RVENC 32              // view encoding rows of the full pass: 3 + 6 * 4, padded to 32
#define SLAB_K 64             // inputs per staged weight slab
#define SLAB_ROWS 128         // most columns per chunk

static_assert(RB * SG == MP, "a block step is one MP-point tile");

namespace rk {

typedef signed char s8;
enum { MODE_BF16 = 0, MODE_INT8_TRUNK = 1, MODE_INT8 = 2 };

// Ablation mask of K8 (scripts/profile_fine_ablation.py's flags): each bit
// changes one stage of the int8 full pass. Its results are wrong on purpose.
enum {
  A_ON = 1,         // an ablation launch: no early stop, depth and acc rows 0
  A_ENC = 2,        // "enc": a step reuses its sample group's first features
  A_DIRECT = 4,     // "enc-direct": sin(o_ph + z d_ph) on every live row
  A_NOBASE = 8,     // "enc-nobase": base sin/cos := p * 0.11, p * 0.12
  A_NOCONCAT = 16,  // "enc-noconcat": group features + coordinate 0's piece-sum level, int8 wrap
  A_HEADS = 32,     // "heads": sigma := h[0], rgb := h[1..3]
  A_EPI = 64,       // "epilogue": rgb_acc += rgb + sigma, T untouched
};

// The per-bin guard of importance placement's pdf (importance_merge.cu, JAX
// pallas_sampling.py).
#define PDF_GUARD 1e-5f

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Element type -> WMMA fragment types, row strides of the activation tiles
// and slabs (bf16: +8 elements; s8: +16 bytes, WMMA's s8 stride unit).
template <typename T> struct Tr;
template <> struct Tr<bf16> {
  typedef float AccT;
  static constexpr int PAD = 8;
  typedef uint4 Vec8;  // 8 elements
};
template <> struct Tr<s8> {
  typedef int AccT;
  static constexpr int PAD = 16;
  typedef uint2 Vec8;
};
template <typename T> __host__ __device__ constexpr int slab_ld() { return SLAB_K + Tr<T>::PAD; }

template <typename T>
using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, typename Tr<T>::AccT>;

struct Quant {
  int shift[MAXD];   // per-layer requant shift
  int skip_shift;    // skip accumulator: >> j (j > 0) or << -j (j < 0)
  int k_feat;        // feature head requant shift (int8 mode)
  int k_hv;          // view layer requant shift (int8 mode)
  float qscale;      // encoding quant scale, 127 / feat_max
  float s_alpha;     // sigma accumulator -> fp32
  float inv_s_view;  // 1 / view accumulator scale
  float s_rgb;       // rgb accumulator -> fp32
};

struct NetPtrs {
  const void* w[MAXD];        // layer i: [W, in_i], in_0 = stored encoding rows, else W
  const void* b[MAXD];        // layer i: [W] fp32 (bf16 mode) or int32 (int8 modes)
  const void* w_skip;         // [W, enc rows]: encoding weights of the skip layer
  const void* w_alpha;        // [16, W], row 0 live
  const void* b_alpha;        // [16]
  const void* w_feat;         // [W, W]
  const void* b_feat;         // [W]
  const void* w_view_h;       // [W / 2, W]
  const bf16* w_view_enc;     // [W / 2, RVENC]
  const float* b_view;        // [W / 2]
  const void* w_rgb;          // [16, W / 2], rows 0-2 live
  const float* b_rgb;         // [16]
  int depth;
  int skip_layer;             // layer whose input is [encoding, h]; -1 for none
};

// acc[f] += A[this warp's 16 rows, k0:k0+KC] . slab[16 f + (0..15), 0:KC]^T.
template <typename T, int NF, int KC>
__device__ __forceinline__ void mma_slab(AccFrag<T> (&acc)[NF], const T* A, int lda, int k0,
                                         const T* slab) {
  using namespace nvcuda;
  constexpr int LDS_ = slab_ld<T>();
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + warp * 16 * lda + k0 + kk, lda);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
      wmma::load_matrix_sync(b, slab + f * 16 * LDS_ + kk, LDS_);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
}

// acc[f] += A[this warp's 16 rows, 0:K_PAD] . Wt[n0 + 16 f + (0..15), 0:K_PAD]^T.
// Wt is row-major [*, K_SRC]; inputs K_SRC..K_PAD-1 read as zeros. K_SRC is
// a multiple of 8 and K_PAD of 16. Weights stored in whole 64-deep slabs
// (every hidden layer, the F=10 encoding) stage and multiply in 64-deep
// steps; the rest (the 40- and 56-row encodings, the 96-wide heads) in
// 16-deep column blocks.
template <typename T, int NF, int K_SRC, int K_PAD>
__device__ __forceinline__ void mma_acc(AccFrag<T> (&acc)[NF], const T* A, int lda,
                                        const T* __restrict__ Wt, int n0, T* slab) {
  typedef typename Tr<T>::Vec8 V;
  constexpr int LDS_ = slab_ld<T>();
  if constexpr (K_SRC == K_PAD && K_PAD % SLAB_K == 0) {
    constexpr int VPR = SLAB_K / 8;
    for (int k0 = 0; k0 < K_PAD; k0 += SLAB_K) {
      for (int v = threadIdx.x; v < NF * 16 * VPR; v += NTHREADS) {
        const int r = v / VPR, c = (v % VPR) * 8;
        *reinterpret_cast<V*>(slab + r * LDS_ + c) =
            *reinterpret_cast<const V*>(Wt + (size_t)(n0 + r) * K_SRC + k0 + c);
      }
      __syncthreads();
      mma_slab<T, NF, SLAB_K>(acc, A, lda, k0, slab);
      __syncthreads();
    }
  } else {
    for (int k0 = 0; k0 < K_PAD; k0 += SLAB_K) {
      const int kc = min(SLAB_K, K_PAD - k0);
      for (int kk = 0; kk < kc; kk += 16) {
        for (int v = threadIdx.x; v < NF * 16 * 2; v += NTHREADS) {
          const int r = v >> 1, c = (v & 1) * 8;
          V val = V{};
          if (k0 + kk + c < K_SRC)
            val = *reinterpret_cast<const V*>(Wt + (size_t)(n0 + r) * K_SRC + k0 + kk + c);
          *reinterpret_cast<V*>(slab + kk + r * LDS_ + c) = val;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 16) mma_slab<T, NF, 16>(acc, A, lda, k0 + kk, slab + kk);
      __syncthreads();
    }
  }
}

// Epilogue kinds: what a layer's accumulators become.
enum {
  E_BF16_RELU,   // bf16 dst = relu(acc + b_f32)
  E_BF16_LIN,    // bf16 dst = acc + b_f32
  E_BF16_VIEW,   // bf16 dst = relu(acc + hvenc_f32 + b_f32)
  E_F32,         // out32 = acc + b_f32                      (alpha/rgb heads)
  E_Q_RELU,      // s8 dst = clip((acc + b_i32) >> k, 0, 127)
  E_Q_TO_BF16,   // bf16 dst = bf16_rn(max(acc + b_i32, 0)) (int8-trunk last layer)
  E_Q_FEAT,      // s8 dst = clip((acc + b_i32) >> k_feat, -127, 127)
  E_Q_VIEW,      // s8 dst = clip((acc + hvenc_i32) >> k_hv, 0, 127)
  E_Q_ALPHA,     // out32 = f32(acc + b_i32) * s_alpha
  E_Q_RGB,       // out32 = f32(acc) * s_rgb + b_f32
  E_Q_RAW,       // out32 = f32(acc)                        (K8 "epilogue")
};

struct Epi {
  const void* bias;
  const void* hvenc;   // [RB][hv_ld] per-ray view term (E_BF16_VIEW, E_Q_VIEW)
  int hv_ld;
  int shift;
  float scale;
  void* dst;           // activation tile (bf16 or s8)
  int ldd;
  float* out32;        // fp32 columns < ncols, row stride ostride
  int ostride;
  int ncols;
};

// The pointers come as __restrict__ parameters: read through `ep`, a bias
// or view-term load could not move past a store to the activation tile,
// which the compiler must assume may alias it, and the epilogue's loads
// and stores would serialise.
template <typename T, int NF, int KIND>
__device__ __forceinline__ void epilogue(AccFrag<T> (&acc)[NF], int n0, const void* __restrict__ bias_,
                                         const void* __restrict__ hvenc_, void* __restrict__ dst_,
                                         float* __restrict__ out32, const Epi& ep,
                                         typename Tr<T>::AccT* stage) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldd = ep.ldd, hv_ld = ep.hv_ld, shift = ep.shift, ostride = ep.ostride, ncols = ep.ncols;
  const float scale = ep.scale;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(stage, acc[f], LDST, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const int row = warp * 16 + r, col = n0 + f * 16 + c;
      const auto v = stage[r * LDST + c];
      if constexpr (KIND == E_BF16_RELU || KIND == E_BF16_LIN || KIND == E_BF16_VIEW || KIND == E_F32) {
        float x = v;
        if constexpr (KIND == E_BF16_VIEW) x += static_cast<const float*>(hvenc_)[(row % RB) * hv_ld + col];
        x += static_cast<const float*>(bias_)[col];
        if constexpr (KIND == E_BF16_RELU || KIND == E_BF16_VIEW) x = fmaxf(x, 0.f);
        if constexpr (KIND == E_F32) {
          if (col < ncols) out32[row * ostride + col] = x;
        } else {
          static_cast<bf16*>(dst_)[row * ldd + col] = __float2bfloat16(x);
        }
      } else if constexpr (KIND == E_Q_RELU || KIND == E_Q_FEAT) {
        const int pre = v + static_cast<const int*>(bias_)[col];
        const int lo = KIND == E_Q_RELU ? 0 : -127;
        static_cast<s8*>(dst_)[row * ldd + col] = (s8)min(max(pre >> shift, lo), 127);
      } else if constexpr (KIND == E_Q_TO_BF16) {
        const int pre = v + static_cast<const int*>(bias_)[col];
        static_cast<bf16*>(dst_)[row * ldd + col] = __int2bfloat16_rn(max(pre, 0));
      } else if constexpr (KIND == E_Q_VIEW) {
        const int pre = v + static_cast<const int*>(hvenc_)[(row % RB) * hv_ld + col];
        static_cast<s8*>(dst_)[row * ldd + col] = (s8)min(max(pre >> shift, 0), 127);
      } else if constexpr (KIND == E_Q_ALPHA) {
        const int pre = v + static_cast<const int*>(bias_)[col];
        if (col < ncols) out32[row * ostride + col] = (float)pre * scale;
      } else if constexpr (KIND == E_Q_RGB) {
        if (col < ncols)
          out32[row * ostride + col] = __fadd_rn(__fmul_rn((float)v, scale), static_cast<const float*>(bias_)[col]);
      } else if constexpr (KIND == E_Q_RAW) {
        if (col < ncols) out32[row * ostride + col] = (float)v;
      }
    }
    __syncwarp();
  }
}

template <int N> __host__ __device__ constexpr int chunk_cols() {
  return N % 128 == 0 ? 128 : N % 64 == 0 ? 64 : N % 32 == 0 ? 32 : 16;
}

// One layer: epi(A[:, 0:K_PAD] . Wt^T (+ E[:, 0:KS_PAD] . Wskip^T)) over
// N_OUT columns, in chunks of chunk_cols<N_OUT>(); KS_PAD = 0 for a layer
// that never takes the skip. In the int8 modes the skip product comes first
// and is shifted by skip_shift before the main product adds to it (integer
// sums are exact in any order).
template <typename T, int KIND, int N_OUT, int K_SRC, int K_PAD, int KS_SRC = 0, int KS_PAD = 0>
__device__ void dense(const T* A, int lda, const void* Wt, const T* E, int lde, const void* Wskip,
                      int skip_shift, const Epi& ep, T* slab, typename Tr<T>::AccT* stage) {
  constexpr int NCH_ = chunk_cols<N_OUT>();
  constexpr int NF = NCH_ / 16;
  constexpr bool INT = sizeof(T) == 1;
  for (int n0 = 0; n0 < N_OUT; n0 += NCH_) {
    AccFrag<T> acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) nvcuda::wmma::fill_fragment(acc[f], typename Tr<T>::AccT(0));
    if constexpr (INT && KS_PAD > 0) {
      if (Wskip != nullptr) {
        mma_acc<T, NF, KS_SRC, KS_PAD>(acc, E, lde, static_cast<const T*>(Wskip), n0, slab);
#pragma unroll
        for (int f = 0; f < NF; ++f)
          for (int t = 0; t < acc[f].num_elements; ++t)
            acc[f].x[t] = skip_shift >= 0 ? acc[f].x[t] >> skip_shift : acc[f].x[t] << -skip_shift;
      }
    }
    mma_acc<T, NF, K_SRC, K_PAD>(acc, A, lda, static_cast<const T*>(Wt), n0, slab);
    if constexpr (!INT && KS_PAD > 0) {
      if (Wskip != nullptr) mma_acc<T, NF, KS_SRC, KS_PAD>(acc, E, lde, static_cast<const T*>(Wskip), n0, slab);
    }
    epilogue<T, NF, KIND>(acc, n0, ep.bias, ep.hvenc, ep.dst, ep.out32, ep, stage);
  }
}

__device__ __forceinline__ Epi epi_act(const void* bias, void* dst, int ldd, int shift = 0) {
  Epi e = {};
  e.bias = bias;
  e.dst = dst;
  e.ldd = ldd;
  e.shift = shift;
  return e;
}

__device__ __forceinline__ Epi epi_out(const void* bias, float* out32, int ostride, int ncols,
                                       float scale = 1.f) {
  Epi e = {};
  e.bias = bias;
  e.out32 = out32;
  e.ostride = ostride;
  e.ncols = ncols;
  e.scale = scale;
  return e;
}

// sincos_poly (nerf_mlp.cuh) with every product and sum rounded on its own,
// in the plain version's order of operations (fused_render.py::_sincos_poly).
__device__ __forceinline__ void sincos_poly_rn(float p, float& s, float& c) {
  const float PIO2_HI = 1.5707855224609375f;
  const float PIO2_LO = (float)(1.5707963267948966 - 1.5707855224609375);
  const float q = rintf(__fmul_rn(p, 0.6366197723675814f));
  const float r = __fsub_rn(__fsub_rn(p, __fmul_rn(q, PIO2_HI)), __fmul_rn(q, PIO2_LO));
  const float r2 = __fmul_rn(r, r);
  float ps = __fadd_rn(8.3321608736e-3f, __fmul_rn(r2, -1.9515295891e-4f));
  ps = __fadd_rn(-1.6666654611e-1f, __fmul_rn(r2, ps));
  const float s0 = __fadd_rn(r, __fmul_rn(__fmul_rn(r, r2), ps));
  float pc = __fadd_rn(-1.388731625493765e-3f, __fmul_rn(r2, 2.443315711809948e-5f));
  pc = __fadd_rn(4.166664568298827e-2f, __fmul_rn(r2, pc));
  pc = __fadd_rn(-0.5f, __fmul_rn(r2, pc));
  const float c0 = __fadd_rn(1.f, __fmul_rn(r2, pc));
  const int qi = (int)q;
  const bool swap = (qi & 1) == 1;
  const float sign = (qi & 2) == 2 ? -1.f : 1.f;
  s = (swap ? c0 : s0) * sign;
  c = (swap ? -s0 : c0) * sign;
}

// One coordinate's encoding rows from its base phase p = o + z d,
// int8-quantized: clip(rint(x * qscale), -127, 127) of encode_coord<F>'s
// values, the whole fp32 chain uncontracted (header note).
template <int F>
__device__ __forceinline__ void encode_coord_q(s8* e, int c, float o, float z, float d, float qs) {
  auto q = [qs](float x) { return (s8)fminf(fmaxf(rintf(__fmul_rn(x, qs)), -127.f), 127.f); };
  const float p = __fadd_rn(o, __fmul_rn(z, d));
  e[c] = q(p);
  float sn, cs;
  sincos_poly_rn(p, sn, cs);
  for (int k = 0; k < F; ++k) {
    e[3 + 3 * k + c] = q(sn);
    e[3 + 3 * F + 3 * k + c] = q(cs);
    const float s2 = __fmul_rn(__fmul_rn(2.f, sn), cs);
    cs = __fsub_rn(1.f, __fmul_rn(__fmul_rn(2.f, sn), sn));
    sn = s2;
  }
}

// K8's encoding stages. Templates and a static function: a library that
// launches no ablation kernel compiles none of them.
static __device__ __forceinline__ s8 quantize_rn(float x, float qs) {
  return (s8)fminf(fmaxf(rintf(__fmul_rn(x, qs)), -127.f), 127.f);
}

// "enc-nobase": encode_coord_q with the base sin/cos replaced by p * 0.11 and
// p * 0.12 (the ladder kept).
template <int F>
__device__ __forceinline__ void encode_coord_nobase_q(s8* e, int c, float o, float z, float d, float qs) {
  const float p = __fadd_rn(o, __fmul_rn(z, d));
  e[c] = quantize_rn(p, qs);
  float sn = __fmul_rn(p, 0.11f), cs = __fmul_rn(p, 0.12f);
  for (int k = 0; k < F; ++k) {
    e[3 + 3 * k + c] = quantize_rn(sn, qs);
    e[3 + 3 * F + 3 * k + c] = quantize_rn(cs, qs);
    const float s2 = __fmul_rn(__fmul_rn(2.f, sn), cs);
    cs = __fsub_rn(1.f, __fmul_rn(__fmul_rn(2.f, sn), sn));
    sn = s2;
  }
}

// The encoding stages of K8 that run after the per-coordinate loop of a step
// (that loop has encoded the group-start rows for A_ENC / A_NOCONCAT and
// nothing for A_DIRECT). Rows are s_local * RB + ray_local; `cache` holds the
// features of each ray's latest group start, for groups longer than a step.
template <int F, int ABL>
__device__ __forceinline__ void ablate_encode(s8* E, int lde, s8* cache, const float* __restrict__ o_ph,
                              const float* __restrict__ d_ph, const float* __restrict__ zv, int R, int S,
                              int g, int ray0, int sps, float qs) {
  constexpr int LIVE = 3 + 6 * F;
  constexpr int SRC = round_up(LIVE, 8);
  const int tid = threadIdx.x;
  if constexpr ((ABL & A_DIRECT) != 0) {
    // sin(o_ph + z d_ph) on every live row of the phase vectors (identity
    // rows 0-2; the cos rows carry their pi/2 in o_ph), accurate sinf.
    for (int i = tid; i < MP * LIVE; i += NTHREADS) {
      const int row = i / LIVE, j = i % LIVE;
      const int s = g * SG + row / RB;
      const int ray = min(ray0 + row % RB, R - 1);
      const float z = s < S ? zv[(size_t)s * R + ray] : 0.f;
      const float ph = __fadd_rn(o_ph[(size_t)j * R + ray], __fmul_rn(z, d_ph[(size_t)j * R + ray]));
      E[row * lde + j] = quantize_rn(j < 3 ? ph : sinf(ph), qs);
    }
  }
  if constexpr ((ABL & (A_ENC | A_NOCONCAT)) != 0) {
    __syncthreads();
    // Rows past their group's start take its features: from this step's
    // rows, or from the cache when the group began in an earlier step
    // (sample groups are powers of two, so a group longer than a step starts
    // at a step's first row). Copied in 16-byte words, the row's zero pad
    // included, so the copy costs far less than the encoding it replaces.
    constexpr int V = round_up(LIVE, 16) / 16;
    for (int i = tid; i < MP * V; i += NTHREADS) {
      const int row = i / V, v = i % V, rl = row % RB;
      const int s = g * SG + row / RB;
      const int start = s - s % sps;
      uint4* dst = reinterpret_cast<uint4*>(E + row * lde) + v;
      uint4* cached = reinterpret_cast<uint4*>(cache + rl * lde) + v;
      if (start != s)
        *dst = start >= g * SG ? reinterpret_cast<const uint4*>(E + ((start - g * SG) * RB + rl) * lde)[v] : *cached;
      else if (sps >= SG)
        *cached = *dst;
    }
  }
  if constexpr ((ABL & A_NOCONCAT) != 0) {
    __syncthreads();
    // The piece-sum p + sin p + cos p + ... of coordinate 0, quantized, added
    // to every stored row in int32 and narrowed to int8 with wrap-around.
    for (int row = tid; row < MP; row += NTHREADS) {
      const int s = g * SG + row / RB;
      const int ray = min(ray0 + row % RB, R - 1);
      const float z = s < S ? zv[(size_t)s * R + ray] : 0.f;
      const float p = __fadd_rn(o_ph[ray], __fmul_rn(z, d_ph[ray]));
      float sn = sinf(p), cs = cosf(p);
      float acc = __fadd_rn(__fadd_rn(p, sn), cs);
      for (int k = 1; k < F; ++k) {
        const float s2 = __fmul_rn(__fmul_rn(2.f, sn), cs);
        cs = __fsub_rn(1.f, __fmul_rn(__fmul_rn(2.f, sn), sn));
        sn = s2;
        acc = __fadd_rn(__fadd_rn(acc, sn), cs);
      }
      const int a = (int)fminf(fmaxf(rintf(__fmul_rn(acc, qs)), -127.f), 127.f);
      for (int j = 0; j < SRC; ++j) E[row * lde + j] = (s8)((((int)E[row * lde + j] + a + 128) & 255) - 128);
    }
  }
}

// Shared-memory layout of one block (bytes), for width W and F frequencies.
template <int W, int F>
struct Smem {
  static constexpr int ENC_LIVE = 3 + 6 * F;
  static constexpr int ENC_SRC = round_up(ENC_LIVE, 8);   // stored encoding rows
  static constexpr int ENCP = round_up(ENC_LIVE, 16);     // WMMA k-depth of the encoding
  static constexpr int HALF_ = W / 2;
  static constexpr int LDA_B = W + 8, LDA_Q = W + 16;     // activation row strides (elements)
  static constexpr int LDE_B = ENCP + 8, LDE_Q = ENCP + 16;
  static constexpr int BUF = round_up(MP * LDA_B * 2, 128);
  static constexpr int EBYTES = round_up(MP * LDE_B * 2, 128);
  static constexpr int SLAB = round_up(SLAB_ROWS * (SLAB_K + 8) * 2, 128);
  static constexpr int STAGE = NWARPS * 16 * LDST * 4;
  static constexpr int MISC = 3 * MP * 4 + MP * 4 * 4 + RB * 8 * 4 + 32 * 4;
  static constexpr int HV = RB * HALF_ * 4;
  static constexpr int CACHE = RB * LDE_Q;                // K8: one s8 encoding per ray
  static constexpr size_t bytes(bool density_only) {
    return 2 * BUF + EBYTES + SLAB + STAGE + MISC + (density_only ? 0 : HV);
  }
};

// Trunk layer i of the mode's kind, inputs A [MP, K_PAD] (the encoding for
// layer 0, the previous activations after it) and, on the skip layer, the
// encoding E through Wskip.
template <typename TT, int MODE, int W, int F, int K_SRC, int K_PAD, int KS_SRC = 0, int KS_PAD = 0>
__device__ __forceinline__ void trunk_layer(const TT* A, int lda, const TT* E, int lde, const NetPtrs& net,
                                            const Quant& qa, int i, void* dst, TT* slab,
                                            typename Tr<TT>::AccT* stage) {
  typedef Smem<W, F> L;
  const void* wskip = i == net.skip_layer ? net.w_skip : nullptr;
  if constexpr (MODE == MODE_BF16) {
    dense<TT, E_BF16_RELU, W, K_SRC, K_PAD, KS_SRC, KS_PAD>(A, lda, net.w[i], E, lde, wskip, 0,
                                                             epi_act(net.b[i], dst, L::LDA_B), slab, stage);
  } else {
    if (MODE == MODE_INT8_TRUNK && i == net.depth - 1)
      dense<TT, E_Q_TO_BF16, W, K_SRC, K_PAD, KS_SRC, KS_PAD>(A, lda, net.w[i], E, lde, wskip, qa.skip_shift,
                                                               epi_act(net.b[i], dst, L::LDA_B), slab, stage);
    else
      dense<TT, E_Q_RELU, W, K_SRC, K_PAD, KS_SRC, KS_PAD>(A, lda, net.w[i], E, lde, wskip, qa.skip_shift,
                                                            epi_act(net.b[i], dst, L::LDA_Q, qa.shift[i]), slab,
                                                            stage);
  }
}

// One block's work: the served kernels with ABL = 0, K8 with an ablation
// mask (then MODE_INT8, the full pass, eps 0 and `sps` the sample group of
// A_ENC / A_NOCONCAT).
template <int W, int F, int MODE, bool DENSITY_ONLY, int ABL>
__device__ __forceinline__ void render_body(const NetPtrs& net, const Quant& qa, const float* __restrict__ o_ph,
                                            const float* __restrict__ d_ph, const float* __restrict__ zv,
                                            const float* __restrict__ dv, const bf16* __restrict__ venc,
                                            float* __restrict__ out, int R, int S, float eps, int* live_groups,
                                            int sps) {
  static_assert(ABL == 0 || (MODE == MODE_INT8 && !DENSITY_ONLY), "K8 ablates the int8 full pass");
  typedef Smem<W, F> L;
  constexpr int HALF_ = L::HALF_;
  // The trunk's element type; the heads' is s8 only in full int8 mode.
  typedef typename std::conditional<MODE == MODE_BF16, bf16, s8>::type TT;
  typedef typename std::conditional<MODE == MODE_INT8, s8, bf16>::type TH;
  constexpr int LDT = MODE == MODE_BF16 ? L::LDA_B : L::LDA_Q;
  constexpr int LDH = MODE == MODE_INT8 ? L::LDA_Q : L::LDA_B;
  constexpr int LDEN = MODE == MODE_BF16 ? L::LDE_B : L::LDE_Q;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* bufs[2] = {smem, smem + L::BUF};
  unsigned char* Eraw = smem + 2 * L::BUF;
  unsigned char* slab = Eraw + L::EBYTES;
  float* stage_all = reinterpret_cast<float*>(slab + L::SLAB);
  float* zs = stage_all + NWARPS * 16 * LDST;
  float* ds = zs + MP;
  float* sig = ds + MP;
  float* rgbraw = sig + MP;            // [MP][4]
  float* ray_state = rgbraw + MP * 4;  // [RB][8]: T, r, g, b, depth, acc
  int* alive = reinterpret_cast<int*>(ray_state + RB * 8);
  void* hvenc = alive + 32;            // [RB][HALF] fp32 (int32 in int8 mode), full mode only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray0 = blockIdx.x * RB;
  float* stage = stage_all + warp * 16 * LDST;
  TT* E = reinterpret_cast<TT*>(Eraw);

  // Zero the encoding's pad columns (WMMA reads them against zero weights).
  for (int r = tid; r < MP; r += NTHREADS)
    for (int b = L::ENC_LIVE * (int)sizeof(TT); b < LDEN * (int)sizeof(TT); ++b)
      Eraw[r * LDEN * sizeof(TT) + b] = 0;
  if (tid < RB) {
    ray_state[tid * 8 + 0] = 1.f;
    for (int k = 1; k < 8; ++k) ray_state[tid * 8 + k] = 0.f;
  }
  if (tid == 0) alive[0] = 1;
  if (!DENSITY_ONLY) {
    // The view encoding's contribution to the view layer is per ray:
    // W_view_enc . venc, once per ray, not once per sample. In int8 mode it
    // moves to the view accumulator's integer domain with the view bias and
    // the requant rounding offset folded in.
    for (int i = tid; i < RB * HALF_; i += NTHREADS) {
      const int r = i / HALF_, n = i % HALF_;
      const int ray = min(ray0 + r, R - 1);
      float acc = 0.f;
      for (int k = 0; k < RVENC; ++k)
        acc += __bfloat162float(net.w_view_enc[n * RVENC + k]) * __bfloat162float(venc[(size_t)k * R + ray]);
      if constexpr (MODE == MODE_INT8) {
        int q = (int)rintf((acc + net.b_view[n]) * qa.inv_s_view);
        if (qa.k_hv > 0) q += 1 << (qa.k_hv - 1);
        static_cast<int*>(hvenc)[i] = q;
      } else {
        static_cast<float*>(hvenc)[i] = acc;
      }
    }
  }
  __syncthreads();

  const int n_groups = (S + SG - 1) / SG;
  int n_live = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (!alive[0]) {
      // Every ray of the block is saturated: the remaining samples carry
      // weight < eps. The density pass still owes their (zero) weights.
      if (DENSITY_ONLY) {
        for (int i = tid; i < (S - g * SG) * RB; i += NTHREADS) {
          const int s = g * SG + i / RB, ray = ray0 + i % RB;
          if (ray < R) out[(size_t)s * R + ray] = 0.f;
        }
      }
      break;
    }
    ++n_live;
    // Encode the step's points: row = s_local * RB + ray_local.
    for (int i = tid; i < MP * 3; i += NTHREADS) {
      const int row = i / 3, c = i % 3;
      const int s = g * SG + row / RB;
      const int ray = min(ray0 + row % RB, R - 1);
      const bool live = s < S;
      const float z = live ? zv[(size_t)s * R + ray] : 0.f;
      const float o = o_ph[(size_t)c * R + ray], d = d_ph[(size_t)c * R + ray];
      if constexpr (MODE == MODE_BF16) {
        encode_coord<F>(E + row * LDEN, c, o + z * d);
      } else if constexpr ((ABL & (A_ENC | A_NOCONCAT)) != 0) {
        if (s % sps == 0) encode_coord_q<F>(E + row * LDEN, c, o, z, d, qa.qscale);
      } else if constexpr ((ABL & A_NOBASE) != 0) {
        encode_coord_nobase_q<F>(E + row * LDEN, c, o, z, d, qa.qscale);
      } else if constexpr ((ABL & A_DIRECT) == 0) {
        encode_coord_q<F>(E + row * LDEN, c, o, z, d, qa.qscale);
      }
      if (c == 0) {
        zs[row] = z;
        ds[row] = live ? dv[(size_t)s * R + ray] : 0.f;  // dist 0: alpha 0
      }
    }
    if constexpr ((ABL & (A_DIRECT | A_ENC | A_NOCONCAT)) != 0)
      ablate_encode<F, ABL>(E, LDEN, reinterpret_cast<s8*>(static_cast<unsigned char*>(hvenc) + L::HV), o_ph,
                            d_ph, zv, R, S, g, ray0, sps, qa.qscale);
    __syncthreads();

    // Density trunk.
    typedef typename Tr<TT>::AccT TAcc;
    TAcc* tstage = reinterpret_cast<TAcc*>(stage);
    TT* tslab = reinterpret_cast<TT*>(slab);
    trunk_layer<TT, MODE, W, F, L::ENC_SRC, L::ENCP>(E, LDEN, E, LDEN, net, qa, 0, bufs[0], tslab, tstage);
    for (int i = 1; i < net.depth; ++i)
      trunk_layer<TT, MODE, W, F, W, W, L::ENC_SRC, L::ENCP>(reinterpret_cast<const TT*>(bufs[(i - 1) & 1]), LDT,
                                                             E, LDEN, net, qa, i, bufs[i & 1], tslab, tstage);
    const TH* h = reinterpret_cast<const TH*>(bufs[(net.depth - 1) & 1]);
    TH* other = reinterpret_cast<TH*>(bufs[net.depth & 1]);
    typedef typename Tr<TH>::AccT HAcc;
    HAcc* hstage = reinterpret_cast<HAcc*>(stage);
    TH* hslab = reinterpret_cast<TH*>(slab);
    if constexpr ((ABL & A_HEADS) != 0) {
      // "heads": the trunk's first four int8 activations read as sigma, rgb.
      for (int i = tid; i < MP; i += NTHREADS) {
        sig[i] = (float)h[i * LDH];
        for (int c = 0; c < 3; ++c) rgbraw[i * 4 + c] = (float)h[i * LDH + 1 + c];
      }
    } else if constexpr (MODE == MODE_INT8) {
      dense<TH, E_Q_ALPHA, 16, W, W>(h, LDH, net.w_alpha, nullptr, 0, nullptr, 0,
                                     epi_out(net.b_alpha, sig, 1, 1, qa.s_alpha), hslab, hstage);
    } else {
      dense<TH, E_F32, 16, W, W>(h, LDH, net.w_alpha, nullptr, 0, nullptr, 0, epi_out(net.b_alpha, sig, 1, 1),
                                 hslab, hstage);
    }
    if constexpr (!DENSITY_ONLY && (ABL & A_HEADS) == 0) {
      TH* hv = const_cast<TH*>(h);
      Epi ev = epi_act(MODE == MODE_INT8 ? nullptr : (const void*)net.b_view, hv, LDH,
                       MODE == MODE_INT8 ? qa.k_hv : 0);
      ev.hvenc = hvenc;
      ev.hv_ld = HALF_;
      if constexpr (MODE == MODE_INT8) {
        dense<TH, E_Q_FEAT, W, W, W>(h, LDH, net.w_feat, nullptr, 0, nullptr, 0,
                                     epi_act(net.b_feat, other, LDH, qa.k_feat), hslab, hstage);
        dense<TH, E_Q_VIEW, HALF_, W, W>(other, LDH, net.w_view_h, nullptr, 0, nullptr, 0, ev, hslab, hstage);
        if constexpr ((ABL & A_EPI) != 0)
          dense<TH, E_Q_RAW, 16, HALF_, HALF_>(hv, LDH, net.w_rgb, nullptr, 0, nullptr, 0,
                                               epi_out(nullptr, rgbraw, 4, 3), hslab, hstage);
        else
          dense<TH, E_Q_RGB, 16, HALF_, HALF_>(hv, LDH, net.w_rgb, nullptr, 0, nullptr, 0,
                                               epi_out(net.b_rgb, rgbraw, 4, 3, qa.s_rgb), hslab, hstage);
      } else {
        dense<TH, E_BF16_LIN, W, W, W>(h, LDH, net.w_feat, nullptr, 0, nullptr, 0, epi_act(net.b_feat, other, LDH),
                                       hslab, hstage);
        dense<TH, E_BF16_VIEW, HALF_, W, W>(other, LDH, net.w_view_h, nullptr, 0, nullptr, 0, ev, hslab, hstage);
        dense<TH, E_F32, 16, HALF_, HALF_>(hv, LDH, net.w_rgb, nullptr, 0, nullptr, 0,
                                           epi_out(net.b_rgb, rgbraw, 4, 3), hslab, hstage);
      }
    }
    __syncthreads();

    // Composite front to back: one lane per ray.
    if (warp == 0) {
      const int ray = ray0 + lane;
      const bool valid = ray < R;
      float* st = ray_state + lane * 8;
      float T = st[0];
      for (int sl = 0; sl < SG; ++sl) {
        const int s = g * SG + sl;
        if (s >= S) break;
        const int row = sl * RB + lane;
        if constexpr ((ABL & A_EPI) != 0) {
          // "epilogue": plain adds in the TPU kernel's order, T untouched.
          for (int c = 0; c < 3; ++c) st[1 + c] = __fadd_rn(__fadd_rn(st[1 + c], rgbraw[row * 4 + c]), sig[row]);
          continue;
        }
        const float alpha = 1.f - expf(-fmaxf(sig[row], 0.f) * ds[row]);
        const float w = alpha * T;
        if (DENSITY_ONLY) {
          if (valid) out[(size_t)s * R + ray] = w;
        } else if constexpr ((ABL & A_ON) != 0) {
          // K8 composites rgb alone, each product and sum rounded on its own
          // as in the plain version; "heads" has no sigmoid.
          for (int c = 0; c < 3; ++c) {
            const float x = rgbraw[row * 4 + c];
            st[1 + c] = __fadd_rn(st[1 + c], __fmul_rn(w, (ABL & A_HEADS) != 0 ? x : 1.f / (1.f + expf(-x))));
          }
        } else {
          for (int c = 0; c < 3; ++c)
            st[1 + c] += w * (1.f / (1.f + expf(-rgbraw[row * 4 + c])));
          st[4] += w * zs[row];
          st[5] += w;
        }
        T = T * (1.f - alpha + 1e-10f);
      }
      st[0] = T;
      float tmax = valid ? T : 0.f;
      for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      if (lane == 0) alive[0] = (eps <= 0.f) || (tmax > eps);
    }
    __syncthreads();
  }

  if (!DENSITY_ONLY && warp == 0) {
    const int ray = ray0 + lane;
    if (ray < R) {
      const float* st = ray_state + lane * 8;
      out[0 * (size_t)R + ray] = st[1];
      out[1 * (size_t)R + ray] = st[2];
      out[2 * (size_t)R + ray] = st[3];
      out[3 * (size_t)R + ray] = st[4];
      out[4 * (size_t)R + ray] = st[5];
      out[5 * (size_t)R + ray] = st[0];
      out[6 * (size_t)R + ray] = 0.f;
      out[7 * (size_t)R + ray] = 0.f;
    }
  }
  if (live_groups != nullptr && tid == 0) atomicAdd(live_groups, n_live);
}

template <int W, int F, int MODE, bool DENSITY_ONLY>
__global__ void __launch_bounds__(NTHREADS, 1)
render_kernel(NetPtrs net, Quant qa, const float* __restrict__ o_ph, const float* __restrict__ d_ph,
              const float* __restrict__ zv, const float* __restrict__ dv,
              const bf16* __restrict__ venc, float* __restrict__ out, int R, int S,
              float eps, int* live_groups) {
  render_body<W, F, MODE, DENSITY_ONLY, 0>(net, qa, o_ph, d_ph, zv, dv, venc, out, R, S, eps, live_groups, 1);
}

template <int W, int F, int MODE, bool DENSITY_ONLY>
cudaError_t launch(const NetPtrs& net, const Quant& qa, const float* o_ph, const float* d_ph,
                   const float* z, const float* dists, const bf16* venc, float* out, int n_rays,
                   int n_samples, float eps, int* live_groups, cudaStream_t st) {
  const size_t smem = Smem<W, F>::bytes(DENSITY_ONLY);
  auto kernel = render_kernel<W, F, MODE, DENSITY_ONLY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rays + RB - 1) / RB);
  kernel<<<grid, NTHREADS, smem, st>>>(net, qa, o_ph, d_ph, z, dists, venc, out, n_rays, n_samples, eps,
                                       live_groups);
  return cudaGetLastError();
}

template <int W, int F, bool DENSITY_ONLY>
cudaError_t launch_mode(int mode, const NetPtrs& net, const Quant& qa, const float* o_ph,
                        const float* d_ph, const float* z, const float* dists, const bf16* venc,
                        float* out, int n_rays, int n_samples, float eps, int* live_groups,
                        cudaStream_t st) {
  switch (mode) {
    case MODE_BF16:
      return launch<W, F, MODE_BF16, DENSITY_ONLY>(net, qa, o_ph, d_ph, z, dists, venc, out, n_rays,
                                                   n_samples, eps, live_groups, st);
    case MODE_INT8_TRUNK:
      return launch<W, F, MODE_INT8_TRUNK, DENSITY_ONLY>(net, qa, o_ph, d_ph, z, dists, venc, out, n_rays,
                                                         n_samples, eps, live_groups, st);
    case MODE_INT8:
      return launch<W, F, MODE_INT8, DENSITY_ONLY>(net, qa, o_ph, d_ph, z, dists, venc, out, n_rays,
                                                   n_samples, eps, live_groups, st);
  }
  return cudaErrorInvalidValue;
}

#if RENDER_ABLATE
template <int W, int F, int ABL>
__global__ void __launch_bounds__(NTHREADS, 1)
ablation_kernel(NetPtrs net, Quant qa, const float* __restrict__ o_ph, const float* __restrict__ d_ph,
                const float* __restrict__ zv, const float* __restrict__ dv, const bf16* __restrict__ venc,
                float* __restrict__ out, int R, int S, int sps) {
  render_body<W, F, MODE_INT8, false, ABL | A_ON>(net, qa, o_ph, d_ph, zv, dv, venc, out, R, S, 0.f, nullptr, sps);
}

template <int W, int F, int ABL>
cudaError_t launch_ablation(const NetPtrs& net, const Quant& qa, const float* o_ph, const float* d_ph,
                            const float* z, const float* dists, const bf16* venc, float* out, int n_rays,
                            int n_samples, int sps, cudaStream_t st) {
  const size_t smem = Smem<W, F>::bytes(false) + Smem<W, F>::CACHE;
  auto kernel = ablation_kernel<W, F, ABL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rays + RB - 1) / RB);
  kernel<<<grid, NTHREADS, smem, st>>>(net, qa, o_ph, d_ph, z, dists, venc, out, n_rays, n_samples, sps);
  return cudaGetLastError();
}
#endif

// Device pointers and quantization of one launch (the C entries' layout).
static void unpack_net(const void* const* ptrs, int depth, int skip_layer, int mode, const int* ishift,
                       const float* fscale, NetPtrs& net, Quant& qa) {
  int k = 0;
  for (int i = 0; i < depth; ++i) {
    net.w[i] = ptrs[k++];
    net.b[i] = ptrs[k++];
  }
  for (int i = depth; i < MAXD; ++i) {
    net.w[i] = nullptr;
    net.b[i] = nullptr;
  }
  net.w_skip = ptrs[k++];
  net.w_alpha = ptrs[k++];
  net.b_alpha = ptrs[k++];
  net.w_feat = ptrs[k++];
  net.b_feat = ptrs[k++];
  net.w_view_h = ptrs[k++];
  net.w_view_enc = static_cast<const bf16*>(ptrs[k++]);
  net.b_view = static_cast<const float*>(ptrs[k++]);
  net.w_rgb = ptrs[k++];
  net.b_rgb = static_cast<const float*>(ptrs[k++]);
  net.depth = depth;
  net.skip_layer = skip_layer;
  qa = Quant{};
  if (mode != MODE_BF16) {
    for (int i = 0; i < depth; ++i) qa.shift[i] = ishift[i];
    qa.skip_shift = ishift[depth];
    qa.k_feat = ishift[depth + 1];
    qa.k_hv = ishift[depth + 2];
    qa.qscale = fscale[0];
    qa.s_alpha = fscale[1];
    qa.inv_s_view = fscale[2];
    qa.s_rgb = fscale[3];
  }
}

}  // namespace rk

// RENDER_FULL=0 builds the density-only kernels alone (the proposal shape).
#ifndef RENDER_FULL
#define RENDER_FULL 1
#endif

// ptrs: device pointers in this order: w_0, b_0, ..., w_{depth-1}, b_{depth-1},
// w_skip, w_alpha, b_alpha, w_feat, b_feat, w_view_h, w_view_enc, b_view,
// w_rgb, b_rgb (the full-mode entries may be null in density-only mode).
// Weights are bf16 (mode 0) or int8 (trunk in modes 1-2, heads in mode 2);
// biases fp32 or int32 likewise; w_view_enc, b_view and b_rgb are always
// bf16/fp32. ishift: depth per-layer shifts, then skip_shift, k_feat, k_hv;
// fscale: qscale, s_alpha, inv_s_view, s_rgb (host memory; ignored in
// mode 0). Inputs are ray-minor: o_ph, d_ph [>=3, R] (rows 0-2 read), z and
// dists [S, R] fp32, venc [32, R] bf16. out: [S, R] weights (density-only)
// or [8, R] maps (rows 0-2 rgb, 3 depth, 4 acc, 5 transmittance).
// importance_only: the density pass's weights feed importance-only
// placement; its blocks then stop at T <= min(eps, PDF_GUARD / n_samples)
// (the note at the top). live_groups, if not null, gains the number of
// 4-sample steps each block evaluated. Returns the CUDA error code of the
// launch (0 on success).
#if !RENDER_ABLATE
extern "C" int nerf_render_launch(const void* const* ptrs, int width, int pts_freqs, int depth,
                                  int skip_layer, int mode, const int* ishift, const float* fscale,
                                  const float* o_ph, const float* d_ph, const float* z,
                                  const float* dists, const void* venc, float* out, int n_rays,
                                  int n_samples, int density_only, float eps, int importance_only,
                                  int* live_groups, void* stream) {
  if (width != RENDER_WIDTH || pts_freqs != RENDER_FREQS || depth < 1 || depth > MAXD || n_rays < 1 ||
      n_samples < 1 || mode < 0 || mode > 2 || (!density_only && !RENDER_FULL))
    return (int)cudaErrorInvalidValue;
  rk::NetPtrs net;
  rk::Quant qa;
  rk::unpack_net(ptrs, depth, skip_layer, mode, ishift, fscale, net, qa);
  if (density_only && importance_only && eps > 0.f) eps = fminf(eps, PDF_GUARD / (float)n_samples);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* v = static_cast<const bf16*>(venc);
  cudaError_t err;
  if (density_only) {
    err = rk::launch_mode<RENDER_WIDTH, RENDER_FREQS, true>(mode, net, qa, o_ph, d_ph, z, dists, v, out,
                                                           n_rays, n_samples, eps, live_groups, st);
  } else {
#if RENDER_FULL
    err = rk::launch_mode<RENDER_WIDTH, RENDER_FREQS, false>(mode, net, qa, o_ph, d_ph, z, dists, v, out,
                                                            n_rays, n_samples, eps, live_groups, st);
#else
    err = cudaErrorInvalidValue;
#endif
  }
  return (int)err;
}
#else
// K8: one ablation launch of the int8 full pass. ptrs, ishift, fscale, z,
// dists and venc as nerf_render_launch takes them (mode 2); o_ph and d_ph
// hold every encoding row, [round_up(3 + 6F, 8), R] ("enc-direct" reads them
// all); samples_per_step is the sample group of "enc"/"enc-noconcat", a
// power of two dividing n_samples; mask is 0 (the full mode's code) or one of
// the A_* combinations the switch lists. out: [8, R], rows 0-2 the rgb sum,
// row 5 the final T, the rest 0.
extern "C" int nerf_ablation_launch(const void* const* ptrs, int width, int pts_freqs, int depth,
                                    int skip_layer, const int* ishift, const float* fscale, const float* o_ph,
                                    const float* d_ph, const float* z, const float* dists, const void* venc,
                                    float* out, int n_rays, int n_samples, int samples_per_step, int mask,
                                    void* stream) {
  const int sps = samples_per_step;
  if (width != RENDER_WIDTH || pts_freqs != RENDER_FREQS || depth < 1 || depth > MAXD || n_rays < 1 ||
      n_samples < 1 || sps < 1 || (sps & (sps - 1)) != 0 || n_samples % sps != 0)
    return (int)cudaErrorInvalidValue;
  rk::NetPtrs net;
  rk::Quant qa;
  rk::unpack_net(ptrs, depth, skip_layer, rk::MODE_INT8, ishift, fscale, net, qa);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* v = static_cast<const bf16*>(venc);
  using namespace rk;
#define ABLATION_CASE(M)                                                                                 \
  case M:                                                                                                \
    return (int)launch_ablation<RENDER_WIDTH, RENDER_FREQS, M>(net, qa, o_ph, d_ph, z, dists, v, out, n_rays, \
                                                               n_samples, sps, st)
  switch (mask) {
    ABLATION_CASE(0);
    ABLATION_CASE(A_ENC);
    ABLATION_CASE(A_DIRECT);
    ABLATION_CASE(A_NOBASE);
    ABLATION_CASE(A_NOCONCAT);
    ABLATION_CASE(A_HEADS);
    ABLATION_CASE(A_EPI);
    ABLATION_CASE(A_ENC | A_HEADS | A_EPI);
  }
#undef ABLATION_CASE
  return (int)cudaErrorInvalidValue;
}
#endif
