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
//   256/10 in both passes), each holding the bf16, int8-trunk and int8 modes.
//   The int8 modes' fp32 chains (phase, sin/cos polynomial, octave ladder,
//   quantization, the rgb dequantization) are written with __fmul_rn and
//   __fadd_rn, which the compiler never contracts into FMAs, so they round
//   as the plain version's separate multiplies and adds do.
//
// The work: a block owns 32 rays and walks their samples front to back, 4 per
//   step, so a step is a 128-point batch whose activations never leave shared
//   memory; it stops once every ray has T <= eps, exact up to eps. A point of
//   the 8x256 fine net costs 1.18 MFLOP of products against a few dozen bytes
//   of its own input and output.
//
// What bounds it on this card: each 128-point step multiplies every weight
//   once: at 8x256 bf16 that is 151 MFLOP against 1.19 MB of weights (127
//   FLOP a byte; half the bytes in int8 at twice the rate), read from the 50
//   MB L2 by every block, since no SM holds the net. Until the compositing
//   left the consumer warps, ptxas serialized every product of every served
//   kernel: "(C7520) Potential Performance Loss: wgmma.mma_async
//   instructions are serialized due to program dependence on
//   compiler-inserted WG.AR in divergent path", and the 8x256 full pass's
//   SASS held 76 HGMMA, each between its own WARPGROUP.ARRIVE and a
//   WARPGROUP.DEPBAR.LE gsb0, 0x0. Now ptxas prints no C7520 (only C7519
//   notes, "warpgroup.arrive is injected ... to allow use of registers in
//   GMMA"), and the same kernel's SASS holds 112 HGMMA against 9 waits to
//   0 and 19 to 1. On an H100 SXM at 700 W, at a click's 76,800 rays x 192
//   samples (eps 1e-3): 23.07 ms against 25.72 serialized, 549 TFLOP/s on the
//   evaluated samples, 55.5% of the dense bf16 peak; the weight stream
//   (99.8 GB a frame) now reads 4.3 TB/s from L2, where it read 3.9.
//   Which of the stream and the per-layer epilogues holds it there is not
//   measured yet (PERF.md).
//
// What the design does about it (the product path; the encoding and the
//   compositing are the earlier kernel's arithmetic):
//   - A warp-specialised block of 3 warpgroups. Warpgroups 0 and 1 are the
//     consumers (setmaxnreg 232) and own rows 0-63 and 64-127 of the step,
//     i.e. samples 0-1 and 2-3 of its 32 rays. Warpgroup 2 is the producer
//     (setmaxnreg 40): one elected thread keeps a ring of RING weight stages
//     full with cp.async.bulk and an mbarrier full/empty pair per stage (3
//     stages at 8x256 full, 4 where they fit), so the L2 latency of the next
//     slab overlaps the products on this one. Its second warp composites
//     each step (one lane per ray) and makes the stop decision, handed over
//     through two named barriers (BAR_HEADS, BAR_COMPOSITED).
//   - A weight stream packed once per parameter set (ops/fused_render.py::
//     pack_weight_stream): every matrix cut into slabs of 128 bytes of depth
//     (64 bf16 or 128 int8 inputs), each slab [rows x 128 B] in the layout
//     wgmma's 128-byte-swizzled K-major descriptor reads, zero-padded to the
//     product's depth (a multiple of 32 bytes), in the order the consumers
//     take them each step: layer 0's encoding slab; for each later layer the
//     skip layer's encoding slab (on that layer) and then its hidden slabs;
//     then alpha (density pass) or feature+alpha, view and rgb (full pass).
//     The producer walks a table of slab offsets and byte counts; no tensor
//     map (the s8 encoding rows of F=6, 40 bytes, are no legal TMA stride).
//     The swizzle, shared with the packer: byte b of row r of a slab sits at
//         r * 128 + (((b >> 4) ^ r) & 7) * 16 + (b & 15).
//     The activation and encoding tiles use the same layout, so the A
//     operands need no other descriptor geometry.
//   - wgmma for every product: bf16 m64nNk16 with fp32 sums, s8 m64nNk32 with
//     s32 sums (both 32 bytes of depth a k-step), N the layer's width;
//     feature and alpha as one pass (N = W + 16) up to width 192, rgb as an
//     n16. wgmma's N stops at 256, so at width 256 alpha's n16 product runs
//     first and the features' n256 after it, on slabs of their own
//     (`fa_split`): a ring stage stays 32 KB and a consumer holds at most
//     128 accumulators. In the int8 modes
//     the skip product comes first and is shifted by skip_shift in registers
//     before the main product adds to it (integer sums are exact in any
//     order); the bf16 mode takes the same order.
//   - Registers: setmaxnreg's budgets hold (ptxas spills more at 200 than at
//     232), but ptxas spilled until no accumulator was written or read on a
//     branch: zeroing and the skip shift are unconditional, the activation
//     epilogues visit a compile-time column range, and the fp32 heads copy
//     their 8-column block out before their per-column test. The smoke fails
//     on a spill in a served kernel.
//   - No per-lane branch on a consumer warp between products: ptxas puts a
//     warpgroup.arrive of its own where registers a wgmma uses were written
//     by other instructions, and one that lands on a divergent path
//     serializes every wgmma of the function, a wait after each (C7520).
//     The compositing warp's per-ray branches did that while it was a
//     consumer warp; on the producer warpgroup, which issues no wgmma, they
//     do not. The smoke fails on a C7520 in a served kernel.
//   - Epilogues in registers and activations in place: a consumer warpgroup
//     holds all N columns of its 64 rows in registers before it writes any,
//     so once its products have completed it writes bias/ReLU/requant results
//     over its own input rows. Each warpgroup owns a 64-row activation region
//     sized for bf16, so an int8 tile and the int8-trunk's bf16 last layer
//     stay inside it. Generic-proxy stores that a product reads next are
//     followed by fence.proxy.async and a named barrier of the warpgroup.
//   - Drain rule: the producer runs ahead into the next step. A block that
//     stops early sets a stop flag; the producer, which polls it while it
//     waits for a free stage, stops issuing and reports how many slabs it
//     issued; consumer thread 0 then waits on the full barrier of every slab
//     issued but not consumed, so no copy is in flight when the block exits.
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
//   mask A (the A_* bits below) as a template parameter, on the same block
//   and steps: no early stop, no depth or acc rows. The served kernels
//   compile from `render_body` with A = 0, where every ablation branch is
//   discarded at compile time.

#include <type_traits>

#include "hopper.cuh"

#ifndef RENDER_WIDTH
#define RENDER_WIDTH 256
#endif
#ifndef RENDER_FREQS
#define RENDER_FREQS 10
#endif
#ifndef RENDER_ABLATE
#define RENDER_ABLATE 0
#endif

#define RB 32                  // rays per block
#define SG 4                   // samples per step (RB * SG = MP points)
#define MAXD 16
#define RVENC 32               // view encoding rows of the full pass: 3 + 6 * 4, padded to 32
#define MAX_SLABS 96           // slabs of one step's weight stream

static_assert(RB * SG == MP && MP == 2 * WG_ROWS, "a block step is two 64-row warpgroup tiles");

namespace rk {

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

// Whether the full pass runs alpha and the features as two products (W + 16
// columns are more than one wgmma takes) or as one.
__host__ __device__ constexpr bool fa_split(int w) { return w + 16 > 256; }

// Product depth in bytes of the encoding: its stored rows (3 + 6F padded to
// 8) padded to the 32-byte k-step.
__host__ __device__ constexpr int enc_kb(int freqs, int elem) { return round_up(round_up(3 + 6 * freqs, 8) * elem, 32); }

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

// Biases and the per-ray view weights; the product weights arrive through
// the stream.
struct NetPtrs {
  const void* b[MAXD];        // layer i: [W] fp32 (bf16 mode) or int32 (int8 modes)
  const void* b_alpha;        // [16]
  const void* b_feat;         // [W]
  const bf16* w_view_enc;     // [W / 2, RVENC]
  const float* b_view;        // [W / 2]
  const float* b_rgb;         // [16]
  int depth;
  int skip_layer;             // layer whose input is [encoding, h]; -1 for none
};

typedef StreamT<MAX_SLABS> Stream;


// Epilogue kinds: what a product's accumulators become.
enum {
  E_BF16_RELU,   // bf16 act = relu(acc + b_f32)
  E_BF16_LIN,    // bf16 act = acc + b_f32
  E_BF16_VIEW,   // bf16 act = relu(acc + hvenc_f32 + b_f32)
  E_F32,         // out32 = acc + b_f32                      (alpha/rgb heads)
  E_Q_RELU,      // s8 act = clip((acc + b_i32) >> k, 0, 127)
  E_Q_TO_BF16,   // bf16 act = bf16_rn(max(acc + b_i32, 0)) (int8-trunk last layer)
  E_Q_FEAT,      // s8 act = clip((acc + b_i32) >> k_feat, -127, 127)
  E_Q_VIEW,      // s8 act = clip((acc + hvenc_i32) >> k_hv, 0, 127)
  E_Q_ALPHA,     // out32 = f32(acc + b_i32) * s_alpha
  E_Q_RGB,       // out32 = f32(acc) * s_rgb + b_f32
  E_Q_RAW,       // out32 = f32(acc)                        (K8 "epilogue")
};

// Activation kinds: columns < NACT (a multiple of 8) of a 64 x N product,
// written to this warpgroup's region `act` (rows local), with no test per
// element. The view term hvenc is [RB][hv_ld], per ray (a row's ray is its
// row mod RB).
template <int KIND, int N, int NACT = N, typename AccT>
__device__ __forceinline__ void epilogue(const AccT (&d)[N / 2], unsigned char* __restrict__ act,
                                         const void* __restrict__ bias_, const void* __restrict__ hvenc_, int hv_ld,
                                         int shift) {
  for_pairs<N, NACT / 8>(d, [&](int r, int c, AccT v0, AccT v1) {
    const int ray = r % RB;
    if constexpr (KIND == E_BF16_RELU || KIND == E_BF16_LIN || KIND == E_BF16_VIEW) {
      float x0 = v0, x1 = v1;
      if constexpr (KIND == E_BF16_VIEW) {
        const float2 hv = *reinterpret_cast<const float2*>(static_cast<const float*>(hvenc_) + ray * hv_ld + c);
        x0 += hv.x;
        x1 += hv.y;
      }
      const float2 b = *reinterpret_cast<const float2*>(static_cast<const float*>(bias_) + c);
      x0 += b.x;
      x1 += b.y;
      if constexpr (KIND != E_BF16_LIN) {
        x0 = fmaxf(x0, 0.f);
        x1 = fmaxf(x1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(act + act_off(r, 2 * c)) = __floats2bfloat162_rn(x0, x1);
    } else if constexpr (KIND == E_Q_TO_BF16) {
      const int2 b = *reinterpret_cast<const int2*>(static_cast<const int*>(bias_) + c);
      __nv_bfloat162 o;
      o.x = __int2bfloat16_rn(max((int)v0 + b.x, 0));
      o.y = __int2bfloat16_rn(max((int)v1 + b.y, 0));
      *reinterpret_cast<__nv_bfloat162*>(act + act_off(r, 2 * c)) = o;
    } else {
      static_assert(KIND == E_Q_RELU || KIND == E_Q_FEAT || KIND == E_Q_VIEW, "an activation kind");
      int p0, p1, lo = 0;
      if constexpr (KIND == E_Q_VIEW) {
        const int2 hv = *reinterpret_cast<const int2*>(static_cast<const int*>(hvenc_) + ray * hv_ld + c);
        p0 = (int)v0 + hv.x;
        p1 = (int)v1 + hv.y;
      } else {
        const int2 b = *reinterpret_cast<const int2*>(static_cast<const int*>(bias_) + c);
        p0 = (int)v0 + b.x;
        p1 = (int)v1 + b.y;
        if constexpr (KIND == E_Q_FEAT) lo = -127;
      }
      const int q0 = min(max(p0 >> shift, lo), 127), q1 = min(max(p1 >> shift, lo), 127);
      *reinterpret_cast<unsigned short*>(act + act_off(r, c)) = (unsigned short)((q0 & 255) | ((q1 & 255) << 8));
    }
  });
}

// fp32 kinds: columns [col_base, col_base + ncols) of a 64 x N product, all
// in its 8-column block J0, to out32[global row * ostride + column -
// col_base], the bias indexed alike. The block's accumulators are copied
// out unconditionally first: read under the per-column test, they would
// put the compiler's wgmma fences on a divergent path.
template <int KIND, int N, int J0, typename AccT>
__device__ __forceinline__ void epilogue_out(const AccT (&d)[N / 2], const void* __restrict__ bias_, float scale,
                                             float* __restrict__ out32, int ostride, int col_base, int ncols) {
  static_assert(KIND == E_F32 || KIND == E_Q_ALPHA || KIND == E_Q_RGB || KIND == E_Q_RAW, "an fp32 kind");
  AccT v[4] = {d[4 * J0], d[4 * J0 + 1], d[4 * J0 + 2], d[4 * J0 + 3]};
  fence_acc(v);
  const int t = threadIdx.x & 127;
  const int r0 = (threadIdx.x >> 7) * WG_ROWS + (t >> 5) * 16 + ((t & 31) >> 2);
  const int o0 = 8 * J0 + 2 * (t & 3) - col_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oc = o0 + (i & 1);
    if (oc < 0 || oc >= ncols) continue;
    float* dst = out32 + (r0 + 8 * (i >> 1)) * ostride + oc;
    if constexpr (KIND == E_F32) *dst = (float)v[i] + static_cast<const float*>(bias_)[oc];
    if constexpr (KIND == E_Q_ALPHA) *dst = (float)((int)v[i] + static_cast<const int*>(bias_)[oc]) * scale;
    if constexpr (KIND == E_Q_RGB) *dst = __fadd_rn(__fmul_rn((float)v[i], scale), static_cast<const float*>(bias_)[oc]);
    if constexpr (KIND == E_Q_RAW) *dst = (float)v[i];
  }
}

// ---------------------------------------------------------------------------
// Encoding (the earlier kernel's arithmetic), into a swizzled tile row.

// sincos_poly (hopper.cuh) with every product and sum rounded on its own,
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

static __device__ __forceinline__ s8 quantize_rn(float x, float qs) {
  return (s8)fminf(fmaxf(rintf(__fmul_rn(x, qs)), -127.f), 127.f);
}

// One coordinate's encoding rows from its base phase p = o + z d,
// int8-quantized: clip(rint(x * qscale), -127, 127) of encode_coord<F>'s
// values, the whole fp32 chain uncontracted (header note).
template <int F>
__device__ __forceinline__ void encode_coord_q(SwRow e, int c, float o, float z, float d, float qs) {
  const float p = __fadd_rn(o, __fmul_rn(z, d));
  *e.at(c) = quantize_rn(p, qs);
  float sn, cs;
  sincos_poly_rn(p, sn, cs);
  for (int k = 0; k < F; ++k) {
    *e.at(3 + 3 * k + c) = quantize_rn(sn, qs);
    *e.at(3 + 3 * F + 3 * k + c) = quantize_rn(cs, qs);
    const float s2 = __fmul_rn(__fmul_rn(2.f, sn), cs);
    cs = __fsub_rn(1.f, __fmul_rn(__fmul_rn(2.f, sn), sn));
    sn = s2;
  }
}

// K8's encoding stages. Templates: a library that launches no ablation
// kernel compiles none of them.

// "enc-nobase": encode_coord_q with the base sin/cos replaced by p * 0.11 and
// p * 0.12 (the ladder kept).
template <int F>
__device__ __forceinline__ void encode_coord_nobase_q(SwRow e, int c, float o, float z, float d, float qs) {
  const float p = __fadd_rn(o, __fmul_rn(z, d));
  *e.at(c) = quantize_rn(p, qs);
  float sn = __fmul_rn(p, 0.11f), cs = __fmul_rn(p, 0.12f);
  for (int k = 0; k < F; ++k) {
    *e.at(3 + 3 * k + c) = quantize_rn(sn, qs);
    *e.at(3 + 3 * F + 3 * k + c) = quantize_rn(cs, qs);
    const float s2 = __fmul_rn(__fmul_rn(2.f, sn), cs);
    cs = __fsub_rn(1.f, __fmul_rn(__fmul_rn(2.f, sn), sn));
    sn = s2;
  }
}

// The encoding stages of K8 that run after the per-coordinate loop of a step
// (that loop has encoded the group-start rows for A_ENC / A_NOCONCAT and
// nothing for A_DIRECT), by the consumer threads. Rows are s_local * RB +
// ray_local of the swizzled s8 tile E; `cache` holds the features of each
// ray's latest group start in plain order, for groups longer than a step.
template <int F, int ABL>
__device__ __forceinline__ void ablate_encode(unsigned char* E, unsigned char* cache, const float* __restrict__ o_ph,
                                              const float* __restrict__ d_ph, const float* __restrict__ zv, int R,
                                              int S, int g, int ray0, int sps, float qs) {
  constexpr int LIVE = 3 + 6 * F;
  constexpr int SRC = round_up(LIVE, 8);
  const int tid = threadIdx.x;
  if constexpr ((ABL & A_DIRECT) != 0) {
    // sin(o_ph + z d_ph) on every live row of the phase vectors (identity
    // rows 0-2; the cos rows carry their pi/2 in o_ph), accurate sinf.
    for (int i = tid; i < MP * LIVE; i += N_CONSUMERS) {
      const int row = i / LIVE, j = i % LIVE;
      const int s = g * SG + row / RB;
      const int ray = min(ray0 + row % RB, R - 1);
      const float z = s < S ? zv[(size_t)s * R + ray] : 0.f;
      const float ph = __fadd_rn(o_ph[(size_t)j * R + ray], __fmul_rn(z, d_ph[(size_t)j * R + ray]));
      *SwRow{E + row * 128, row}.at(j) = quantize_rn(j < 3 ? ph : sinf(ph), qs);
    }
  }
  if constexpr ((ABL & (A_ENC | A_NOCONCAT)) != 0) {
    consumers_sync();
    // Rows past their group's start take its features: from this step's
    // rows, or from the cache when the group began in an earlier step
    // (sample groups are powers of two, so a group longer than a step starts
    // at a step's first row). Copied in 16-byte words, the row's zero pad
    // included.
    constexpr int V = round_up(LIVE, 16) / 16;
    for (int i = tid; i < MP * V; i += N_CONSUMERS) {
      const int row = i / V, v = i % V, rl = row % RB;
      const int s = g * SG + row / RB;
      const int start = s - s % sps;
      uint4* dst = reinterpret_cast<uint4*>(SwRow{E + row * 128, row}.at(16 * v));
      uint4* cached = reinterpret_cast<uint4*>(cache + rl * 128) + v;
      if (start != s) {
        const int src = (start - g * SG) * RB + rl;
        *dst = start >= g * SG ? *reinterpret_cast<const uint4*>(SwRow{E + src * 128, src}.at(16 * v)) : *cached;
      } else if (sps >= SG) {
        *cached = *dst;
      }
    }
  }
  if constexpr ((ABL & A_NOCONCAT) != 0) {
    consumers_sync();
    // The piece-sum p + sin p + cos p + ... of coordinate 0, quantized, added
    // to every stored row in int32 and narrowed to int8 with wrap-around.
    for (int row = tid; row < MP; row += N_CONSUMERS) {
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
      const SwRow e{E + row * 128, row};
      for (int j = 0; j < SRC; ++j) {
        s8* x = reinterpret_cast<s8*>(e.at(j));
        *x = (s8)((((int)*x + a + 128) & 255) - 128);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared-memory layout of one block (bytes from a 1024-aligned base), for
// width W, F frequencies, the pass, and K8's per-ray cache.
template <int W, int F, bool DENSITY_ONLY, bool ABLATE>
struct Lay {
  static constexpr int HALF_ = W / 2;
  static constexpr int ACT = WG_ROWS * W * 2;                    // one warpgroup's rows, bf16-sized
  static constexpr int ENC_BYTES = MP * 128;                           // the step's encoding, one column block
  static constexpr int STAGE = (DENSITY_ONLY || fa_split(W) ? W : W + 16) * 128;  // largest slab
  static constexpr int HV = DENSITY_ONLY ? 0 : RB * HALF_ * 4;
  static constexpr int CACHE = ABLATE ? RB * 128 : 0;
  static constexpr int MISC = (2 * MP + 2 * MP + MP + 4 * MP + RB * 8) * 4 + 16;  // zs, ds, sig, rgb, rays, flags
  static constexpr int O_ACT = 0, O_ENC = 2 * ACT, O_STAGES = O_ENC + ENC_BYTES;
  static constexpr int FIXED = O_STAGES + HV + CACHE + round_up(MISC, 16) + 1024;  // + base alignment
  static constexpr int RING = cmin(4, (SMEM_LIMIT - FIXED - 9 * 8) / STAGE);
  static constexpr int O_HV = O_STAGES + RING * STAGE, O_CACHE = O_HV + HV, O_MISC = O_CACHE + CACHE;
  static constexpr int O_BARS = O_MISC + round_up(MISC, 16);
  static constexpr int BYTES = O_BARS + (2 * RING + 1) * 8 + 1024;
  static_assert(RING >= 2, "the weight ring needs two stages");
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
  static_assert(ACT % 1024 == 0 && STAGE % 1024 == 0, "swizzled tiles are 1024-aligned");
};

// Slab rows of one step's weight stream in the consumers' order (the
// packer's order, ops/fused_render.py::pack_weight_stream), for the launch
// entries' check of the table they are given. Returns the count; full
// selects the full pass's heads, heads = false stops after the trunk.
__host__ inline int stream_rows(int W, int F, int mode, bool full, bool heads, int depth, int skip_layer,
                                int* rows) {
  const int et = mode == MODE_BF16 ? 2 : 1, eh = mode == MODE_INT8 ? 1 : 2;
  int n = 0;
  auto mat = [&](int nrows, int kb) {
    for (int j = 0; j < (kb + 127) / 128; ++j)
      if (n < MAX_SLABS) rows[n++] = nrows;
      else ++n;
  };
  mat(W, enc_kb(F, et));
  for (int i = 1; i < depth; ++i) {
    if (i == skip_layer) mat(W, enc_kb(F, et));
    mat(W, W * et);
  }
  if (!heads) return n;
  if (!full) {
    mat(16, W * eh);
  } else {
    if (fa_split(W)) {
      mat(16, W * eh);
      mat(W, W * eh);
    } else {
      mat(W + 16, W * eh);
    }
    mat(W / 2, W * eh);
    mat(16, W / 2 * eh);
  }
  return n;
}

// Named barriers of a block beside consumers_sync (1) and warpgroup_sync
// (2, 3): the consumers' heads of a step are written (BAR_HEADS), the
// compositing warp has made the step's stop decision (BAR_COMPOSITED). Each
// counts the 256 consumer threads and the compositing warp.
enum { BAR_HEADS = 4, BAR_COMPOSITED = 5, BAR_PAIR = N_CONSUMERS + 32 };

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The compositing warp, the producer warpgroup's second: one lane per ray,
// front to back over every step the consumers evaluate; it makes each stop
// decision and writes the outputs. It issues no wgmma, so its per-lane
// branches lie on no path between products: on a consumer warp they make
// ptxas serialize every wgmma of the kernel (C7520, the header note).
template <bool DENSITY_ONLY, int ABL>
__device__ __forceinline__ void composite(const float* zs, const float* ds, const float* sig, const float* rgbraw,
                                          float* ray_state, int* flags, float* __restrict__ out, int R, int S,
                                          float eps, int n_groups, int ray0) {
  const int lane = threadIdx.x & 31;
  const int ray = ray0 + lane;
  const bool valid = ray < R;
  float* stt = ray_state + lane * 8;
  for (int g = 0; g < n_groups; ++g) {
    named_sync(BAR_HEADS, BAR_PAIR);
    const float* zg = zs + (g & 1) * MP;
    const float* dg = ds + (g & 1) * MP;
    float T = stt[0];
    for (int sl = 0; sl < SG; ++sl) {
      const int s = g * SG + sl;
      if (s >= S) break;
      const int row = sl * RB + lane;
      if constexpr ((ABL & A_EPI) != 0) {
        // "epilogue": plain adds in the TPU kernel's order, T untouched.
        for (int c = 0; c < 3; ++c) stt[1 + c] = __fadd_rn(__fadd_rn(stt[1 + c], rgbraw[row * 4 + c]), sig[row]);
        continue;
      }
      const float alpha = 1.f - expf(-fmaxf(sig[row], 0.f) * dg[row]);
      const float w = alpha * T;
      if (DENSITY_ONLY) {
        if (valid) out[(size_t)s * R + ray] = w;
      } else if constexpr ((ABL & A_ON) != 0) {
        // K8 composites rgb alone, each product and sum rounded on its own
        // as in the plain version; "heads" has no sigmoid.
        for (int c = 0; c < 3; ++c) {
          const float x = rgbraw[row * 4 + c];
          stt[1 + c] = __fadd_rn(stt[1 + c], __fmul_rn(w, (ABL & A_HEADS) != 0 ? x : 1.f / (1.f + expf(-x))));
        }
      } else {
        for (int c = 0; c < 3; ++c) stt[1 + c] += w * (1.f / (1.f + expf(-rgbraw[row * 4 + c])));
        stt[4] += w * zg[row];
        stt[5] += w;
      }
      T = T * (1.f - alpha + 1e-10f);
    }
    stt[0] = T;
    float tmax = valid ? T : 0.f;
    for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const bool alive = (eps <= 0.f) || (tmax > eps);
    if (lane == 0) flags[0] = alive;
    if (g + 1 == n_groups) break;
    named_arrive(BAR_COMPOSITED, BAR_PAIR);
    if (!alive) break;
  }
  if (!DENSITY_ONLY && valid) {
    out[0 * (size_t)R + ray] = stt[1];
    out[1 * (size_t)R + ray] = stt[2];
    out[2 * (size_t)R + ray] = stt[3];
    out[3 * (size_t)R + ray] = stt[4];
    out[4 * (size_t)R + ray] = stt[5];
    out[5 * (size_t)R + ray] = stt[0];
    out[6 * (size_t)R + ray] = 0.f;
    out[7 * (size_t)R + ray] = 0.f;
  }
}

// One block's work: the served kernels with ABL = 0, K8 with an ablation
// mask (then MODE_INT8, the full pass, eps 0 and `sps` the sample group of
// A_ENC / A_NOCONCAT).
template <int W, int F, int MODE, bool DENSITY_ONLY, int ABL>
__device__ __forceinline__ void render_body(const NetPtrs& net, const Quant& qa, const Stream& st,
                                            const float* __restrict__ o_ph, const float* __restrict__ d_ph,
                                            const float* __restrict__ zv, const float* __restrict__ dv,
                                            const bf16* __restrict__ venc, float* __restrict__ out, int R, int S,
                                            float eps, int* live_groups, int sps) {
  static_assert(ABL == 0 || (MODE == MODE_INT8 && !DENSITY_ONLY), "K8 ablates the int8 full pass");
  typedef Lay<W, F, DENSITY_ONLY, ABL != 0> L;
  constexpr int RING = L::RING, STAGE = L::STAGE, HALF_ = L::HALF_;
  // The trunk's element type; the heads' is s8 only in full int8 mode.
  typedef typename std::conditional<MODE == MODE_BF16, bf16, s8>::type TT;
  typedef typename std::conditional<MODE == MODE_INT8, s8, bf16>::type TH;
  typedef typename Tr<TT>::AccT TAcc;
  typedef typename Tr<TH>::AccT HAcc;
  constexpr int ENC_KB = enc_kb(F, sizeof(TT));

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  unsigned char* E = smem + L::O_ENC;
  float* zs = reinterpret_cast<float*>(smem + L::O_MISC);  // [2][MP], by step parity
  float* ds = zs + 2 * MP;                                   // [2][MP]
  float* sig = ds + 2 * MP;
  float* rgbraw = sig + MP;            // [MP][4]
  float* ray_state = rgbraw + MP * 4;  // [RB][8]: T, r, g, b, depth, acc
  int* flags = reinterpret_cast<int*>(ray_state + RB * 8);  // alive, stop, slabs issued
  void* hvenc = smem + L::O_HV;        // [RB][HALF] fp32 (int32 in int8 mode), full pass only
  const uint32_t full0 = saddr(smem + L::O_BARS), empty0 = full0 + 8 * RING, done = empty0 + 8 * RING;

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * RB;
  const int n_groups = (S + SG - 1) / SG;

  // Set-up by all three warpgroups: barriers, a zeroed encoding tile (its pad
  // columns meet zero weights), the ray state.
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(done, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    flags[0] = 1;
    flags[1] = 0;
    flags[2] = 0;
  }
  for (int i = tid; i < L::ENC_BYTES / 16; i += RK_THREADS) reinterpret_cast<uint4*>(E)[i] = make_uint4(0, 0, 0, 0);
  if (tid < RB) {
    ray_state[tid * 8 + 0] = 1.f;
    for (int k = 1; k < 8; ++k) ray_state[tid * 8 + k] = 0.f;
  }
  __syncthreads();

  // The warpgroup's role, broadcast from lane 0 so that the compiler sees a
  // warp-uniform branch: ptxas then budgets each side's registers by its
  // setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    // The producer warpgroup: one elected thread streams the weights, and
    // its second warp composites.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(RK_PRODUCER_REGS));
    if (tid == N_CONSUMERS)
      produce<RING, STAGE>(st, n_groups, saddr(smem + L::O_STAGES), full0, empty0, done, flags + 1, flags + 2);
    else if (tid / 32 == N_CONSUMERS / 32 + 1)
      composite<DENSITY_ONLY, ABL>(zs, ds, sig, rgbraw, ray_state, flags, out, R, S, eps, n_groups, ray0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(RK_CONSUMER_REGS));

  const int wg = tid >> 7;
  unsigned char* act = smem + L::O_ACT + wg * L::ACT;
  const uint32_t act_s = saddr(act), enc_s = saddr(E) + wg * WG_ROWS * 128;
  Ring ring{saddr(smem + L::O_STAGES), full0, empty0, 0};

  if constexpr (!DENSITY_ONLY) {
    // The view encoding's contribution to the view layer is per ray:
    // W_view_enc . venc, once per ray, not once per sample. In int8 mode it
    // moves to the view accumulator's integer domain with the view bias and
    // the requant rounding offset folded in.
    for (int i = tid; i < RB * HALF_; i += N_CONSUMERS) {
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

  int n_live = 0;
  for (int g = 0; g < n_groups; ++g) {
    // Encode the step's points (row = s_local * RB + ray_local); the
    // compositing warp may still be on the previous step, whose depths and
    // intervals sit in the other half of zs/ds.
    float* zg = zs + (g & 1) * MP;
    float* dg = ds + (g & 1) * MP;
    for (int i = tid; i < MP * 3; i += N_CONSUMERS) {
      const int row = i / 3, c = i % 3;
      const int s = g * SG + row / RB;
      const int ray = min(ray0 + row % RB, R - 1);
      const bool live = s < S;
      const float z = live ? zv[(size_t)s * R + ray] : 0.f;
      const float o = o_ph[(size_t)c * R + ray], d = d_ph[(size_t)c * R + ray];
      const SwRow e{E + row * 128, row};
      if constexpr (MODE == MODE_BF16) {
        encode_coord_sw<F>(e, c, o + z * d);
      } else if constexpr ((ABL & (A_ENC | A_NOCONCAT)) != 0) {
        if (s % sps == 0) encode_coord_q<F>(e, c, o, z, d, qa.qscale);
      } else if constexpr ((ABL & A_NOBASE) != 0) {
        encode_coord_nobase_q<F>(e, c, o, z, d, qa.qscale);
      } else if constexpr ((ABL & A_DIRECT) == 0) {
        encode_coord_q<F>(e, c, o, z, d, qa.qscale);
      }
      if (c == 0) {
        zg[row] = z;
        dg[row] = live ? dv[(size_t)s * R + ray] : 0.f;  // dist 0: alpha 0
      }
    }
    if constexpr ((ABL & (A_DIRECT | A_ENC | A_NOCONCAT)) != 0)
      ablate_encode<F, ABL>(E, smem + L::O_CACHE, o_ph, d_ph, zv, R, S, g, ray0, sps, qa.qscale);
    fence_proxy_async();
    consumers_sync();

    // The stop decision, made by the compositing warp for the step before,
    // broadcast so that the compiler sees a uniform branch.
    if (g > 0) named_sync(BAR_COMPOSITED, BAR_PAIR);
    if (!__shfl_sync(0xffffffffu, flags[0], 0)) {
      // Every ray of the block is saturated: the remaining samples carry
      // weight < eps. The density pass still owes their (zero) weights.
      if (DENSITY_ONLY) {
        for (int i = tid; i < (S - g * SG) * RB; i += N_CONSUMERS) {
          const int s = g * SG + i / RB, ray = ray0 + i % RB;
          if (ray < R) out[(size_t)s * R + ray] = 0.f;
        }
      }
      if (tid == 0) {
        // Drain: wait for every slab the producer issued past this step.
        *(volatile int*)(flags + 1) = 1;
        mbar_wait(done, 0);
        const int issued = *(volatile int*)(flags + 2);
        for (int k = ring.k; k < issued; ++k) mbar_wait(full0 + 8 * (k % RING), (k / RING) & 1);
      }
      break;
    }
    ++n_live;

    // Density trunk, this warpgroup's 64 rows, as straight runs of products
    // in the stream's slab order: layer 0 on the encoding; the hidden layers
    // before the skip layer; the skip layer (its encoding product, the skip
    // shift in the int8 modes, then its hidden product adding to it); the
    // hidden layers after it. A net with no skip layer (or with it at layer
    // 0) has no skip block. Every layer's accumulators sit in the same
    // registers, and no layer tests which products to issue or shifts by 0.
    {
      TAcc acc[W / 2];
      TAcc none[1];
      constexpr int KT = W * (int)sizeof(TT);
      const int skip = net.skip_layer > 0 && net.skip_layer < net.depth ? net.skip_layer : net.depth;
      // Layer i's epilogue, written over this warpgroup's activation rows.
      auto finish = [&](int i) {
        if constexpr (MODE == MODE_BF16) {
          epilogue<E_BF16_RELU, W>(acc, act, net.b[i], nullptr, 0, 0);
        } else {
          if (MODE == MODE_INT8_TRUNK && i == net.depth - 1)
            epilogue<E_Q_TO_BF16, W>(acc, act, net.b[i], nullptr, 0, 0);
          else
            epilogue<E_Q_RELU, W>(acc, act, net.b[i], nullptr, 0, qa.shift[i]);
        }
        fence_proxy_async();
        warpgroup_sync();
      };
      product<TT, W, 0, ENC_KB, RING, STAGE>(acc, none, enc_s, 0, ring);
      finish(0);
      for (int i = 1; i < skip; ++i) {
        product<TT, W, 0, KT, RING, STAGE>(acc, none, act_s, WG_ROWS * 128, ring);
        finish(i);
      }
      if (skip < net.depth) {
        product<TT, W, 0, ENC_KB, RING, STAGE>(acc, none, enc_s, 0, ring);
        if constexpr (MODE != MODE_BF16) {
          const int lsh = max(-qa.skip_shift, 0), rsh = max(qa.skip_shift, 0);
#pragma unroll
          for (int t = 0; t < W / 2; ++t) acc[t] = (acc[t] << lsh) >> rsh;
        }
        product<TT, W, 0, KT, RING, STAGE, false>(acc, none, act_s, WG_ROWS * 128, ring);
        finish(skip);
        for (int i = skip + 1; i < net.depth; ++i) {
          product<TT, W, 0, KT, RING, STAGE>(acc, none, act_s, WG_ROWS * 128, ring);
          finish(i);
        }
      }
    }

    // Heads, on the trunk's last activations h (this warpgroup's rows).
    constexpr int KH = W * (int)sizeof(TH);
    if constexpr ((ABL & A_HEADS) != 0) {
      // "heads": the trunk's first four int8 activations read as sigma, rgb.
      for (int r = tid & 127; r < WG_ROWS; r += 128) {
        const int row = wg * WG_ROWS + r;
        sig[row] = (float)*reinterpret_cast<const s8*>(act + act_off(r, 0));
        for (int c = 0; c < 3; ++c) rgbraw[row * 4 + c] = (float)*reinterpret_cast<const s8*>(act + act_off(r, 1 + c));
      }
    } else if constexpr (DENSITY_ONLY) {
      HAcc a16[8], none[1];
      product<TH, 16, 0, KH, RING, STAGE>(a16, none, act_s, WG_ROWS * 128, ring);
      if constexpr (MODE == MODE_INT8)
        epilogue_out<E_Q_ALPHA, 16, 0>(a16, net.b_alpha, qa.s_alpha, sig, 1, 0, 1);
      else
        epilogue_out<E_F32, 16, 0>(a16, net.b_alpha, 0.f, sig, 1, 0, 1);
    } else {
      constexpr int E_FEAT = MODE == MODE_INT8 ? E_Q_FEAT : E_BF16_LIN;
      constexpr int E_ALPHA = MODE == MODE_INT8 ? E_Q_ALPHA : E_F32;
      if constexpr (fa_split(W)) {
        // Alpha, then the features over h: 128 accumulators at a time.
        HAcc a16[8], none[1];
        product<TH, 16, 0, KH, RING, STAGE>(a16, none, act_s, WG_ROWS * 128, ring);
        epilogue_out<E_ALPHA, 16, 0>(a16, net.b_alpha, qa.s_alpha, sig, 1, 0, 1);
        HAcc fa[W / 2];
        product<TH, W, 0, KH, RING, STAGE>(fa, none, act_s, WG_ROWS * 128, ring);
        epilogue<E_FEAT, W>(fa, act, net.b_feat, nullptr, 0, qa.k_feat);
      } else {
        // Feature and alpha in one pass; features over h, alpha to sig.
        HAcc fa[(W + 16) / 2], none[1];
        product<TH, W + 16, 0, KH, RING, STAGE>(fa, none, act_s, WG_ROWS * 128, ring);
        epilogue<E_FEAT, W + 16, W>(fa, act, net.b_feat, nullptr, 0, qa.k_feat);
        epilogue_out<E_ALPHA, W + 16, W / 8>(fa, net.b_alpha, qa.s_alpha, sig, 1, W, 1);
      }
      fence_proxy_async();
      warpgroup_sync();
      {
        HAcc hv[HALF_ / 2], none[1];
        product<TH, HALF_, 0, KH, RING, STAGE>(hv, none, act_s, WG_ROWS * 128, ring);
        if constexpr (MODE == MODE_INT8)
          epilogue<E_Q_VIEW, HALF_>(hv, act, nullptr, hvenc, HALF_, qa.k_hv);
        else
          epilogue<E_BF16_VIEW, HALF_>(hv, act, net.b_view, hvenc, HALF_, 0);
      }
      fence_proxy_async();
      warpgroup_sync();
      {
        HAcc rgb[8], none[1];
        product<TH, 16, 0, HALF_ * (int)sizeof(TH), RING, STAGE>(rgb, none, act_s, WG_ROWS * 128, ring);
        if constexpr ((ABL & A_EPI) != 0)
          epilogue_out<E_Q_RAW, 16, 0>(rgb, nullptr, 0.f, rgbraw, 4, 0, 3);
        else if constexpr (MODE == MODE_INT8)
          epilogue_out<E_Q_RGB, 16, 0>(rgb, net.b_rgb, qa.s_rgb, rgbraw, 4, 0, 3);
        else
          epilogue_out<E_F32, 16, 0>(rgb, net.b_rgb, 0.f, rgbraw, 4, 0, 3);
      }
    }
    consumers_sync();
    named_arrive(BAR_HEADS, BAR_PAIR);
  }

  if (live_groups != nullptr && tid == 0) atomicAdd(live_groups, n_live);
}

template <int W, int F, int MODE, bool DENSITY_ONLY>
__global__ void __launch_bounds__(RK_THREADS, 1)
render_kernel(const __grid_constant__ NetPtrs net, const __grid_constant__ Quant qa,
              const __grid_constant__ Stream st, const float* __restrict__ o_ph, const float* __restrict__ d_ph,
              const float* __restrict__ zv, const float* __restrict__ dv, const bf16* __restrict__ venc,
              float* __restrict__ out, int R, int S, float eps, int* live_groups) {
  render_body<W, F, MODE, DENSITY_ONLY, 0>(net, qa, st, o_ph, d_ph, zv, dv, venc, out, R, S, eps, live_groups, 1);
}

template <int W, int F, int MODE, bool DENSITY_ONLY>
cudaError_t launch(const NetPtrs& net, const Quant& qa, const Stream& st, const float* o_ph, const float* d_ph,
                   const float* z, const float* dists, const bf16* venc, float* out, int n_rays, int n_samples,
                   float eps, int* live_groups, cudaStream_t cs) {
  const int smem = Lay<W, F, DENSITY_ONLY, false>::BYTES;
  auto kernel = render_kernel<W, F, MODE, DENSITY_ONLY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rays + RB - 1) / RB);
  kernel<<<grid, RK_THREADS, smem, cs>>>(net, qa, st, o_ph, d_ph, z, dists, venc, out, n_rays, n_samples, eps,
                                         live_groups);
  return cudaGetLastError();
}

template <int W, int F, bool DENSITY_ONLY>
cudaError_t launch_mode(int mode, const NetPtrs& net, const Quant& qa, const Stream& st, const float* o_ph,
                        const float* d_ph, const float* z, const float* dists, const bf16* venc, float* out,
                        int n_rays, int n_samples, float eps, int* live_groups, cudaStream_t cs) {
  switch (mode) {
    case MODE_BF16:
      return launch<W, F, MODE_BF16, DENSITY_ONLY>(net, qa, st, o_ph, d_ph, z, dists, venc, out, n_rays,
                                                   n_samples, eps, live_groups, cs);
    case MODE_INT8_TRUNK:
      return launch<W, F, MODE_INT8_TRUNK, DENSITY_ONLY>(net, qa, st, o_ph, d_ph, z, dists, venc, out, n_rays,
                                                         n_samples, eps, live_groups, cs);
    case MODE_INT8:
      return launch<W, F, MODE_INT8, DENSITY_ONLY>(net, qa, st, o_ph, d_ph, z, dists, venc, out, n_rays,
                                                   n_samples, eps, live_groups, cs);
  }
  return cudaErrorInvalidValue;
}

#if RENDER_ABLATE
template <int W, int F, int ABL>
__global__ void __launch_bounds__(RK_THREADS, 1)
ablation_kernel(const __grid_constant__ NetPtrs net, const __grid_constant__ Quant qa,
                const __grid_constant__ Stream st, const float* __restrict__ o_ph, const float* __restrict__ d_ph,
                const float* __restrict__ zv, const float* __restrict__ dv, const bf16* __restrict__ venc,
                float* __restrict__ out, int R, int S, int sps) {
  render_body<W, F, MODE_INT8, false, ABL | A_ON>(net, qa, st, o_ph, d_ph, zv, dv, venc, out, R, S, 0.f, nullptr,
                                                  sps);
}

template <int W, int F, int ABL>
cudaError_t launch_ablation(const NetPtrs& net, const Quant& qa, const Stream& st, const float* o_ph,
                            const float* d_ph, const float* z, const float* dists, const bf16* venc, float* out,
                            int n_rays, int n_samples, int sps, cudaStream_t cs) {
  const int smem = Lay<W, F, false, true>::BYTES;
  auto kernel = ablation_kernel<W, F, ABL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rays + RB - 1) / RB);
  kernel<<<grid, RK_THREADS, smem, cs>>>(net, qa, st, o_ph, d_ph, z, dists, venc, out, n_rays, n_samples, sps);
  return cudaGetLastError();
}
#endif

// Biases and quantization of one launch (the C entries' layout; the weight
// pointers of `ptrs` are not read: the weights arrive through the stream).
static void unpack_net(const void* const* ptrs, int depth, int skip_layer, int mode, const int* ishift,
                       const float* fscale, NetPtrs& net, Quant& qa) {
  int k = 0;
  for (int i = 0; i < depth; ++i) {
    ++k;  // w_i
    net.b[i] = ptrs[k++];
  }
  for (int i = depth; i < MAXD; ++i) net.b[i] = nullptr;
  ++k;  // w_skip
  ++k;  // w_alpha
  net.b_alpha = ptrs[k++];
  ++k;  // w_feat
  net.b_feat = ptrs[k++];
  ++k;  // w_view_h
  net.w_view_enc = static_cast<const bf16*>(ptrs[k++]);
  net.b_view = static_cast<const float*>(ptrs[k++]);
  ++k;  // w_rgb
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

// The stream table of one launch, held against the slabs the consumers take
// (stream_rows): false if a count or a size differs.
static bool unpack_stream(const void* base, const int* off, const int* bytes, int n, int mode, bool full,
                          bool heads, int depth, int skip_layer, Stream& st) {
  int rows[MAX_SLABS];
  const int want = stream_rows(RENDER_WIDTH, RENDER_FREQS, mode, full, heads, depth, skip_layer, rows);
  if (base == nullptr || n != want || n > MAX_SLABS) return false;
  st.base = static_cast<const unsigned char*>(base);
  st.n = n;
  for (int j = 0; j < n; ++j) {
    if (bytes[j] != rows[j] * 128 || off[j] % 128 != 0) return false;
    st.off[j] = off[j];
    st.bytes[j] = bytes[j];
  }
  return true;
}

}  // namespace rk

// RENDER_FULL=0 builds the density-only kernels alone (the proposal shape).
#ifndef RENDER_FULL
#define RENDER_FULL 1
#endif

// ptrs: device pointers in this order: w_0, b_0, ..., w_{depth-1}, b_{depth-1},
// w_skip, w_alpha, b_alpha, w_feat, b_feat, w_view_h, w_view_enc, b_view,
// w_rgb, b_rgb (the full-mode entries may be null in density-only mode; the
// weights w_* other than w_view_enc are not read). Biases fp32 (mode 0) or
// int32 (trunk in modes 1-2, feature and alpha in mode 2); w_view_enc,
// b_view and b_rgb are always bf16/fp32. stream: the packed weights
// (ops/fused_render.py::pack_weight_stream) on the device; slab_off and
// slab_bytes (host memory) the n_slabs slabs of one step of this pass. ishift:
// depth per-layer shifts, then skip_shift, k_feat, k_hv; fscale: qscale,
// s_alpha, inv_s_view, s_rgb (host memory; ignored in mode 0). Inputs are
// ray-minor: o_ph, d_ph [>=3, R] (rows 0-2 read), z and dists [S, R] fp32,
// venc [32, R] bf16. out: [S, R] weights (density-only) or [8, R] maps (rows
// 0-2 rgb, 3 depth, 4 acc, 5 transmittance). importance_only: the density
// pass's weights feed importance-only placement; its blocks then stop at T <=
// min(eps, PDF_GUARD / n_samples) (the note at the top). live_groups, if not
// null, gains the number of 4-sample steps each block evaluated. Returns the
// CUDA error code of the launch (0 on success).
#if !RENDER_ABLATE
extern "C" int nerf_render_launch(const void* const* ptrs, int width, int pts_freqs, int depth,
                                  int skip_layer, int mode, const int* ishift, const float* fscale,
                                  const void* stream, const int* slab_off, const int* slab_bytes, int n_slabs,
                                  const float* o_ph, const float* d_ph, const float* z,
                                  const float* dists, const void* venc, float* out, int n_rays,
                                  int n_samples, int density_only, float eps, int importance_only,
                                  int* live_groups, void* cuda_stream) {
  if (width != RENDER_WIDTH || pts_freqs != RENDER_FREQS || depth < 1 || depth > MAXD || n_rays < 1 ||
      n_samples < 1 || mode < 0 || mode > 2 || (!density_only && !RENDER_FULL))
    return (int)cudaErrorInvalidValue;
  rk::NetPtrs net;
  rk::Quant qa;
  rk::Stream st;
  rk::unpack_net(ptrs, depth, skip_layer, mode, ishift, fscale, net, qa);
  if (!rk::unpack_stream(stream, slab_off, slab_bytes, n_slabs, mode, !density_only, true, depth, skip_layer, st))
    return (int)cudaErrorInvalidValue;
  if (density_only && importance_only && eps > 0.f) eps = fminf(eps, PDF_GUARD / (float)n_samples);
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const bf16* v = static_cast<const bf16*>(venc);
  cudaError_t err;
  if (density_only) {
    err = rk::launch_mode<RENDER_WIDTH, RENDER_FREQS, true>(mode, net, qa, st, o_ph, d_ph, z, dists, v, out,
                                                           n_rays, n_samples, eps, live_groups, cs);
  } else {
#if RENDER_FULL
    err = rk::launch_mode<RENDER_WIDTH, RENDER_FREQS, false>(mode, net, qa, st, o_ph, d_ph, z, dists, v, out,
                                                            n_rays, n_samples, eps, live_groups, cs);
#else
    err = cudaErrorInvalidValue;
#endif
  }
  return (int)err;
}
#else
// K8: one ablation launch of the int8 full pass. ptrs, ishift, fscale,
// stream, slab_off, slab_bytes (the full pass's table), z, dists and venc as
// nerf_render_launch takes them (mode 2); "heads" streams the table's first
// n_trunk_slabs alone. o_ph and d_ph hold every encoding row, [round_up(3 +
// 6F, 8), R] ("enc-direct" reads them all); samples_per_step is the sample
// group of "enc"/"enc-noconcat", a power of two dividing n_samples; mask is
// 0 (the full mode's code) or one of the A_* combinations the switch lists.
// out: [8, R], rows 0-2 the rgb sum, row 5 the final T, the rest 0.
extern "C" int nerf_ablation_launch(const void* const* ptrs, int width, int pts_freqs, int depth,
                                    int skip_layer, const int* ishift, const float* fscale, const void* stream,
                                    const int* slab_off, const int* slab_bytes, int n_slabs, int n_trunk_slabs,
                                    const float* o_ph, const float* d_ph, const float* z, const float* dists,
                                    const void* venc, float* out, int n_rays, int n_samples, int samples_per_step,
                                    int mask, void* cuda_stream) {
  using namespace rk;
  const int sps = samples_per_step;
  if (width != RENDER_WIDTH || pts_freqs != RENDER_FREQS || depth < 1 || depth > MAXD || n_rays < 1 ||
      n_samples < 1 || sps < 1 || (sps & (sps - 1)) != 0 || n_samples % sps != 0)
    return (int)cudaErrorInvalidValue;
  NetPtrs net;
  Quant qa;
  Stream st;
  unpack_net(ptrs, depth, skip_layer, MODE_INT8, ishift, fscale, net, qa);
  const bool heads = (mask & A_HEADS) == 0;
  if (!unpack_stream(stream, slab_off, slab_bytes, heads ? n_slabs : n_trunk_slabs, MODE_INT8, true, heads, depth,
                     skip_layer, st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const bf16* v = static_cast<const bf16*>(venc);
#define ABLATION_CASE(M)                                                                                       \
  case M:                                                                                                      \
    return (int)launch_ablation<RENDER_WIDTH, RENDER_FREQS, M>(net, qa, st, o_ph, d_ph, z, dists, v, out, n_rays, \
                                                               n_samples, sps, cs)
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
