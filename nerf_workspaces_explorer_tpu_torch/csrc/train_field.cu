// The fused NeRF training field for Hopper (sm_90a): forward (K4) and
// backward (K5) of encode + MLP over free sample points, built once per
// network shape (the stock 8x256@10f/4f net; the 2x64@6f/2f proposal net;
// the distilled students 6x192@10f/4f and 4x128@8f/4f).
//
// Replaces: nerf_workspaces_explorer_tpu/ops/pallas_train.py::_fwd_kernel
//   (via _run_fwd) and ::_bwd_kernel (via _run_bwd), the custom-VJP field
//   the JAX package trains with on its accelerator.
//
// What bounds them on this card (the stock net). Operations: the forward costs 2 x 593k
//   FLOP a point against 32 bytes of point input and output, the backward
//   about three times that (recomputed forward, input-gradient chain,
//   weight-gradient products); at a step's 65,536 coarse + 196,608 fine
//   points that is 0.315 ms (K4) and 0.925 ms (K5) at the bf16 peak. Bytes:
//   K5's design moves more than its inputs. Its chain kernel writes each
//   layer's bf16 input and cotangent to a scratch (4,976 bf16, 9.95 KB a
//   point at the stock net) that its weight-gradient kernel reads back: 2.6
//   GB written and 2.6 GB read a step, 1.56 ms at 3.35 TB/s. That round
//   trip is the design's bytes bound, and it exceeds the operations bound.
//   chip_smoke.py prints both bounds. Besides, each 128-point tile of the
//   chain reads the backward weight stream from the L2 (2.36 MB at the
//   stock net, 18 KB a point), so the L2 carries those reads beside the
//   scratch's writes and their write-back.
//
// What the design does about it: every product is a bf16 wgmma with fp32
//   accumulators in registers, on the render kernel's block (hopper.cuh).
//   - K4 (field_fwd_kernel) and the chain kernel are persistent blocks of
//     three warpgroups walking 128-point tiles: one producer thread bulk-
//     copies the net's weights, packed on the device every step into a
//     stream of 128-byte-swizzled slabs in consumption order
//     (ops/fused_field.py::pack_field_stream; the forward table, and the
//     backward table that adds the transposes), through a ring of stages;
//     two consumer warpgroups own 64 points each and write every epilogue
//     over their own activation rows. The view layer's concat is a second
//     product against the view encoding tile.
//   - K5 is split in three kernels, deterministic by construction, no atomics:
//     field_bwd_chain_kernel recomputes the forward (saving each layer's
//     bf16 output and the encodings to the scratch), then runs the input-
//     gradient chain (W^T products of the bf16 cotangent; ReLU masks from the
//     recomputed bf16 activations, compared in fp32, kept from the recompute
//     as one bit per accumulator of the thread), writing each layer's bf16
//     cotangent to the scratch and, per warpgroup, its fp32 bias-gradient
//     row (a fixed shuffle tree and warp order) to `dbpart`. The scratch
//     leaves by TMA tensor stores straight from the swizzled regions
//     (`ScratchMaps`: one tensor map an array, 64 x 64 boxes, rows past n
//     and columns past the array's clipped by the hardware), so the
//     consumer threads copy nothing. After an epilogue's proxy fence and
//     warpgroup barrier, one thread of the warpgroup issues a store a
//     64-column block of its activation region, with an L2 evict-first
//     policy, and commits them as one bulk group: inside the next product,
//     once the loads that product still waits for are ahead of them
//     (`product_then_store`; at width 256 after 2 of a layer's 4 slabs,
//     at the other widths before its first), or at once where no product
//     reads the region next (the view layer's output, the last cotangent).
//     The rows of E and V leave at the recompute's start. The waits
//     (`cp.async.bulk.wait_group.read` by that thread, then the
//     warpgroup's barrier) guard each region against its next write: the
//     activation region before every epilogue (`region_free`); the
//     warpgroup's rows of E, before the head cotangents go in, by the
//     first epilogue's wait; E and V before the next tile's encoding, by a
//     wait for all but the newest group ahead of the consumers' barrier.
//     Every store completes before the block exits. The head cotangents
//     (16 columns) and the bias rows stay thread stores. The two warpgroups
//     never wait for each other inside a tile. field_dw_kernel forms every
//     dW = G^T H over one chunk of points per block with wgmma, both
//     operands point-major in shared memory (MN-major: wgmma's transpose
//     bits, no transpose pass), fed by a cp.async pipeline; sum_rows_kernel
//     sums the chunks' partials (and the bias rows over tiles) in a fixed
//     order.
//   Fusing the dW products into the chain would remove the scratch; the
//   chain would then need every layer's dW accumulators at once.
//   - The 2x64 proposal net (no skip) runs the same kernels at width 64:
//     its encodings (39 and 15 columns, padded to 40 and 16) enter wgmma
//     in 48- and 16-deep k-steps over zero pad columns, its view layer is
//     an m64n32 product, and its dW blocks are one warpgroup of 64 x 64.
//     At ~0.3 MFLOP a point it is held by latency, not by the tensor cores.
//   - The students (the turbo preset's nets, trained by distillation) run
//     the same kernels at widths 192 and 128: 2 x 0.27 MFLOP (6x192@10f)
//     and 2 x 0.08 MFLOP (4x128@8f) a point forward, so at a step's
//     196,608 fine points their bound is ~0.1 ms and ~0.03 ms (K4) at the
//     bf16 peak, K5 about three times that. What the widths change: a
//     192-wide layer is 384 bytes deep (three slabs) and its view layer 192
//     (a full slab, then a 64-byte one: `product` issues two k-steps
//     there); the point encoding at F = 8 has 51 columns (laid out as 56,
//     one 64-deep k-step over zero pads). Shared memory sets the ring: a
//     slab stage is WIDTH x 128 bytes, so the ring holds 3 stages at 256, 5
//     at 192 (220 KB in all) and 8 below. The dW blocks stay two
//     warpgroups of 64 rows with every column: 192 columns are three
//     64-column blocks of a stage, a count that is not a power of two, so
//     the stage loader divides there where the other widths shift; a
//     192-row dW takes two 128-row blocks, the second half empty (loads of
//     zeros, no stores). A depth-6 student with the default skip takes it
//     at layer 5, inside its trunk; a depth-4 one has none.

#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder itself is reached through the runtime

#include "hopper.cuh"

// One library per network shape: this file compiles with -DFIELD_WIDTH=W,
// -DFIELD_PTS_FREQS=F and -DFIELD_VIEW_FREQS=V for each shape the training
// path runs (ops/_build.py::FIELD_SHAPES): the stock 8x256@10f/4f net, the
// 2x64@6f/2f proposal net and the 6x192@10f/4f and 4x128@8f/4f students.
// The defaults are the stock net's.
#ifndef FIELD_WIDTH
#define FIELD_WIDTH 256
#endif
#ifndef FIELD_PTS_FREQS
#define FIELD_PTS_FREQS 10
#endif
#ifndef FIELD_VIEW_FREQS
#define FIELD_VIEW_FREQS 4
#endif

#define WIDTH FIELD_WIDTH
#define HALF (WIDTH / 2)      // view layer width
#define PTS_FREQS FIELD_PTS_FREQS
#define VIEW_FREQS FIELD_VIEW_FREQS
#define ENC ((3 + 6 * PTS_FREQS + 7) / 8 * 8)  // point encoding columns (64 at F = 10, 40 at F = 6)
#define VENC ((3 + 6 * VIEW_FREQS + 7) / 8 * 8)  // view encoding columns (32 at F = 4, 16 at F = 2)
#define ENC_K ((ENC + 15) / 16 * 16)    // their depth in wgmma's 16-value k-steps (the encoding
#define VENC_K ((VENC + 15) / 16 * 16)  // tiles' pad columns are zero)
#define GH 16                 // head-cotangent columns: 0-2 rgb, GH_SIGMA sigma
#define GH_SIGMA 8
#define MAXD 16
#define MAX_FIELD_SLABS 160   // slabs of one tile's weight stream (backward, 16 layers: 139)
#define FRING (WIDTH >= 256 ? 3 : WIDTH >= 192 ? 5 : 8)  // weight ring stages, as many as shared memory holds
#define FSTAGE (WIDTH * 128)  // the largest slab: WIDTH rows x 128 bytes
#define BITW(N) (((N) + 63) / 64)  // ReLU-mask words of a thread's N / 2 accumulators
#define DW_BP 64              // points per stage of the dW products
#define DW_STAGES 4
#define DW_TILE (DW_BP * 128)  // one 64-column block of a stage: 64 points x 128 bytes
#define DW_N WIDTH            // dW columns of a block (every dW has at most WIDTH)
#define DW_HB (DW_N / 64)     // H column blocks of a stage
#define DW_HB_LOG2 (DW_HB == 4 ? 2 : DW_HB == 2 ? 1 : 0)  // where DW_HB is a power of two
#define DW_WG (WIDTH >= 128 ? 2 : 1)  // consumer warpgroups of a dW block, 64 dW rows each
#define DW_WG_LOG2 (DW_WG == 2 ? 1 : 0)
#define DW_M (64 * DW_WG)     // dW rows of a block
#define DW_THREADS (128 * DW_WG)
#define DW_STAGE ((DW_WG + DW_HB) * DW_TILE)  // G: DW_WG column blocks, H: DW_HB
#define MAX_JOBS 24

static_assert(WIDTH == 256 || WIDTH == 192 || WIDTH == 128 || WIDTH == 64,
              "the field kernels are tiled for widths 64, 128, 192 and 256");
static_assert((DW_HB == 3 || DW_HB == (1 << DW_HB_LOG2)) && DW_WG == (1 << DW_WG_LOG2), "dW tiling");

using namespace rk;
typedef StreamT<MAX_FIELD_SLABS> FieldStream;

// Biases; the product weights arrive through the stream.
struct FieldNet {
  const float* b[MAXD];  // layer i: [WIDTH]
  const float* b_alpha;  // [>= 1]
  const float* b_feat;   // [WIDTH]
  const float* b_view;   // [HALF]
  const float* b_rgb;    // [>= 3]
  int depth;
  int skip_layer;        // layer whose input is [encoding, h]; -1 for none
};

// The backward's global scratch, point-major bf16 [n, cols] arrays.
struct Scratch {
  bf16* feat;     // [n, ENC] point encoding (kernel row order)
  bf16* venc;     // [n, VENC] view encoding
  bf16* hs;       // [depth][n, WIDTH] trunk activations h_i
  bf16* feature;  // [n, WIDTH]
  bf16* hv;       // [n, HALF]
  bf16* gh;       // [n, 16] head cotangents: 0-2 rgb, 8 sigma
  bf16* ghv;      // [n, HALF]
  bf16* gfeat;    // [n, WIDTH]
  bf16* g;        // [depth][n, WIDTH] trunk pre-activation cotangents
};

static size_t scratch_elems(int depth, size_t n) {
  return n * (ENC + VENC + (size_t)depth * WIDTH + WIDTH + HALF + GH + HALF + WIDTH + (size_t)depth * WIDTH);
}

static Scratch scratch_layout(bf16* base, int depth, size_t n) {
  Scratch s;
  s.feat = base;
  s.venc = s.feat + n * ENC;
  s.hs = s.venc + n * VENC;
  s.feature = s.hs + n * WIDTH * depth;
  s.hv = s.feature + n * WIDTH;
  s.gh = s.hv + n * HALF;
  s.ghv = s.gh + n * GH;
  s.gfeat = s.ghv + n * HALF;
  s.g = s.gfeat + n * WIDTH;
  return s;
}

// The chain kernel's tensor maps of the scratch arrays (`Scratch`'s, but
// `gh`), each bf16 [layers][n][cols] (layers = depth for hs and g, else 1)
// in boxes of 64 columns x 64 rows under the 128-byte swizzle: the
// shared-memory image of one 64-row column block of an activation region
// (`act_off`) or of a warpgroup's half of E or V.
struct ScratchMaps {
  CUtensorMap feat, venc, hs, feature, hv, ghv, gfeat, g;
};

// Bias-gradient layout (one row of `dbpart` per warpgroup of a tile, and the result):
// db_0 .. db_{depth-1} (WIDTH each), db_feature (WIDTH), db_alpha (8, row 0
// live), db_view (HALF), db_rgb (8, rows 0-2 live).
__host__ __device__ inline int db_size(int depth) { return depth * WIDTH + WIDTH + 8 + HALF + 8; }

// Slab rows of the field's weight stream in the order the consumers take
// them (the packer's order, ops/fused_field.py::pack_field_stream): the
// forward table (K4) or the backward table (the chain kernel). Returns the
// count.
__host__ inline int field_stream_rows(bool backward, int depth, int skip_layer, int* rows) {
  int n = 0;
  auto mat = [&](int nrows, int k_bytes) {
    for (int j = 0; j < (k_bytes + 127) / 128; ++j, ++n)
      if (n < MAX_FIELD_SLABS) rows[n] = nrows;
  };
  mat(WIDTH, ENC * 2);
  for (int i = 1; i < depth; ++i) {
    if (i == skip_layer) mat(WIDTH, ENC * 2);
    mat(WIDTH, WIDTH * 2);
  }
  if (!backward) mat(16, WIDTH * 2);  // alpha
  mat(WIDTH, WIDTH * 2);              // feature
  mat(HALF, WIDTH * 2);               // view: the feature part
  mat(HALF, VENC * 2);                // view: the view-encoding part
  if (!backward) {
    mat(16, HALF * 2);  // rgb
    return n;
  }
  mat(HALF, GH * 2);                                     // rgb^T
  mat(WIDTH, HALF * 2);                                  // view_h^T
  mat(WIDTH, WIDTH * 2);                                 // feature^T
  mat(WIDTH, GH * 2);                                    // alpha^T
  for (int i = depth - 1; i >= 1; --i) mat(WIDTH, WIDTH * 2);  // w_i^T
  return n;
}

// Shared memory of K4 and the chain kernel, bytes from a 1024-aligned base.
struct FLay {
  static constexpr int ACT = WG_ROWS * WIDTH * 2;         // one warpgroup's activations
  static constexpr int O_E = 2 * ACT;                     // point encoding [MP x 128 B]; head cotangents later
  static constexpr int O_V = O_E + MP * 128;              // view encoding [MP x 128 B], 64 B used
  static constexpr int O_STAGES = O_V + MP * 128;
  static constexpr int O_RAW = O_STAGES + FRING * FSTAGE;  // [MP][4] fp32: rgb logits, sigma (K4)
  static constexpr int O_COL = O_RAW + MP * 4 * 4;         // [2 wg][2][4 warps][WIDTH] fp32 column sums (K5)
  static constexpr int O_FLAGS = O_COL + 2 * 8 * WIDTH * 4;
  static constexpr int O_BARS = O_FLAGS + 16;
  static constexpr int BYTES = O_BARS + (2 * FRING + 1) * 8 + 1024;
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
  static_assert(ACT % 1024 == 0 && FSTAGE % 1024 == 0 && O_STAGES % 1024 == 0, "swizzled tiles are 1024-aligned");
};

// ---------------------------------------------------------------------------
// Epilogues, over this warpgroup's 64 rows (points p0w + local row).

// bf16 act = acc + bias (relu'd with RELU) into the activation region;
// with BITS, bit k of bits[] says whether accumulator k's bf16 activation
// is > 0 (the ReLU mask the backward needs, BITW(N) words a thread).
template <int N, bool RELU, bool BITS>
__device__ __forceinline__ void epi_fwd(const float (&d)[N / 2], unsigned char* __restrict__ act,
                                        const float* __restrict__ bias, uint32_t* bits) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  uint32_t w[BITW(N)] = {};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = c0 + 8 * j;
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 4 * j + 2 * h;  // d[k], d[k + 1]: row r0 + 8 h, columns c, c + 1
      float x0 = d[k] + b.x, x1 = d[k + 1] + b.y;
      if constexpr (RELU) {
        x0 = fmaxf(x0, 0.f);
        x1 = fmaxf(x1, 0.f);
      }
      const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
      *reinterpret_cast<__nv_bfloat162*>(act + act_off(r0 + 8 * h, 2 * c)) = v;
      if constexpr (BITS)
        w[k >> 5] |= ((uint32_t)(__low2float(v) > 0.f) << (k & 31)) |
                     ((uint32_t)(__high2float(v) > 0.f) << ((k + 1) & 31));
    }
  }
  if constexpr (BITS) {
#pragma unroll
    for (int q = 0; q < BITW(N); ++q) bits[q] = w[q];
  }
}

// Tensor stores of the scratch (`ScratchMaps`). One thread of a warpgroup
// issues them, predicated on `issue` and not branched: a branch here would
// be a divergent path beside the warpgroup's wgmma. The hardware unswizzles
// each box and clips its rows past n and its columns past the array's. The
// stores carry an L2 evict-first policy: the scratch passes through the L2
// once, and without the hint it competed with the weight stream that every
// tile reads again from the L2 (the 8x256 chain took ~30% longer).
__device__ __forceinline__ void tma_store(const CUtensorMap& map, uint32_t src, int col, int row, int layer,
                                          bool issue) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 pol;\nsetp.ne.b32 p, %5, 0;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "@p cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3, %4}], [%1], pol;\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(&map)),
      "r"(src), "r"(col), "r"(row), "r"(layer), "r"((int)issue)
      : "memory");
}

// This warpgroup's 64 rows of a region of 128-byte column blocks WG_ROWS x
// 128 bytes apart at shared address `src`, columns [0, N), to rows p0w.. of
// `layer` of `map`: one tensor store a 64-column block, committed as one
// bulk group. After the writes' proxy fence and warpgroup barrier.
template <int N>
__device__ __forceinline__ void store_rows(const CUtensorMap& map, uint32_t src, int p0w, int layer, bool issue) {
#pragma unroll
  for (int b = 0; b < (N + 63) / 64; ++b) tma_store(map, src + b * WG_ROWS * 128, 64 * b, p0w, layer, issue);
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.commit_group;\n}\n" ::"r"((int)issue)
               : "memory");
}

// The issuing thread waits until at most PENDING of its newest bulk groups
// have yet to read their shared memory.
template <int PENDING>
__device__ __forceinline__ void stores_read(bool lead) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group.read %1;\n}\n" ::"r"(
                   (int)lead),
               "n"(PENDING)
               : "memory");
}

// The issuing thread waits until all its stores have completed.
__device__ __forceinline__ void stores_done(bool lead) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group 0;\n}\n" ::"r"((int)lead)
               : "memory");
}

// Before an epilogue writes over this warpgroup's activation region: every
// store has read it, and the warpgroup's barrier tells every thread.
__device__ __forceinline__ void region_free(bool lead) {
  stores_read<0>(lead);
  warpgroup_sync();
}

// d (+)= A . B^T over KB bytes as `product` takes it (A this warpgroup's
// rows at `a`, its NS slabs from the ring), with `store()`, the tensor
// stores of the last epilogue, issued inside it. The SM's TMA unit serves
// them beside the producer's slab loads, and they drain at the pace of
// device memory: issued ahead of a load the product still waits for, they
// delay it. When the epilogue ends, the loads of the product's first FRING
// slabs at most have been issued; the load of slab FRING + j follows the
// release of slab j. So the stores go out once this warpgroup has taken
// NS - FRING + 1 slabs (one more than frees those stages, so that the
// other warpgroup has released them too), and before the last: at width
// 256, after 2 of a hidden layer's 4 slabs; at the other widths, whose
// ring holds a whole layer, before the first.
template <int N, int KB, bool ZERO, typename Store>
__device__ __forceinline__ void product_then_store(float (&d)[N / 2], uint32_t a, int a_kbs, Ring& ring,
                                                   Store store) {
  constexpr int NS = (KB + 127) / 128, AFTER = NS - FRING + 1 > 0 ? NS - FRING + 1 : 0;
  constexpr int FIRST = 128 * cmin(AFTER, NS - 1);
  float none[1];
  if constexpr (FIRST > 0) product<bf16, N, 0, FIRST, FRING, FSTAGE, ZERO>(d, none, a, a_kbs, ring);
  store();
  product<bf16, N, 0, KB - FIRST, FRING, FSTAGE, ZERO && FIRST == 0>(d, none, a + FIRST / 128 * a_kbs, a_kbs, ring);
}

// raw[row][col0 + c] = acc[row][c] + bias[c] for c < ncols (a head's first
// 8-column block; the block is copied out before the per-column test).
template <int N>
__device__ __forceinline__ void epi_head(const float (&d)[N / 2], const float* __restrict__ bias, float* raw, int col0,
                                         int ncols) {
  float v[4] = {d[0], d[1], d[2], d[3]};
  fence_acc(v);
  const int t = threadIdx.x & 127;
  const int r0 = (threadIdx.x >> 7) * WG_ROWS + (t >> 5) * 16 + ((t & 31) >> 2);
  const int c0 = 2 * (t & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + (i & 1);
    if (c < ncols) raw[(r0 + 8 * (i >> 1)) * 4 + col0 + c] = v[i] + bias[c];
  }
}

// The cotangent epilogue: g = acc, with MASK zeroed where the forward's bf16
// activation was not > 0 (bit k of bits[] for accumulator k, `epi_fwd`),
// and zero for points >= n, to bf16 in the activation region; each
// column's sum over the warp's 16 rows to colpart[warp of the warpgroup]
// [column], of the fp32 g, or of its bf16 values with ROUND_DB. The sums run
// in a fixed shuffle order, so they are the same bits on every launch.
template <int N, bool MASK, bool ROUND_DB>
__device__ __forceinline__ void epi_grad(const float (&d)[N / 2], unsigned char* __restrict__ act,
                                         const uint32_t* bits, float* __restrict__ colpart, int p0w, int n) {
  const int t = threadIdx.x & 127, lane = threadIdx.x & 31, warp = t >> 5;
  const int r0 = (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const bool live0 = p0w + r0 < n, live1 = p0w + r0 + 8 < n;
  uint32_t w[BITW(N)];
#pragma unroll
  for (int q = 0; q < BITW(N); ++q) w[q] = MASK ? bits[q] : 0xffffffffu;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = c0 + 8 * j;
    float g[4] = {d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]};
    fence_acc(g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * j + i;
      const bool on = ((w[k >> 5] >> (k & 31)) & 1u) && (i < 2 ? live0 : live1);
      g[i] = on ? g[i] : 0.f;
    }
    const __nv_bfloat162 b0 = __floats2bfloat162_rn(g[0], g[1]), b1 = __floats2bfloat162_rn(g[2], g[3]);
    *reinterpret_cast<__nv_bfloat162*>(act + act_off(r0, 2 * c)) = b0;
    *reinterpret_cast<__nv_bfloat162*>(act + act_off(r0 + 8, 2 * c)) = b1;
    float s0 = ROUND_DB ? __low2float(b0) + __low2float(b1) : g[0] + g[2];
    float s1 = ROUND_DB ? __high2float(b0) + __high2float(b1) : g[1] + g[3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4) *reinterpret_cast<float2*>(colpart + warp * WIDTH + c) = make_float2(s0, s1);
  }
}

// After a cotangent epilogue and its warpgroup barrier: db[c] = the
// warpgroup's 4 warps' column sums, in warp order, for c < N (this
// warpgroup's row of the bias-gradient partials).
template <int N>
__device__ __forceinline__ void db_sums(const float* colpart, float* __restrict__ db) {
  for (int c = threadIdx.x & 127; c < N; c += 128) {
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += colpart[w * WIDTH + c];
    db[c] = s;
  }
}

// Encode the tile's points into rows of the swizzled tiles E (point
// encoding of pts * 0.1, F = 10) and V (view encoding, F = 4); points past
// n encode the origin. The pad columns stay as zeroed at the start.
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts, const float* __restrict__ views, int p0,
                                            int n, unsigned char* E, unsigned char* V) {
  for (int i = threadIdx.x; i < MP * 3; i += N_CONSUMERS) {
    const int row = i / 3, c = i % 3, pt = p0 + row;
    const bool live = pt < n;
    const float x = live ? pts[(size_t)c * n + pt] : 0.f;
    const float v = live ? views[(size_t)c * n + pt] : 0.f;
    encode_coord_sw<PTS_FREQS>(SwRow{E + row * 128, row}, c, x * 0.1f);  // x * (1 / scalar_factor)
    encode_coord_sw<VIEW_FREQS>(SwRow{V + row * 128, row}, c, v);
  }
}

// The forward over this warpgroup's rows: trunk, (alpha,) feature, view
// layer (, rgb). K4 (SAVE = false) writes the heads to raw; the chain's
// recompute (SAVE) skips the heads and stores every layer's bf16 output to
// the scratch (`maps`) inside the next layer's product, each epilogue
// waiting until the stores have read the region.
template <bool SAVE>
__device__ __forceinline__ void forward_tile(const FieldNet& net, unsigned char* act, uint32_t act_s, uint32_t enc_s,
                                             uint32_t venc_s, Ring& ring, const ScratchMaps* maps, float* raw,
                                             uint32_t* mbits, int p0w, int n) {
  const bool lead = (threadIdx.x & 127) == 0, issue = lead && p0w < n;
  float acc[WIDTH / 2];
  float none[1];
  // One call site per product kind, so that every layer's accumulators sit
  // in the same registers: zeros, the encoding product on layer 0 and the
  // skip layer, the hidden product.
  for (int i = 0; i < net.depth; ++i) {
#pragma unroll
    for (int t = 0; t < WIDTH / 2; ++t) acc[t] = 0.f;
    if (i == 0 || i == net.skip_layer)
      product<bf16, WIDTH, 0, ENC_K * 2, FRING, FSTAGE, false>(acc, none, enc_s, 0, ring);
    if constexpr (SAVE) {
      if (i > 0)
        product_then_store<WIDTH, WIDTH * 2, false>(acc, act_s, WG_ROWS * 128, ring, [&] {
          store_rows<WIDTH>(maps->hs, act_s, p0w, i - 1, issue);
        });
      region_free(lead);
    } else if (i > 0) {
      product<bf16, WIDTH, 0, WIDTH * 2, FRING, FSTAGE, false>(acc, none, act_s, WG_ROWS * 128, ring);
    }
    epi_fwd<WIDTH, true, SAVE>(acc, act, net.b[i], mbits + i * BITW(WIDTH));
    fence_proxy_async();
    warpgroup_sync();
  }
  if constexpr (!SAVE) {
    float a16[8];
    product<bf16, 16, 0, WIDTH * 2, FRING, FSTAGE>(a16, none, act_s, WG_ROWS * 128, ring);
    epi_head<16>(a16, net.b_alpha, raw, 3, 1);
  }
  // Feature (no activation, reference nerf_model.py:63-64), over h.
  if constexpr (SAVE) {
    product_then_store<WIDTH, WIDTH * 2, true>(acc, act_s, WG_ROWS * 128, ring, [&] {
      store_rows<WIDTH>(maps->hs, act_s, p0w, net.depth - 1, issue);
    });
    region_free(lead);
  } else {
    product<bf16, WIDTH, 0, WIDTH * 2, FRING, FSTAGE>(acc, none, act_s, WG_ROWS * 128, ring);
  }
  epi_fwd<WIDTH, false, false>(acc, act, net.b_feat, nullptr);
  fence_proxy_async();
  warpgroup_sync();
  {
    // hv = relu(W_view_h . feature + W_view_enc . venc + b_view).
    float hv[HALF / 2];
    if constexpr (SAVE)
      product_then_store<HALF, WIDTH * 2, true>(hv, act_s, WG_ROWS * 128, ring, [&] {
        store_rows<WIDTH>(maps->feature, act_s, p0w, 0, issue);
      });
    else
      product<bf16, HALF, 0, WIDTH * 2, FRING, FSTAGE>(hv, none, act_s, WG_ROWS * 128, ring);
    product<bf16, HALF, 0, VENC_K * 2, FRING, FSTAGE, false>(hv, none, venc_s, 0, ring);
    if constexpr (SAVE) region_free(lead);
    epi_fwd<HALF, true, SAVE>(hv, act, net.b_view, mbits + MAXD * BITW(WIDTH));
  }
  fence_proxy_async();
  warpgroup_sync();
  if constexpr (SAVE) store_rows<HALF>(maps->hv, act_s, p0w, 0, issue);
  if constexpr (!SAVE) {
    float rgb[8];
    product<bf16, 16, 0, HALF * 2, FRING, FSTAGE>(rgb, none, act_s, WG_ROWS * 128, ring);
    epi_head<16>(rgb, net.b_rgb, raw, 0, 3);
  }
}

// Block set-up shared by K4 and the chain kernel; returns false on the
// producer warpgroup, whose thread has streamed the weights for every tile
// of the block by then.
struct FBlock {
  unsigned char* smem;
  Ring ring;
  int n_tiles;
};

__device__ __forceinline__ bool field_block(const FieldStream& st, int n, FBlock& b) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  int* flags = reinterpret_cast<int*>(smem + FLay::O_FLAGS);  // stop, slabs issued
  const uint32_t full0 = saddr(smem + FLay::O_BARS), empty0 = full0 + 8 * FRING, done = empty0 + 8 * FRING;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < FRING; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(done, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    flags[0] = 0;
    flags[1] = 0;
  }
  // Zeroed encoding tiles: their pad columns meet zero weights.
  for (int i = tid; i < 2 * MP * 128 / 16; i += RK_THREADS)
    reinterpret_cast<uint4*>(smem + FLay::O_E)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int n_tiles = (n + MP - 1) / MP;
  const int mine = n_tiles > (int)blockIdx.x ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  // The warpgroup's role, broadcast from lane 0 so that the compiler sees a
  // warp-uniform branch (setmaxnreg budgets each side).
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(RK_PRODUCER_REGS));
    if (tid == N_CONSUMERS)
      produce<FRING, FSTAGE>(st, mine, saddr(smem + FLay::O_STAGES), full0, empty0, done, flags, flags + 1);
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(RK_CONSUMER_REGS));
  b.smem = smem;
  b.ring = Ring{saddr(smem + FLay::O_STAGES), full0, empty0, 0};
  b.n_tiles = n_tiles;
  return true;
}

// K4: pts, views [3, n] -> out [8, n] (rows 0-2 rgb logits, 3 sigma, 4-7 0).
__global__ void __launch_bounds__(RK_THREADS, 1)
field_fwd_kernel(const __grid_constant__ FieldNet net, const __grid_constant__ FieldStream st,
                 const float* __restrict__ pts, const float* __restrict__ views, float* __restrict__ out, int n) {
  FBlock b;
  if (!field_block(st, n, b)) return;
  const int tid = threadIdx.x, wg = tid >> 7;
  unsigned char* E = b.smem + FLay::O_E;
  unsigned char* V = b.smem + FLay::O_V;
  float* raw = reinterpret_cast<float*>(b.smem + FLay::O_RAW);
  unsigned char* act = b.smem + wg * FLay::ACT;
  const uint32_t act_s = saddr(act), enc_s = saddr(E) + wg * WG_ROWS * 128, venc_s = saddr(V) + wg * WG_ROWS * 128;
  for (int tile = blockIdx.x; tile < b.n_tiles; tile += gridDim.x) {
    const int p0 = tile * MP;
    consumers_sync();  // the previous tile's reads of E, V and raw are done
    encode_tile(pts, views, p0, n, E, V);
    fence_proxy_async();
    consumers_sync();
    forward_tile<false>(net, act, act_s, enc_s, venc_s, b.ring, nullptr, raw, nullptr, p0 + wg * WG_ROWS, n);
    consumers_sync();
    for (int i = tid; i < 8 * MP; i += N_CONSUMERS) {
      const int r = i / MP, row = i % MP, pt = p0 + row;
      if (pt < n) out[(size_t)r * n + pt] = r < 4 ? raw[row * 4 + r] : 0.f;
    }
  }
}

// K5, first kernel: recompute, input-gradient chain, bias-gradient rows.
__global__ void __launch_bounds__(RK_THREADS, 1)
field_bwd_chain_kernel(const __grid_constant__ FieldNet net, const __grid_constant__ FieldStream st,
                       const float* __restrict__ pts, const float* __restrict__ views,
                       const float* __restrict__ g_raw, bf16* __restrict__ gh,
                       const __grid_constant__ ScratchMaps maps, float* __restrict__ dbpart, int n) {
  FBlock b;
  if (!field_block(st, n, b)) return;
  const int tid = threadIdx.x, wg = tid >> 7, L = net.depth;
  const bool lead = (tid & 127) == 0;  // the thread that issues and waits for the warpgroup's tensor stores
  unsigned char* E = b.smem + FLay::O_E;
  unsigned char* V = b.smem + FLay::O_V;
  float* colpart0 = reinterpret_cast<float*>(b.smem + FLay::O_COL) + wg * 2 * 4 * WIDTH;
  unsigned char* act = b.smem + wg * FLay::ACT;
  const uint32_t act_s = saddr(act), enc_s = saddr(E) + wg * WG_ROWS * 128, venc_s = saddr(V) + wg * WG_ROWS * 128;
  float none[1];
  // The recompute's ReLU masks, one bit per accumulator of this thread
  // (`epi_fwd`): BITW(WIDTH) words per trunk layer, then the view layer's.
  uint32_t mbits[MAXD * BITW(WIDTH) + BITW(HALF)];
  for (int tile = blockIdx.x; tile < b.n_tiles; tile += gridDim.x) {
    const int p0 = tile * MP, p0w = p0 + wg * WG_ROWS;
    const bool issue = lead && p0w < n;
    // This warpgroup's bias-gradient row: db_0 .. db_{L-1}, feature, alpha,
    // view, rgb (db_size).
    float* db_row = dbpart + (size_t)(2 * tile + wg) * db_size(L);
    int par = 0;  // which of the warpgroup's two column-sum buffers

    // 1. Recompute the forward, storing every layer's input. Both
    // warpgroups' stores of E and V have read them: every group but the
    // newest (the last cotangent's, from act, which the first epilogue
    // waits for).
    stores_read<1>(lead);
    consumers_sync();
    encode_tile(pts, views, p0, n, E, V);
    fence_proxy_async();
    consumers_sync();
    store_rows<ENC>(maps.feat, enc_s, p0w, 0, issue);
    store_rows<VENC>(maps.venc, venc_s, p0w, 0, issue);
    forward_tile<true>(net, act, act_s, enc_s, venc_s, b.ring, &maps, nullptr, mbits, p0w, n);

    // 2. Head cotangents, bf16, into this warpgroup's rows of E (whose
    // stores the first epilogue's wait saw read): columns 0-2 rgb, GH_SIGMA
    // sigma (only rgb rows 0-2 and sigma row 3 of g_raw are live); the same
    // rows to the scratch.
    for (int i = tid & 127; i < WG_ROWS * GH; i += 128) {
      const int r = i / GH, c = i % GH, pt = p0w + r, row = wg * WG_ROWS + r;
      float v = 0.f;
      if (pt < n && c < 3) v = g_raw[(size_t)c * n + pt];
      if (pt < n && c == GH_SIGMA) v = g_raw[(size_t)3 * n + pt];
      const bf16 vb = __float2bfloat16(v);
      *reinterpret_cast<bf16*>(SwRow{E + row * 128, row}.at(2 * c)) = vb;
      if (pt < n) gh[(size_t)pt * GH + c] = vb;
    }
    const int t = tid & 127;
    if (t < 4) {  // db_rgb, db_alpha: fp32 sums of the fp32 cotangent, in point order
      float s = 0.f;
      for (int r = 0; r < WG_ROWS && p0w + r < n; ++r) s += g_raw[(size_t)t * n + p0w + r];
      if (t < 3) db_row[(L + 1) * WIDTH + 8 + HALF + t] = s;  // db_rgb
      else db_row[(L + 1) * WIDTH] = s;                           // db_alpha
    } else if (t < 9) {
      db_row[(L + 1) * WIDTH + 8 + HALF + t - 1] = 0.f;  // db_rgb rows 3-7
    } else if (t < 16) {
      db_row[(L + 1) * WIDTH + t - 8] = 0.f;  // db_alpha rows 1-7
    }
    fence_proxy_async();
    warpgroup_sync();

    // 3. g_hv = mask(hv) * (W_rgb^T g_rgb); db_view sums its bf16 values.
    {
      float ghv[HALF / 2];
      product<bf16, HALF, 0, GH * 2, FRING, FSTAGE>(ghv, none, enc_s, 0, b.ring);
      region_free(lead);
      epi_grad<HALF, true, true>(ghv, act, mbits + MAXD * BITW(WIDTH), colpart0 + par * 4 * WIDTH, p0w, n);
    }
    fence_proxy_async();
    warpgroup_sync();
    db_sums<HALF>(colpart0 + par * 4 * WIDTH, db_row + (L + 1) * WIDTH + 8);
    par ^= 1;
    // 4. g_feature = W_view_h^T g_hv (no activation on the feature head).
    float acc[WIDTH / 2];
    product_then_store<WIDTH, HALF * 2, true>(acc, act_s, WG_ROWS * 128, b.ring, [&] {
      store_rows<HALF>(maps.ghv, act_s, p0w, 0, issue);
    });
    region_free(lead);
    epi_grad<WIDTH, false, false>(acc, act, nullptr, colpart0 + par * 4 * WIDTH, p0w, n);
    fence_proxy_async();
    warpgroup_sync();
    db_sums<WIDTH>(colpart0 + par * 4 * WIDTH, db_row + L * WIDTH);
    par ^= 1;
    // 5. g_{L-1} = mask(h_{L-1}) * (W_feature^T g_feature + W_alpha^T g_sigma).
#pragma unroll
    for (int t = 0; t < WIDTH / 2; ++t) acc[t] = 0.f;
    product_then_store<WIDTH, WIDTH * 2, false>(acc, act_s, WG_ROWS * 128, b.ring, [&] {
      store_rows<WIDTH>(maps.gfeat, act_s, p0w, 0, issue);
    });
    product<bf16, WIDTH, 0, GH * 2, FRING, FSTAGE, false>(acc, none, enc_s, 0, b.ring);
    region_free(lead);
    epi_grad<WIDTH, true, false>(acc, act, mbits + (L - 1) * BITW(WIDTH), colpart0 + par * 4 * WIDTH, p0w, n);
    fence_proxy_async();
    warpgroup_sync();
    db_sums<WIDTH>(colpart0 + par * 4 * WIDTH, db_row + (L - 1) * WIDTH);
    par ^= 1;
    // 6. The trunk: g_{i-1} = mask(h_{i-1}) * (W_i^T g_i), down to layer 0
    // (no input gradient into the encoding).
    for (int i = L - 1; i >= 1; --i) {
      product_then_store<WIDTH, WIDTH * 2, true>(acc, act_s, WG_ROWS * 128, b.ring, [&] {
        store_rows<WIDTH>(maps.g, act_s, p0w, i, issue);
      });
      region_free(lead);
      epi_grad<WIDTH, true, false>(acc, act, mbits + (i - 1) * BITW(WIDTH), colpart0 + par * 4 * WIDTH, p0w, n);
      fence_proxy_async();
      warpgroup_sync();
      db_sums<WIDTH>(colpart0 + par * 4 * WIDTH, db_row + (i - 1) * WIDTH);
      par ^= 1;
    }
    store_rows<WIDTH>(maps.g, act_s, p0w, 0, issue);
  }
  stores_done(lead);  // before the block exits
}

// ---------------------------------------------------------------------------
// K5, second kernel: the weight gradients.

// One weight gradient dW [m, k] = G[:, 0:m]^T . H[:, 0:k] over the points
// (k <= WIDTH).
struct DwJob {
  const bf16* g;
  const bf16* h;
  int ldg, ldh, m, k;
  int tile0;       // first 128-row tile's index in the launch
  long long out0;  // offset of this dW in a partial row
};

struct DwJobs {
  DwJob job[MAX_JOBS];
  int n_jobs;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An MN-major operand in the 128-byte swizzle (wgmma's transpose bit): rows
// are points (the K direction), 8-point groups 1024 bytes apart (stride
// byte offset); each row holds 64 values of the M or N direction, whose
// 64-column blocks lie DW_TILE bytes apart (leading byte offset).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(DW_TILE >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Block (tile, chunk): rows [DW_M t, DW_M t + DW_M) of one dW (warpgroup w
// the 64 rows from DW_M t + 64 w), all its columns, over points [chunk *
// blockIdx.y, +chunk), into part[blockIdx.y][out0 + ...]. Each stage holds
// 64 points of G (DW_WG column blocks) and H (DW_HB), point-major rows of
// 128 bytes as the global arrays hold them, loaded by cp.async into the
// swizzled positions; out-of-range values load as zeros. At widths 128-256
// a block is 128 x WIDTH (two warpgroups); at width 64, where every dW is
// at most 64 x 64, one warpgroup of 64 x 64.
__global__ void __launch_bounds__(DW_THREADS, 1)
field_dw_kernel(const __grid_constant__ DwJobs jobs, int n, int chunk, float* __restrict__ part,
                long long part_stride) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = saddr(smem_raw) + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  int j = 0;
  while (j + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const DwJob& jb = jobs.job[j];
  const int m0 = ((int)blockIdx.x - jb.tile0) * DW_M;
  const int begin = blockIdx.y * chunk, end = min(n, begin + chunk);
  const int steps = (end - begin + DW_BP - 1) / DW_BP;
  const int tid = threadIdx.x, wg = tid >> 7;

  auto load = [&](int s) {
    const int pb = begin + s * DW_BP;
    const uint32_t a0 = base + (s % DW_STAGES) * DW_STAGE, b0 = a0 + DW_WG * DW_TILE;
    for (int v = tid; v < DW_BP * 8 * DW_WG; v += DW_THREADS) {
      const int pt = v >> (3 + DW_WG_LOG2), cb = (v >> 3) & (DW_WG - 1), ch = v & 7;
      const int col = m0 + 64 * cb + 8 * ch;
      const bool ok = pb + pt < end && col < jb.m;
      cp_async16(a0 + cb * DW_TILE + swz(pt, 16 * ch), ok ? jb.g + (size_t)(pb + pt) * jb.ldg + col : jb.g, ok);
    }
    for (int v = tid; v < DW_BP * 8 * DW_HB; v += DW_THREADS) {
#if DW_HB == 3
      const int pt = v / (8 * DW_HB), cb = (v >> 3) % DW_HB, ch = v & 7;
#else
      const int pt = v >> (3 + DW_HB_LOG2), cb = (v >> 3) & (DW_HB - 1), ch = v & 7;
#endif
      const int col = 64 * cb + 8 * ch;
      const bool ok = pb + pt < end && col < jb.k;
      cp_async16(b0 + cb * DW_TILE + swz(pt, 16 * ch), ok ? jb.h + (size_t)(pb + pt) * jb.ldh + col : jb.h, ok);
    }
  };

  float acc[DW_N / 2];
#pragma unroll
  for (int i = 0; i < DW_N / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<DW_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // stage s arrived for all; stage s - 1's products completed
    if (s + DW_STAGES - 1 < steps) load(s + DW_STAGES - 1);
    cp_async_commit();
    const uint32_t a0 = base + (s % DW_STAGES) * DW_STAGE, b0 = a0 + DW_WG * DW_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_BP / 16; ++kk)
      wgmma_bf16_mn<DW_N>(acc, desc_mn(a0 + wg * DW_TILE + kk * 2048), desc_mn(b0 + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }

  float* out = part + blockIdx.y * part_stride + jb.out0;
  const int t = tid & 127, lane = tid & 31;
  const int r0 = m0 + wg * WG_ROWS + (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < DW_N / 8; ++jj) {
    float v[4] = {acc[4 * jj], acc[4 * jj + 1], acc[4 * jj + 2], acc[4 * jj + 3]};
    fence_acc(v);
    const int c = c0 + 8 * jj;
    if (c < jb.k) {
      if (r0 < jb.m) *reinterpret_cast<float2*>(out + (size_t)r0 * jb.k + c) = make_float2(v[0], v[1]);
      if (r0 + 8 < jb.m) *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * jb.k + c) = make_float2(v[2], v[3]);
    }
  }
}

// dst[c] = sum_r src[r][c] in a fixed order, the deterministic reduction of
// partial sums over chunks or tiles: a block takes 32 columns; each of its 8
// warps sums one slice of consecutive rows in row order, then the slices
// are added in order.
__global__ void __launch_bounds__(256) sum_rows_kernel(const float* __restrict__ src, int rows, size_t cols,
                                                       float* __restrict__ dst) {
  __shared__ float slices[8][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const size_t c = blockIdx.x * (size_t)32 + lane;
  const int per = (rows + 7) / 8, r0 = slice * per, r1 = min(rows, r0 + per);
  float s = 0.f;
  if (c < cols)
    for (int r = r0; r < r1; ++r) s += src[(size_t)r * cols + c];
  slices[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float total = 0.f;
    for (int k = 0; k < 8; ++k) total += slices[k][lane];
    dst[c] = total;
  }
}

// ---------------------------------------------------------------------------
// Host side.

// Biases in `field_*_launch`'s `biases` array: b_0, ..., b_{depth-1},
// b_alpha, b_feat, b_view, b_rgb, fp32.
static FieldNet unpack_net(const void* const* biases, int depth, int skip_layer) {
  FieldNet net = {};
  for (int i = 0; i < depth; ++i) net.b[i] = static_cast<const float*>(biases[i]);
  net.b_alpha = static_cast<const float*>(biases[depth]);
  net.b_feat = static_cast<const float*>(biases[depth + 1]);
  net.b_view = static_cast<const float*>(biases[depth + 2]);
  net.b_rgb = static_cast<const float*>(biases[depth + 3]);
  net.depth = depth;
  net.skip_layer = skip_layer;
  return net;
}

// The stream table of one launch, held against the slabs the consumers take
// (field_stream_rows): false if a count or a size differs.
static bool unpack_stream(const void* base, const int* off, const int* bytes, int n_slabs, bool backward, int depth,
                          int skip_layer, FieldStream& st) {
  int rows[MAX_FIELD_SLABS];
  const int want = field_stream_rows(backward, depth, skip_layer, rows);
  if (base == nullptr || n_slabs != want || want > MAX_FIELD_SLABS) return false;
  st.base = static_cast<const unsigned char*>(base);
  st.n = n_slabs;
  for (int j = 0; j < n_slabs; ++j) {
    if (bytes[j] != rows[j] * 128 || off[j] % 128 != 0) return false;
    st.off[j] = off[j];
    st.bytes[j] = bytes[j];
  }
  return true;
}

// cuTensorMapEncodeTiled, a driver function, looked up once through the
// runtime, so that the library links against the runtime alone; null if the
// driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 scratch array [layers][rows][cols] at `base`
// (`ScratchMaps`): boxes of 64 columns x WG_ROWS rows x 1 layer, 128-byte
// swizzle.
static bool scratch_map(EncodeTiled encode, CUtensorMap* map, const bf16* base, int cols, int rows, int layers) {
  const cuuint64_t dim[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)layers};
  const cuuint64_t stride[2] = {(cuuint64_t)cols * sizeof(bf16), (cuuint64_t)cols * sizeof(bf16) * rows};
  const cuuint32_t box[3] = {64, WG_ROWS, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base), dim, stride, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

// The current device's setup, made once on each device: its SM count and
// the kernels' opt-in to more than 48 KB of shared memory (an attribute of
// a kernel on one device). The first launch on a device makes it, so a
// CUDA-graph capture, which follows warm launches, never does.
struct DeviceSetup {
  int sms;
  cudaError_t err;
};

static DeviceSetup device_setup() {
  static bool ready[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return {0, err};
  if (dev >= kMaxDevices) return {0, cudaErrorInvalidDevice};
  if (!ready[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(field_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FLay::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(field_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FLay::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(field_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DW_STAGES * DW_STAGE + 1024);
    if (err != cudaSuccess) return {0, err};
    ready[dev] = true;
  }
  return {sms[dev], cudaSuccess};
}

// Blocks of the persistent kernels: one per SM, at most one per tile.
static int field_grid(int n, int sms) {
  const int tiles = (n + MP - 1) / MP;
  return tiles < sms ? tiles : sms;
}

// Sizes of the backward's buffers for `depth` layers and n points: the bf16
// scratch (elements), the dW values (P, in `field_backward_launch`'s order)
// and the bias values (D). Returns 0.
extern "C" int field_backward_sizes(int depth, int skip_layer, long long n, long long* scratch, long long* n_dw,
                                    long long* n_db) {
  *scratch = (long long)scratch_elems(depth, (size_t)n);
  long long p = (long long)WIDTH * ENC;
  for (int i = 1; i < depth; ++i) p += (long long)WIDTH * WIDTH + (i == skip_layer ? WIDTH * ENC : 0);
  p += (long long)WIDTH * WIDTH + 8 * WIDTH + HALF * WIDTH + HALF * VENC + 8 * HALF;
  *n_dw = p;
  *n_db = db_size(depth);
  return 0;
}

// K4: pts, views [3, n] fp32 -> out [8, n] fp32 (rows 0-2 rgb logits, 3
// sigma, 4-7 zero). stream: the packed weights on the device; slab_off and
// slab_bytes (host memory) its forward table of n_slabs slabs. Returns the
// CUDA error code of the launch.
extern "C" int field_forward_launch(const void* const* biases, int depth, int skip_layer, const void* stream,
                                    const int* slab_off, const int* slab_bytes, int n_slabs, const float* pts,
                                    const float* views, float* out, int n, void* cuda_stream) {
  if (depth < 1 || depth > MAXD || n < 1) return (int)cudaErrorInvalidValue;
  FieldStream st;
  if (!unpack_stream(stream, slab_off, slab_bytes, n_slabs, false, depth, skip_layer, st))
    return (int)cudaErrorInvalidValue;
  const FieldNet net = unpack_net(biases, depth, skip_layer);
  const DeviceSetup dev = device_setup();
  if (dev.err != cudaSuccess) return (int)dev.err;
  field_fwd_kernel<<<field_grid(n, dev.sms), RK_THREADS, FLay::BYTES, static_cast<cudaStream_t>(cuda_stream)>>>(
      net, st, pts, views, out, n);
  return (int)cudaGetLastError();
}

// K5: cotangent g_raw [8, n] fp32 (rows 0-3 read) -> dw [P] and db [D] fp32
// (`field_backward_sizes`). dW order, W = WIDTH: for each layer i, dw_i
// [W, in_i] then, for the skip layer, dwskip_i [W, ENC]; then dw_feature
// [W, W], dw_alpha [8, W], dw_view_h [W / 2, W], dw_view_enc [W / 2, VENC],
// dw_rgb [8, W / 2]; each [out, in] row-major, heads padded to 8 rows. stream and
// its backward table as for K4. Buffers the caller allocates: scratch
// (bf16), dbpart [2 ceil(n / 128), D], part [ceil(n / chunk), P]. Four
// launches. Returns the first CUDA error code.
extern "C" int field_backward_launch(const void* const* biases, int depth, int skip_layer, const void* stream,
                                     const int* slab_off, const int* slab_bytes, int n_slabs, const float* pts,
                                     const float* views, const float* g_raw, void* scratch, float* dbpart,
                                     float* part, float* dw, float* db, int n, int chunk, void* cuda_stream) {
  if (depth < 1 || depth > MAXD || n < 1 || chunk < DW_BP || chunk % DW_BP) return (int)cudaErrorInvalidValue;
  FieldStream st;
  if (!unpack_stream(stream, slab_off, slab_bytes, n_slabs, true, depth, skip_layer, st))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(cuda_stream);
  const FieldNet net = unpack_net(biases, depth, skip_layer);
  const Scratch sc = scratch_layout(static_cast<bf16*>(scratch), depth, (size_t)n);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  ScratchMaps maps;
  if (!(scratch_map(encode, &maps.feat, sc.feat, ENC, n, 1) && scratch_map(encode, &maps.venc, sc.venc, VENC, n, 1) &&
        scratch_map(encode, &maps.hs, sc.hs, WIDTH, n, depth) &&
        scratch_map(encode, &maps.feature, sc.feature, WIDTH, n, 1) &&
        scratch_map(encode, &maps.hv, sc.hv, HALF, n, 1) && scratch_map(encode, &maps.ghv, sc.ghv, HALF, n, 1) &&
        scratch_map(encode, &maps.gfeat, sc.gfeat, WIDTH, n, 1) && scratch_map(encode, &maps.g, sc.g, WIDTH, n, depth)))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + MP - 1) / MP;
  const DeviceSetup dev = device_setup();
  if (dev.err != cudaSuccess) return (int)dev.err;
  field_bwd_chain_kernel<<<field_grid(n, dev.sms), RK_THREADS, FLay::BYTES, cs>>>(net, st, pts, views, g_raw, sc.gh,
                                                                                   maps, dbpart, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // The dW jobs, in the order of `dw`.
  DwJobs jobs = {};
  int n_jobs = 0, tiles = 0;
  long long off = 0;
  auto add = [&](const bf16* g, int ldg, int m, const bf16* h, int ldh, int k) {
    DwJob& jb = jobs.job[n_jobs++];
    jb.g = g;
    jb.h = h;
    jb.ldg = ldg;
    jb.ldh = ldh;
    jb.m = m;
    jb.k = k;
    jb.tile0 = tiles;
    jb.out0 = off;
    tiles += (m + DW_M - 1) / DW_M;
    off += (long long)m * k;
  };
  const size_t nn = (size_t)n;
  for (int i = 0; i < depth; ++i) {
    const bf16* gi = sc.g + i * nn * WIDTH;
    if (i == 0) add(gi, WIDTH, WIDTH, sc.feat, ENC, ENC);
    else add(gi, WIDTH, WIDTH, sc.hs + (i - 1) * nn * WIDTH, WIDTH, WIDTH);
    if (i == skip_layer) add(gi, WIDTH, WIDTH, sc.feat, ENC, ENC);
  }
  const bf16* h_last = sc.hs + (depth - 1) * nn * WIDTH;
  add(sc.gfeat, WIDTH, WIDTH, h_last, WIDTH, WIDTH);   // dw_feature
  add(sc.gh + GH_SIGMA, GH, 8, h_last, WIDTH, WIDTH);  // dw_alpha, row 0 live
  add(sc.ghv, HALF, HALF, sc.feature, WIDTH, WIDTH);   // dw_view_h
  add(sc.ghv, HALF, HALF, sc.venc, VENC, VENC);        // dw_view_enc
  add(sc.gh, GH, 8, sc.hv, HALF, HALF);                // dw_rgb, rows 0-2 live
  jobs.n_jobs = n_jobs;

  const int n_chunks = (n + chunk - 1) / chunk;
  field_dw_kernel<<<dim3(tiles, n_chunks), DW_THREADS, DW_STAGES * DW_STAGE + 1024, cs>>>(jobs, n, chunk, part,
                                                                                          off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(int)((off + 31) / 32), 256, 0, cs>>>(part, n_chunks, (size_t)off, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(db_size(depth) + 31) / 32, 256, 0, cs>>>(dbpart, 2 * n_tiles, (size_t)db_size(depth), db);
  return (int)cudaGetLastError();
}
