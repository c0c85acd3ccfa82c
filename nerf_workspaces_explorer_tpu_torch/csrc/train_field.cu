// The fused NeRF training field for Hopper (sm_90a): forward (K4) and
// backward (K5) of encode + 8x256 MLP over free sample points.
//
// Replaces: nerf_workspaces_explorer_tpu/ops/pallas_train.py::_fwd_kernel
//   (via _run_fwd) and ::_bwd_kernel (via _run_bwd), the custom-VJP field
//   the JAX package trains with on its accelerator.
//
// What bounds them on this card: tensor-core operations. The forward costs
//   about 2 x 593k FLOP per point against 32 bytes of point input and
//   output; the backward about three times that (recomputed forward,
//   input-gradient chain, weight-gradient products). Both sit far above the
//   H100's ~295 bf16 FLOP-per-byte ridge.
//
// What the design does about it:
//   K4 (field_fwd_kernel) is the render kernels' MLP without compositing:
//   a block takes 128 points, encodes them with the octave ladder, and runs
//   every layer as WMMA bf16 products with fp32 accumulation, activations
//   ping-ponging in shared memory and weights streamed through [128 x 64]
//   slabs (nerf_mlp.cuh). The view layer's concat is a second product
//   against the per-point view encoding.
//   K5 cannot keep the TPU kernel's weight-gradient accumulators resident:
//   the TPU sums 2.4 MB of fp32 dW per net over a sequential grid, while a
//   GPU runs its blocks unordered and no SM holds 2.4 MB. So K5 is three
//   kernels (recompute plus input-gradient chain, split-K weight-gradient
//   products, an ordered reduction), deterministic by construction, no
//   atomics:
//   - field_bwd_chain_kernel: a block takes 128 points, recomputes the
//     forward and writes each layer's bf16 input (encodings, h_0..h_7,
//     feature, hv) to a global scratch; then runs the gradient chain
//     backward (W^T products of the bf16 cotangent, ReLU masks from the
//     recomputed bf16 activations compared in fp32) and writes each layer's
//     bf16 cotangent to the scratch, and its fp32 bias-gradient partial sums
//     (one row per block) to `dbpart`;
//   - field_dw_kernel: every dW = G^T H over the points, one 64 x 64 output
//     tile and one `chunk` of points per block, fp32 partials per chunk;
//   - sum_rows_kernel: partials summed over chunks (and bias rows over
//     blocks) in a fixed order.
//   The scratch costs about 10 KB per point written once and read once
//   (2 GB at the fine pass's 196,608 points), traded for simple kernels;
//   fusing the dW products into the chain kernel per tile would remove it.

#include "nerf_mlp.cuh"

#define MAXD 16
#define GH 16        // head-cotangent columns: 0-2 rgb, 8 sigma
#define GH_SIGMA 8
#define BK 128       // points per staged step of the dW products
#define LDT 72       // row stride of a staged dW operand tile (64 + 8)
#define MAX_JOBS 24

struct FieldPtrs {
  const bf16* w[MAXD];        // layer i: [256, in_i], in_0 = ENC, else 256 (h part)
  const float* b[MAXD];       // [256]
  const bf16* w_skip;         // [256, ENC] encoding weights of the skip layer
  const bf16* w_alpha;        // [16, 256], row 0 live
  const float* b_alpha;       // [16]
  const bf16* w_feat;         // [256, 256]
  const float* b_feat;        // [256]
  const bf16* w_view_h;       // [128, 256]
  const bf16* w_view_enc;     // [128, 64]: view encoding columns 0-31, then zeros
  const float* b_view;        // [128]
  const bf16* w_rgb;          // [16, 128], rows 0-2 live
  const float* b_rgb;         // [16]
  // Backward only: transposes [in, out] for the input-gradient products.
  const bf16* w_t[MAXD];      // layer i >= 1: [256 (in), 256 (out)]
  const bf16* w_feat_t;       // [256, 256]
  const bf16* w_alpha_t;      // [256, 64]: column GH_SIGMA live
  const bf16* w_view_h_t;     // [256, 128]
  const bf16* w_rgb_t;        // [128, 64]: columns 0-2 live
  int depth;
  int skip_layer;             // layer whose input is [encoding, h]; -1 for none
};

// The backward's global scratch, point-major bf16 [n, cols] arrays.
struct Scratch {
  bf16* feat;                 // [n, 64] point encoding (kernel row order)
  bf16* venc;                 // [n, 32] view encoding
  bf16* hs;                   // [depth][n, 256] trunk activations h_i
  bf16* feature;              // [n, 256]
  bf16* hv;                   // [n, 128]
  bf16* gh;                   // [n, 16] head cotangents: 0-2 rgb, 8 sigma
  bf16* ghv;                  // [n, 128]
  bf16* gfeat;                // [n, 256]
  bf16* g;                    // [depth][n, 256] trunk pre-activation cotangents
};

static size_t scratch_elems(int depth, size_t n) {
  return n * (ENC + VENC + (size_t)depth * WIDTH + WIDTH + HALF + GH + HALF + WIDTH +
              (size_t)depth * WIDTH);
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

// Bias-gradient layout (one row of `dbpart` per block, and the result):
// db_0 .. db_{depth-1} (256 each), db_feature (256), db_alpha (8, row 0
// live), db_view (128), db_rgb (8, rows 0-2 live).
__host__ __device__ inline int db_size(int depth) { return depth * WIDTH + WIDTH + 8 + HALF + 8; }

// rows [0, MP) of a bf16 shared tile -> global [n, ldg] rows p0.., first
// ncols columns (ncols a multiple of 8).
__device__ void copy_rows(const bf16* src, int lds, int ncols, bf16* dst, int ldg, int p0,
                          int n) {
  const int vpr = ncols / 8;
  for (int v = threadIdx.x; v < MP * vpr; v += NTHREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    if (p0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(p0 + r) * ldg + c) =
          *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// Encode the block's points: E [MP, LDE] rows = point encoding of pts * 0.1
// (F = 10), V [MP, LDE] = view encoding of views (F = 4), zero-padded to 64
// columns; points past n encode the origin.
__device__ void encode_tile(const float* __restrict__ pts, const float* __restrict__ views,
                            int p0, int n, bf16* E, bf16* V) {
  const int tid = threadIdx.x;
  for (int r = tid; r < MP; r += NTHREADS) {
    for (int c = 3 + 6 * PTS_FREQS; c < ENC; ++c) E[r * LDE + c] = __float2bfloat16(0.f);
    for (int c = 3 + 6 * VIEW_FREQS; c < ENC; ++c) V[r * LDE + c] = __float2bfloat16(0.f);
  }
  for (int i = tid; i < MP * 3; i += NTHREADS) {
    const int row = i / 3, c = i % 3, pt = p0 + row;
    const bool live = pt < n;
    const float x = live ? pts[(size_t)c * n + pt] : 0.f;
    const float v = live ? views[(size_t)c * n + pt] : 0.f;
    encode_coord<PTS_FREQS>(E + row * LDE, c, x * 0.1f);  // x * (1 / scalar_factor)
    encode_coord<VIEW_FREQS>(V + row * LDE, c, v);
  }
  __syncthreads();
}

// Every layer of the block's tile. Without SAVE (K4) the alpha and rgb heads
// write raw32 [MP][4]; with SAVE (K5) the heads are skipped and every
// layer's bf16 output is copied to the scratch. Returns the buffer that
// held h_{depth-1} and now holds hv (columns 0-127); the other buffer holds
// the feature.
template <bool SAVE>
__device__ bf16* forward_layers(const FieldPtrs& net, bf16* E, bf16* V, bf16* buf0,
                                bf16* buf1, bf16* slab, float* stage, float* raw32,
                                const Scratch* sc, int p0, int n) {
  bf16* bufs[2] = {buf0, buf1};
  dense<EPI_RELU>(E, LDE, net.w[0], ENC, nullptr, nullptr, net.b[0], WIDTH, bufs[0], slab, stage,
                  nullptr, 1);
  if (SAVE) {
    __syncthreads();
    copy_rows(bufs[0], LDA, WIDTH, sc->hs, WIDTH, p0, n);
  }
  for (int i = 1; i < net.depth; ++i) {
    const bool skip = i == net.skip_layer;
    dense<EPI_RELU>(bufs[(i - 1) & 1], LDA, net.w[i], WIDTH, E, skip ? net.w_skip : nullptr,
                    net.b[i], WIDTH, bufs[i & 1], slab, stage, nullptr, 1);
    if (SAVE) {
      __syncthreads();
      copy_rows(bufs[i & 1], LDA, WIDTH, sc->hs + (size_t)i * n * WIDTH, WIDTH, p0, n);
    }
  }
  bf16* h = bufs[(net.depth - 1) & 1];
  bf16* other = bufs[net.depth & 1];
  // Heads: feature and alpha have no activation (reference nerf_model.py:63-64).
  if (!SAVE) head16(h, net.w_alpha, WIDTH, net.b_alpha, raw32 + 3, 4, 1, slab, stage);
  dense<EPI_LINEAR>(h, LDA, net.w_feat, WIDTH, nullptr, nullptr, net.b_feat, WIDTH, other, slab,
                    stage, nullptr, 1);
  if (SAVE) {
    __syncthreads();
    copy_rows(other, LDA, WIDTH, sc->feature, WIDTH, p0, n);
  }
  // hv = relu(W_view_h . feature + W_view_enc . venc + b_view), into h.
  dense<EPI_RELU>(other, LDA, net.w_view_h, WIDTH, V, net.w_view_enc, net.b_view, HALF, h, slab,
                  stage, nullptr, 1);
  if (SAVE) {
    __syncthreads();
    copy_rows(h, LDA, HALF, sc->hv, HALF, p0, n);
  } else {
    head16(h, net.w_rgb, HALF, net.b_rgb, raw32, 4, 3, slab, stage);
  }
  return h;
}

static size_t fwd_smem_bytes() {
  return 2 * MP * LDA * sizeof(bf16) + 2 * MP * LDE * sizeof(bf16) + NCH * LDS * sizeof(bf16) +
         NWARPS * 16 * LDST * sizeof(float) + MP * 4 * sizeof(float);
}

__global__ void __launch_bounds__(NTHREADS, 1)
field_fwd_kernel(FieldPtrs net, const float* __restrict__ pts, const float* __restrict__ views,
                 float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + MP * LDA;
  bf16* E = buf1 + MP * LDA;
  bf16* V = E + MP * LDE;
  bf16* slab = V + MP * LDE;
  float* stage_all = reinterpret_cast<float*>(slab + NCH * LDS);
  float* raw32 = stage_all + NWARPS * 16 * LDST;  // [MP][4]: rgb logits, sigma
  float* stage = stage_all + (threadIdx.x >> 5) * 16 * LDST;
  const int p0 = blockIdx.x * MP;

  encode_tile(pts, views, p0, n, E, V);
  forward_layers<false>(net, E, V, buf0, buf1, slab, stage, raw32, nullptr, p0, n);
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * MP; i += NTHREADS) {
    const int r = i / MP, row = i % MP, pt = p0 + row;
    if (pt < n) out[(size_t)r * n + pt] = r < 4 ? raw32[row * 4 + r] : 0.f;
  }
}

// The backward epilogue: this warp's fp32 cotangents (masked by h > 0 from
// the global bf16 activations `mask`, when given) -> bf16 into dst, and
// each column's sum over the warp's 16 rows into colpart[warp][col]: of the
// fp32 values, or of the bf16-rounded ones with round_db.
template <int NF>
__device__ __forceinline__ void bwd_epilogue(Acc (&acc)[NF], int n0, const bf16* mask, int ldm,
                                             int p0, int n, bf16* dst, float* stage,
                                             float* colpart, bool round_db) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(stage, acc[f], LDST, wmma::mem_row_major);
    __syncwarp();
    float s = 0.f;
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const int row = warp * 16 + r, col = n0 + f * 16 + c;
      float v = stage[r * LDST + c];
      if (mask != nullptr) {
        const int pt = p0 + row;
        const bool on = pt < n && __bfloat162float(mask[(size_t)pt * ldm + col]) > 0.f;
        v = on ? v : 0.f;
      }
      const bf16 vb = __float2bfloat16(v);
      dst[row * LDA + col] = vb;
      s += round_db ? __bfloat162float(vb) : v;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 16) colpart[warp * WIDTH + n0 + f * 16 + lane] = s;
    __syncwarp();
  }
}

// After a layer's epilogues: db[col] = sum over the 8 warps, in warp order,
// into this block's row of dbpart.
__device__ __forceinline__ void reduce_db(const float* colpart, int ncols, float* db_row) {
  __syncthreads();
  for (int col = threadIdx.x; col < ncols; col += NTHREADS) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += colpart[w * WIDTH + col];
    db_row[col] = s;
  }
}

// dst[:, 0:n_out] = bwd_epi(A . W^T (+ A2[:, 0:64] . W2^T)), in 128-column
// chunks; then the bias-gradient row and the copy of dst to the scratch.
__device__ void bwd_layer(const bf16* A, int lda, const bf16* W, int K, const bf16* A2,
                          const bf16* W2, int n_out, const bf16* mask, int p0, int n, bf16* dst,
                          bf16* slab, float* stage, float* colpart, bool round_db, float* db_row,
                          bf16* gdst) {
  for (int n0 = 0; n0 < n_out; n0 += NCH) {
    Acc acc[8];
    zero_acc(acc);
    mma_accum<8>(acc, A, lda, W, K, n0, slab);
    if (W2 != nullptr) mma_accum<8>(acc, A2, LDE, W2, KS, n0, slab);
    bwd_epilogue<8>(acc, n0, mask, n_out, p0, n, dst, stage, colpart, round_db);
  }
  reduce_db(colpart, n_out, db_row);
  copy_rows(dst, LDA, n_out, gdst, n_out, p0, n);
}

static size_t bwd_smem_bytes() {
  return 2 * MP * LDA * sizeof(bf16) + 2 * MP * LDE * sizeof(bf16) + NCH * LDS * sizeof(bf16) +
         NWARPS * 16 * LDST * sizeof(float) + NWARPS * WIDTH * sizeof(float);
}

__global__ void __launch_bounds__(NTHREADS, 1)
field_bwd_chain_kernel(FieldPtrs net, const float* __restrict__ pts,
                       const float* __restrict__ views, const float* __restrict__ g_raw,
                       Scratch sc, float* __restrict__ dbpart, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + MP * LDA;
  bf16* E = buf1 + MP * LDA;
  bf16* V = E + MP * LDE;
  bf16* slab = V + MP * LDE;
  float* stage_all = reinterpret_cast<float*>(slab + NCH * LDS);
  float* colpart = stage_all + NWARPS * 16 * LDST;  // [NWARPS][WIDTH]
  float* stage = stage_all + (threadIdx.x >> 5) * 16 * LDST;
  const int tid = threadIdx.x, p0 = blockIdx.x * MP, L = net.depth;
  float* db_row = dbpart + (size_t)blockIdx.x * db_size(L);
  float* db_feat = db_row + L * WIDTH;
  float* db_alpha = db_feat + WIDTH;
  float* db_view = db_alpha + 8;
  float* db_rgb = db_view + HALF;

  // 1. Recompute the forward, saving every layer's input.
  encode_tile(pts, views, p0, n, E, V);
  copy_rows(E, LDE, ENC, sc.feat, ENC, p0, n);
  copy_rows(V, LDE, VENC, sc.venc, VENC, p0, n);
  bf16* h = forward_layers<true>(net, E, V, buf0, buf1, slab, stage, nullptr, &sc, p0, n);
  __syncthreads();

  // 2. Head cotangents, bf16, into E's place: columns 0-2 rgb, GH_SIGMA
  // sigma (the heads are padded to 8 rows, rows 0-2 rgb and 3 sigma live).
  bf16* Gh = E;
  for (int i = tid; i < MP * ENC; i += NTHREADS) {
    const int row = i / ENC, c = i % ENC, pt = p0 + row;
    float v = 0.f;
    if (pt < n && c < 3) v = g_raw[(size_t)c * n + pt];
    if (pt < n && c == GH_SIGMA) v = g_raw[(size_t)3 * n + pt];
    Gh[row * LDE + c] = __float2bfloat16(v);
  }
  if (tid < 4) {  // db_rgb, db_alpha: fp32 sums of the fp32 cotangent
    float s = 0.f;
    for (int row = 0; row < MP && p0 + row < n; ++row) s += g_raw[(size_t)tid * n + p0 + row];
    if (tid < 3) db_rgb[tid] = s;
    else db_alpha[0] = s;
  }
  if (tid >= 4 && tid < 9) db_rgb[tid - 1] = 0.f;  // rows 3-7
  if (tid >= 9 && tid < 16) db_alpha[tid - 8] = 0.f;  // rows 1-7
  __syncthreads();
  copy_rows(Gh, LDE, GH, sc.gh, GH, p0, n);

  bf16* other = (h == buf0) ? buf1 : buf0;
  // 3. g_hv = mask(hv) * (W_rgb^T g_rgb); db_view sums its bf16 values.
  bwd_layer(Gh, LDE, net.w_rgb_t, KS, nullptr, nullptr, HALF, sc.hv, p0, n, other, slab, stage,
            colpart, true, db_view, sc.ghv);
  // 4. g_feature = W_view_h^T g_hv (no activation on the feature head).
  bwd_layer(other, LDA, net.w_view_h_t, HALF, nullptr, nullptr, WIDTH, nullptr, p0, n, h, slab,
            stage, colpart, false, db_feat, sc.gfeat);
  // 5. g_{L-1} = mask(h_{L-1}) * (W_feature^T g_feature + W_alpha^T g_sigma).
  bwd_layer(h, LDA, net.w_feat_t, WIDTH, Gh, net.w_alpha_t, WIDTH,
            sc.hs + (size_t)(L - 1) * n * WIDTH, p0, n, other, slab, stage, colpart, false,
            db_row + (L - 1) * WIDTH, sc.g + (size_t)(L - 1) * n * WIDTH);
  // 6. The trunk: g_{i-1} = mask(h_{i-1}) * (W_i^T g_i), down to layer 0
  // (no input gradient into the encoding).
  bf16* cur = other;
  bf16* nxt = h;
  for (int i = L - 1; i >= 1; --i) {
    bwd_layer(cur, LDA, net.w_t[i], WIDTH, nullptr, nullptr, WIDTH,
              sc.hs + (size_t)(i - 1) * n * WIDTH, p0, n, nxt, slab, stage, colpart, false,
              db_row + (i - 1) * WIDTH, sc.g + (size_t)(i - 1) * n * WIDTH);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// One weight gradient dW [m, k] = G[:, 0:m]^T . H[:, 0:k] over the points.
struct DwJob {
  const bf16* g;
  const bf16* h;
  int ldg, ldh, m, k;
  int tiles_k;  // 64-column tiles of dW
  int tile0;    // first tile's index in the launch
  size_t out0;  // offset of this dW in a partial row
};

struct DwJobs {
  DwJob job[MAX_JOBS];
  int n_jobs;
};

// Block (tile, chunk): one 64 x 64 tile of one dW over points
// [chunk * blockIdx.y, +chunk), into part[blockIdx.y][out0 + ...].
// Warp w computes rows 16 (w % 4) and columns 32 (w / 4) .. +32 of the tile.
__global__ void __launch_bounds__(NTHREADS)
field_dw_kernel(DwJobs jobs, int n, int chunk, float* __restrict__ part, size_t part_stride) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Gs = reinterpret_cast<bf16*>(smem);  // [BK][LDT]
  bf16* Hs = Gs + BK * LDT;                  // [BK][LDT]
  float* stage = reinterpret_cast<float*>(Hs + BK * LDT) + (threadIdx.x >> 5) * 16 * LDST;
  int j = 0;
  while (j + 1 < jobs.n_jobs && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const DwJob jb = jobs.job[j];
  const int t = blockIdx.x - jb.tile0;
  const int m0 = (t / jb.tiles_k) * 64, k0 = (t % jb.tiles_k) * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, cg = warp >> 2;
  const bool active = m0 + 16 * rg < jb.m && k0 + 32 * cg < jb.k;
  const int begin = blockIdx.y * chunk, end = min(n, begin + chunk);

  Acc acc[2];
  zero_acc(acc);
  for (int pb = begin; pb < end; pb += BK) {
    for (int v = threadIdx.x; v < BK * 8; v += NTHREADS) {
      const int r = v >> 3, c = (v & 7) * 8, pt = pb + r;
      uint4 gv = make_uint4(0, 0, 0, 0), hv = make_uint4(0, 0, 0, 0);
      if (pt < end && m0 + c < jb.m)
        gv = *reinterpret_cast<const uint4*>(jb.g + (size_t)pt * jb.ldg + m0 + c);
      if (pt < end && k0 + c < jb.k)
        hv = *reinterpret_cast<const uint4*>(jb.h + (size_t)pt * jb.ldh + k0 + c);
      *reinterpret_cast<uint4*>(Gs + r * LDT + c) = gv;
      *reinterpret_cast<uint4*>(Hs + r * LDT + c) = hv;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, Gs + kk * LDT + 16 * rg, LDT);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Hs + kk * LDT + 32 * cg + 16 * f, LDT);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* out = part + blockIdx.y * part_stride + jb.out0;
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(stage, acc[f], LDST, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const int row = m0 + 16 * rg + r, col = k0 + 32 * cg + 16 * f + c;
      if (row < jb.m) out[(size_t)row * jb.k + col] = stage[r * LDST + c];
    }
    __syncwarp();
  }
}

// dst[c] = sum_r src[r][c], r in order: the deterministic reduction of
// partial sums over chunks or blocks.
__global__ void sum_rows_kernel(const float* __restrict__ src, int rows, size_t cols,
                                float* __restrict__ dst) {
  for (size_t c = blockIdx.x * (size_t)blockDim.x + threadIdx.x; c < cols;
       c += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += src[(size_t)r * cols + c];
    dst[c] = s;
  }
}

// Pointers in `field_*_launch`'s `ptrs` array: w_0, b_0, ..., w_{depth-1},
// b_{depth-1}, w_skip, w_alpha, b_alpha, w_feat, b_feat, w_view_h,
// w_view_enc, b_view, w_rgb, b_rgb; then, read by the backward only,
// w_t_1, ..., w_t_{depth-1}, w_feat_t, w_alpha_t, w_view_h_t, w_rgb_t.
static FieldPtrs unpack(const void* const* ptrs, int depth, int skip_layer, bool backward) {
  FieldPtrs net = {};
  int k = 0;
  for (int i = 0; i < depth; ++i) {
    net.w[i] = static_cast<const bf16*>(ptrs[k++]);
    net.b[i] = static_cast<const float*>(ptrs[k++]);
  }
  net.w_skip = static_cast<const bf16*>(ptrs[k++]);
  net.w_alpha = static_cast<const bf16*>(ptrs[k++]);
  net.b_alpha = static_cast<const float*>(ptrs[k++]);
  net.w_feat = static_cast<const bf16*>(ptrs[k++]);
  net.b_feat = static_cast<const float*>(ptrs[k++]);
  net.w_view_h = static_cast<const bf16*>(ptrs[k++]);
  net.w_view_enc = static_cast<const bf16*>(ptrs[k++]);
  net.b_view = static_cast<const float*>(ptrs[k++]);
  net.w_rgb = static_cast<const bf16*>(ptrs[k++]);
  net.b_rgb = static_cast<const float*>(ptrs[k++]);
  if (backward) {
    for (int i = 1; i < depth; ++i) net.w_t[i] = static_cast<const bf16*>(ptrs[k++]);
    net.w_feat_t = static_cast<const bf16*>(ptrs[k++]);
    net.w_alpha_t = static_cast<const bf16*>(ptrs[k++]);
    net.w_view_h_t = static_cast<const bf16*>(ptrs[k++]);
    net.w_rgb_t = static_cast<const bf16*>(ptrs[k++]);
  }
  net.depth = depth;
  net.skip_layer = skip_layer;
  return net;
}

// Sizes of the backward's buffers for `depth` layers and n points: the bf16
// scratch (elements), the dW values (P, in `field_backward_launch`'s order)
// and the bias values (D). Returns 0.
extern "C" int field_backward_sizes(int depth, int skip_layer, long long n,
                                    long long* scratch, long long* n_dw, long long* n_db) {
  *scratch = (long long)scratch_elems(depth, (size_t)n);
  long long p = (long long)WIDTH * ENC;
  for (int i = 1; i < depth; ++i) p += (long long)WIDTH * WIDTH + (i == skip_layer ? WIDTH * ENC : 0);
  p += (long long)WIDTH * WIDTH + 8 * WIDTH + HALF * WIDTH + HALF * VENC + 8 * HALF;
  *n_dw = p;
  *n_db = db_size(depth);
  return 0;
}

// K4: pts, views [3, n] fp32 -> out [8, n] fp32 (rows 0-2 rgb logits, 3
// sigma, 4-7 zero). Returns the CUDA error code of the launch.
extern "C" int field_forward_launch(const void* const* ptrs, int depth, int skip_layer,
                                    const float* pts, const float* views, float* out, int n,
                                    void* stream) {
  if (depth < 1 || depth > MAXD || n < 1) return (int)cudaErrorInvalidValue;
  const FieldPtrs net = unpack(ptrs, depth, skip_layer, false);
  const size_t smem = fwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(field_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_fwd_kernel<<<(n + MP - 1) / MP, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      net, pts, views, out, n);
  return (int)cudaGetLastError();
}

// K5: cotangent g_raw [8, n] fp32 (rows 0-3 read) -> dw [P] and db [D] fp32
// (`field_backward_sizes`). dW order: for each layer i, dw_i [256, in_i]
// then, for the skip layer, dwskip_i [256, 64]; then dw_feature [256, 256],
// dw_alpha [8, 256], dw_view_h [128, 256], dw_view_enc [128, 32], dw_rgb
// [8, 128]; each [out, in] row-major, heads padded to 8 rows. Buffers the
// caller allocates: scratch (bf16), dbpart [ceil(n / 128), D], part
// [ceil(n / chunk), P]. Four launches. Returns the first CUDA error code.
extern "C" int field_backward_launch(const void* const* ptrs, int depth, int skip_layer,
                                     const float* pts, const float* views, const float* g_raw,
                                     void* scratch, float* dbpart, float* part, float* dw,
                                     float* db, int n, int chunk, void* stream) {
  if (depth < 1 || depth > MAXD || n < 1 || chunk < BK || chunk % BK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FieldPtrs net = unpack(ptrs, depth, skip_layer, true);
  const Scratch sc = scratch_layout(static_cast<bf16*>(scratch), depth, (size_t)n);
  const int n_tiles = (n + MP - 1) / MP;
  const size_t smem = bwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(field_bwd_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_chain_kernel<<<n_tiles, NTHREADS, smem, st>>>(net, pts, views, g_raw, sc, dbpart, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // The dW jobs, in the order of `dw`.
  DwJobs jobs = {};
  int n_jobs = 0, tiles = 0;
  size_t off = 0;
  auto add = [&](const bf16* g, int ldg, int m, const bf16* h, int ldh, int k) {
    DwJob& jb = jobs.job[n_jobs++];
    jb.g = g;
    jb.h = h;
    jb.ldg = ldg;
    jb.ldh = ldh;
    jb.m = m;
    jb.k = k;
    jb.tiles_k = (k + 63) / 64;
    jb.tile0 = tiles;
    jb.out0 = off;
    tiles += ((m + 63) / 64) * jb.tiles_k;
    off += (size_t)m * k;
  };
  const size_t nn = (size_t)n;
  for (int i = 0; i < depth; ++i) {
    const bf16* gi = sc.g + i * nn * WIDTH;
    if (i == 0) add(gi, WIDTH, WIDTH, sc.feat, ENC, ENC);
    else add(gi, WIDTH, WIDTH, sc.hs + (i - 1) * nn * WIDTH, WIDTH, WIDTH);
    if (i == skip_layer) add(gi, WIDTH, WIDTH, sc.feat, ENC, ENC);
  }
  const bf16* h_last = sc.hs + (depth - 1) * nn * WIDTH;
  add(sc.gfeat, WIDTH, WIDTH, h_last, WIDTH, WIDTH);           // dw_feature
  add(sc.gh + GH_SIGMA, GH, 8, h_last, WIDTH, WIDTH);          // dw_alpha, row 0 live
  add(sc.ghv, HALF, HALF, sc.feature, WIDTH, WIDTH);           // dw_view_h
  add(sc.ghv, HALF, HALF, sc.venc, VENC, VENC);                // dw_view_enc
  add(sc.gh, GH, 8, sc.hv, HALF, HALF);                        // dw_rgb, rows 0-2 live
  jobs.n_jobs = n_jobs;

  const int n_chunks = (n + chunk - 1) / chunk;
  const size_t dw_smem = 2 * BK * LDT * sizeof(bf16) + NWARPS * 16 * LDST * sizeof(float);
  err = cudaFuncSetAttribute(field_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem);
  if (err != cudaSuccess) return (int)err;
  field_dw_kernel<<<dim3(tiles, n_chunks), NTHREADS, dw_smem, st>>>(jobs, n, chunk, part, off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<264, 256, 0, st>>>(part, n_chunks, off, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<8, 256, 0, st>>>(dbpart, n_tiles, (size_t)db_size(depth), db);
  return (int)cudaGetLastError();
}
