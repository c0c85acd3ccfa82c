// Fused NeRF field evaluation + volume compositing for Hopper (sm_90a).
//
// Replaces: nerf_workspaces_explorer_tpu/ops/pallas_render.py::_render_kernel
//   in its bf16 modes, launched through nerf_render_pallas: density-only for
//   the coarse pass (the TPU path's K1) and full for the fine pass (K3).
//
// What bounds it on this card: tensor-core operations. A sample costs about
//   0.98 MFLOP (coarse, trunk + alpha head) or 1.18 MFLOP (fine, + feature,
//   view and rgb heads) against a few dozen bytes of per-ray input and
//   output, thousands of FLOP per byte, far above the H100's ~295 bf16
//   FLOP-per-byte ridge. The weights (1.26 MB bf16 for the fine net) do not
//   fit one SM's shared memory but stay resident in the 50 MB L2.
//
// What the design does about it: a block owns 32 rays and walks their
//   samples front to back, 4 samples per step, so each step is a 128-point
//   batch. The batch's activations never leave shared memory: two bf16
//   [128, 256] buffers ping-pong through the layers. Every layer is a WMMA
//   bf16 16x16x16 product with fp32 accumulation; each warp owns 16 points
//   and 128 output columns at a time. The layer's weights are staged
//   through shared memory in [128 columns x 64 inputs] slabs, so a weight
//   element is read from L2 once per block step, not once per warp. The
//   point encoding is the TPU kernel's: one polynomial sin/cos per
//   coordinate and octave doubling for the higher frequencies. Per-ray
//   transmittance and the composite stay in shared memory, and a block stops
//   once every ray it owns has transmittance at or below eps, which is exact
//   up to eps because samples run front to back. Simple first: no TMA, no
//   wgmma, one block per SM. The MMA tiles, epilogues and encoding are
//   nerf_mlp.cuh's, shared with the training field kernels.

#include "nerf_mlp.cuh"

#define RB 32                 // rays per block
#define SG 4                  // samples per step (RB * SG = MP points)
#define MAXD 16

static_assert(RB * SG == MP, "a block step is one MP-point tile");

struct NetPtrs {
  const bf16* w[MAXD];        // layer i: [256, in_i], in_0 = ENC, else 256
  const float* b[MAXD];       // layer i: [256]
  const bf16* w_skip;         // [256, ENC] encoding weights of the skip layer
  const bf16* w_alpha;        // [16, 256], row 0 live
  const float* b_alpha;       // [16]
  const bf16* w_feat;         // [256, 256]
  const float* b_feat;        // [256]
  const bf16* w_view_h;       // [128, 256]
  const bf16* w_view_enc;     // [128, VENC]
  const float* b_view;        // [128]
  const bf16* w_rgb;          // [16, 128], rows 0-2 live
  const float* b_rgb;         // [16]
  int depth;
  int skip_layer;             // layer whose input is [encoding, h]; -1 for none
};

template <bool DENSITY_ONLY>
__global__ void __launch_bounds__(NTHREADS, 1)
render_kernel(NetPtrs net, const float* __restrict__ o_ph, const float* __restrict__ d_ph,
              const float* __restrict__ zv, const float* __restrict__ dv,
              const bf16* __restrict__ venc, float* __restrict__ out, int R, int S,
              float eps, int* live_groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + MP * LDA;
  bf16* E = buf1 + MP * LDA;
  bf16* slab = E + MP * LDE;
  float* stage_all = reinterpret_cast<float*>(slab + NCH * LDS);
  float* zs = stage_all + NWARPS * 16 * LDST;
  float* ds = zs + MP;
  float* sig = ds + MP;
  float* rgbraw = sig + MP;          // [MP][4]
  float* ray_state = rgbraw + MP * 4;  // [RB][8]: T, r, g, b, depth, acc
  int* alive = reinterpret_cast<int*>(ray_state + RB * 8);
  float* hvenc = reinterpret_cast<float*>(alive + 32);  // [RB][HALF], full mode only

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray0 = blockIdx.x * RB;
  float* stage = stage_all + warp * 16 * LDST;
  bf16* bufs[2] = {buf0, buf1};

  for (int r = tid; r < MP; r += NTHREADS)
    for (int c = 3 + 6 * PTS_FREQS; c < LDE; ++c) E[r * LDE + c] = __float2bfloat16(0.f);
  if (tid < RB) {
    ray_state[tid * 8 + 0] = 1.f;
    for (int k = 1; k < 8; ++k) ray_state[tid * 8 + k] = 0.f;
  }
  if (tid == 0) alive[0] = 1;
  if (!DENSITY_ONLY) {
    // The view encoding's contribution to the view layer is per ray:
    // W_view_enc . venc, once per ray, not once per sample.
    for (int i = tid; i < RB * HALF; i += NTHREADS) {
      const int r = i / HALF, n = i % HALF;
      const int ray = min(ray0 + r, R - 1);
      float acc = 0.f;
      for (int k = 0; k < VENC; ++k)
        acc += __bfloat162float(net.w_view_enc[n * VENC + k]) * __bfloat162float(venc[(size_t)k * R + ray]);
      hvenc[i] = acc;
    }
  }
  __syncthreads();

  const int n_groups = (S + SG - 1) / SG;
  int n_live = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (!alive[0]) {
      // Every ray of the block is saturated: the remaining samples carry
      // weight < eps. The coarse pass still owes their (zero) weights.
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
      const float p = o_ph[(size_t)c * R + ray] + z * d_ph[(size_t)c * R + ray];
      encode_coord<PTS_FREQS>(E + row * LDE, c, p);
      if (c == 0) {
        zs[row] = z;
        ds[row] = live ? dv[(size_t)s * R + ray] : 0.f;  // dist 0: alpha 0
      }
    }
    __syncthreads();

    // Density trunk.
    dense<EPI_RELU>(E, LDE, net.w[0], ENC, nullptr, nullptr, net.b[0], WIDTH, bufs[0], slab,
                    stage, nullptr, 1);
    for (int i = 1; i < net.depth; ++i) {
      const bool skip = i == net.skip_layer;
      dense<EPI_RELU>(bufs[(i - 1) & 1], LDA, net.w[i], WIDTH, E, skip ? net.w_skip : nullptr,
                      net.b[i], WIDTH, bufs[i & 1], slab, stage, nullptr, 1);
    }
    bf16* h = bufs[(net.depth - 1) & 1];
    bf16* other = bufs[net.depth & 1];
    head16(h, net.w_alpha, WIDTH, net.b_alpha, sig, 1, 1, slab, stage);
    if (!DENSITY_ONLY) {
      dense<EPI_LINEAR>(h, LDA, net.w_feat, WIDTH, nullptr, nullptr, net.b_feat, WIDTH, other,
                        slab, stage, nullptr, 1);
      dense<EPI_VIEW>(other, LDA, net.w_view_h, WIDTH, nullptr, nullptr, net.b_view,
                      HALF, h, slab, stage, hvenc, RB);
      head16(h, net.w_rgb, HALF, net.b_rgb, rgbraw, 4, 3, slab, stage);
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
        const float alpha = 1.f - expf(-fmaxf(sig[row], 0.f) * ds[row]);
        const float w = alpha * T;
        if (DENSITY_ONLY) {
          if (valid) out[(size_t)s * R + ray] = w;
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

static size_t smem_bytes(bool density_only) {
  size_t b = 2 * MP * LDA * sizeof(bf16) + MP * LDE * sizeof(bf16) + NCH * LDS * sizeof(bf16) +
             NWARPS * 16 * LDST * sizeof(float) + 3 * MP * sizeof(float) +
             MP * 4 * sizeof(float) + RB * 8 * sizeof(float) + 32 * sizeof(int);
  if (!density_only) b += RB * HALF * sizeof(float);
  return b;
}

// ptrs: device pointers in this order: w_0, b_0, ..., w_{depth-1}, b_{depth-1},
// w_skip, w_alpha, b_alpha, w_feat, b_feat, w_view_h, w_view_enc, b_view,
// w_rgb, b_rgb (the full-mode entries may be null in density-only mode).
// Inputs are ray-minor: o_ph, d_ph [>=3, R] (rows 0-2 read), z and dists
// [S, R] fp32, venc [VENC, R] bf16. out: [S, R] weights (density-only) or
// [8, R] maps (rows 0-2 rgb, 3 depth, 4 acc, 5 transmittance). live_groups,
// if not null, gains the number of 4-sample steps each block evaluated.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int nerf_render_launch(const void* const* ptrs, int depth, int skip_layer,
                                  const float* o_ph, const float* d_ph, const float* z,
                                  const float* dists, const void* venc, float* out,
                                  int n_rays, int n_samples, int density_only, float eps,
                                  int* live_groups, void* stream) {
  if (depth < 1 || depth > MAXD || n_rays < 1 || n_samples < 1) return (int)cudaErrorInvalidValue;
  NetPtrs net;
  int k = 0;
  for (int i = 0; i < depth; ++i) {
    net.w[i] = static_cast<const bf16*>(ptrs[k++]);
    net.b[i] = static_cast<const float*>(ptrs[k++]);
  }
  for (int i = depth; i < MAXD; ++i) {
    net.w[i] = nullptr;
    net.b[i] = nullptr;
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
  net.depth = depth;
  net.skip_layer = skip_layer;

  const size_t smem = smem_bytes(density_only != 0);
  const dim3 grid((n_rays + RB - 1) / RB);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (density_only) {
    err = cudaFuncSetAttribute(render_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    render_kernel<true><<<grid, NTHREADS, smem, st>>>(net, o_ph, d_ph, z, dists,
                                                      static_cast<const bf16*>(venc), out,
                                                      n_rays, n_samples, eps, live_groups);
  } else {
    err = cudaFuncSetAttribute(render_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    render_kernel<false><<<grid, NTHREADS, smem, st>>>(net, o_ph, d_ph, z, dists,
                                                       static_cast<const bf16*>(venc), out,
                                                       n_rays, n_samples, eps, live_groups);
  }
  return (int)cudaGetLastError();
}
