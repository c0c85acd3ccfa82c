// Deterministic inverse-CDF importance sampling (+ coarse/fine depth merge)
// for Hopper (sm_90a).
//
// Replaces: nerf_workspaces_explorer_tpu/ops/pallas_sampling.py::
//   _importance_merge_kernel, launched through importance_merge_pallas:
//   merge=True (the TPU path's K2, the reference preset) and merge=False
//   (K6, the fast and turbo presets: the I ascending samples alone, :95-99).
//
// What bounds it on this card: bytes. Per ray it reads S weights and S
//   depths and writes S + I depths (76,800 x 320 x 4 B = 98 MB at the main
//   path's 64 + 128 samples, ~0.03 ms at 3.35 TB/s), or I depths without
//   the merge, and does a few hundred flops, far below the ridge.
//
// What the design does about it: one thread per ray, so every global load
//   and store of a warp touches 32 consecutive rays of one [S, R] row (fully
//   coalesced), and the ragged edge is masked. The TPU kernel's triangular
//   matmul cumsum, interval loop and bitonic network exist because a TPU
//   has no cheap gathers or per-lane branches; here the CDF is a running sum
//   in the thread's local memory, the quantiles walk it monotonically (the
//   `cdf_b <= u` prefix rule: u ascends, so the bin index only moves
//   forward), and a two-pointer merge with the ascending coarse depths
//   writes the sorted union directly. Without the merge the walk's ascending
//   quantiles write ascending samples, one row each.

#include <cuda_runtime.h>

#define MAXS 256

__global__ void importance_merge_kernel(const float* __restrict__ w, const float* __restrict__ z,
                                        float* __restrict__ out, int R, int S, int I,
                                        bool merge) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= R) return;
  float zc[MAXS];
  float cdf[MAXS];  // cdf[0] = 0, cdf[b] = sum_{j<b} pdf[j], b < S - 1
  for (int s = 0; s < S; ++s) zc[s] = z[(size_t)s * R + ray];

  // pdf over the interior weights w[1:-1] with the +1e-5 guard (reference
  // rays.py:87); the sum is taken first, then each pdf entry, as in
  // sample_pdf.
  float sum = 0.f;
  for (int j = 1; j < S - 1; ++j) sum += w[(size_t)j * R + ray] + 1e-5f;
  const int B = S - 1;  // bins (coarse midpoints) and CDF entries
  cdf[0] = 0.f;
  float run = 0.f;
  for (int j = 1; j < B; ++j) {
    run += (w[(size_t)j * R + ray] + 1e-5f) / sum;
    cdf[j] = run;
  }

  int b = 0;   // last CDF entry <= u
  int ic = 0;  // next coarse depth to merge
  int o = 0;   // next output row
  const float inv = 1.f / (float)(I - 1);  // u = q * inv is jnp.linspace's value
  for (int q = 0; q < I; ++q) {
    const float u = (float)q * inv;
    while (b + 1 < B && cdf[b + 1] <= u) ++b;
    const int above = (b + 1 < B) ? b + 1 : B - 1;  // u >= cdf[-1]: the last bin
    const float cb = cdf[b], ca = cdf[above];
    const float bb = 0.5f * (zc[b] + zc[b + 1]);
    const float ba = 0.5f * (zc[above] + zc[above + 1]);
    float denom = ca - cb;
    if (denom < 1e-5f) denom = 1.f;  // reference rays.py:118
    const float zs = bb + (u - cb) / denom * (ba - bb);
    if (merge)
      while (ic < S && zc[ic] <= zs) out[(size_t)(o++) * R + ray] = zc[ic++];
    out[(size_t)(o++) * R + ray] = zs;
  }
  if (merge)
    while (ic < S) out[(size_t)(o++) * R + ray] = zc[ic++];
}

// weights, z: [S, R] fp32 (ray-minor); out: [S + I, R] fp32 with merge, else
// [I, R]. Needs 3 <= S <= 256 and I >= 2. Returns the CUDA error code of the
// launch.
extern "C" int importance_merge_launch(const float* weights, const float* z, float* out,
                                       int n_rays, int n_samples, int n_importance, int merge,
                                       void* stream) {
  if (n_samples < 3 || n_samples > MAXS || n_importance < 2 || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((n_rays + threads - 1) / threads);
  importance_merge_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      weights, z, out, n_rays, n_samples, n_importance, merge != 0);
  return (int)cudaGetLastError();
}
