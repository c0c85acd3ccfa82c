// Deterministic inverse-CDF importance sampling (+ coarse/fine depth merge)
// for Hopper (sm_90a).
//
// Replaces: nerf_workspaces_explorer_tpu/ops/pallas_sampling.py::
//   _importance_merge_kernel, launched through importance_merge_pallas:
//   merge=True (the TPU path's K2, the reference preset) and merge=False
//   (K6, the fast and turbo presets: the I ascending samples alone, :95-99).
//
// What bounds it on this card: bytes, in principle. Per ray it reads S
//   weights and S depths and writes S + I depths (76,800 x 320 x 4 B = 98 MB
//   at the main path's 64 + 128 samples, 0.029 ms at 3.35 TB/s), or I
//   depths without the merge, and does a few hundred operations. In
//   practice the issue rate: each quantile needs a search of the CDF and an
//   interpolation, some 50 instructions, which at the main path's shapes
//   take longer than the bytes. At the turbo lattice's 4,800 rays the bytes
//   take ~1 us, so there it is the launch and the chain of dependent steps
//   of one ray.
//
// What the design does about it:
//   - A block of 8 warps owns a tile of 32 rays, a lane each: each row of
//     the tile is one 128-byte segment of an [S, R] row. It stages the
//     [S, 32] weights and depths into shared memory with cp.async, every
//     weight and depth read from global memory once, coalesced (16 bytes a
//     copy where R and the pointers allow: K2 at 76,800 rays 0.051 ms
//     against 0.063 with 4-byte copies alone on an H100, by
//     scripts/time_torch_placement.py); the ragged last tile masks its
//     columns at the load, the work and the store. Lane t only ever reads
//     and writes column t of a [rows][32] array, so its accesses sit in
//     bank t and a warp's never conflict, wherever in its column each lane
//     is. K6's 4,800 turbo rays make 150 blocks.
//   - The warps split each ray's work. The CDF goes by 8 segments, each
//     summed in order, joined by segment offsets added in order, and
//     divided by the total, written over the weights: the same CDF up to
//     the order of the fp32 sums (allowed by the contract the JAX package
//     pins: its own kernel sums by a triangular matmul, tests/
//     test_pallas.py:463-470), non-decreasing by construction (each
//     segment's offset is the very expression that gave the last sum before
//     it), and 1 exactly at its end. The rows past it hold +inf, up to
//     2^(LOG + 1) - 1, so the search needs no bounds.
//   - Warp k takes every 8th quantile from k, four at a time, and each
//     finds its bin on its own by a branchless binary search of the CDF
//     column under the `cdf[b] <= u` rule (the last tie): LOG + 1 halvings,
//     a template parameter, each one shared load at a register plus a
//     constant; the four searches interleave. Then the interpolation with
//     the `denom < 1e-5 -> 1` guard; u >= cdf[-1] lands in the last bin.
//     The quotient is (u - cb) times a reciprocal within an ulp, not a
//     rounded division: a depth moves by far under 1e-6 of its bin.
//   - The samples are non-decreasing in q by construction: within a bin
//     every step is monotone in u (explicitly rounded, no contraction), and
//     each sample is clamped to its bin's upper edge, which lies at or below
//     the next bin's lower edge; the clamp changes a sample only where
//     bb + t * (ba - bb) overshoots ba, by an ulp.
//   - Without the merge (K6), sample q is row q of every ray: a warp stores
//     32 neighbouring rays of it, one 128-byte segment, straight from its
//     registers.
//   - With the merge (K2), by ranks. Sample q goes to row q + #(coarse <=
//     zs[q]): since zs[q] lies in [mid(b), mid(b + 1)], that count is b + 1,
//     + 1 past zc[b + 1], + a walk over equal coarse depths (none unless two
//     coarse depths are equal). Coarse depth i goes to row i + #(samples <
//     zc[i]), the largest q + 1 over the samples with at most i coarse
//     depths at or below them: each sample marks its count with a shared-
//     memory atomicMax, and a prefix max over the S marks (by segments, as
//     the CDF) reads them. The asymmetry (<= against <) makes the ranks a
//     permutation under ties. Ranked values go into a shared output tile
//     [rows, 32], and the block then writes whole 128-byte rows of it into
//     the [S + I, R] output that the fine pass reads. Where S + I rows do
//     not fit the tile's budget, the block loops over row chunks, redoing
//     the placement (not the CDF) per chunk.
//   - No per-thread array indexed at run time: what a thread indexes lives
//     in shared memory, and its four quantiles' registers are unrolled
//     (chip_smoke.py requires 0-byte stack frames and no spills).

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 32;  // rays a tile: a lane each, a 128-byte segment of each [S, R] row
constexpr int kRow = kRays * (int)sizeof(float);  // bytes a row of a tile
constexpr int kWarps = 8;  // a block's; also the CDF's segments (so its summation order)
constexpr int kMaxS = 256;
constexpr int kMaxDevices = 64;
constexpr int kSmemBudget = 160 * 1024;  // a block's shared memory, at most: S = 256 takes ~100 KB before the tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The float `bytes` past `base` in shared memory.
__device__ __forceinline__ float at(const char* base, int bytes) {
  return *reinterpret_cast<const float*>(base + bytes);
}

// 1 / x to within an ulp (x >= 1e-5 here: no denormal or infinite case).
__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Placement kernel, for a CDF of B = S - 1 entries with 2^LOG <= B <
// 2^(LOG + 1). Block x owns rays [32x, 32x + 32), lane t ray t of them, and
// its kWarps warps split each ray's work: segments of the CDF, every
// kWarps-th quantile, segments of the coarse ranks. A ray's result does not
// depend on its tile. vec: R and the pointers allow 16-byte copies.
// chunk_rows: the output tile's rows (S + I, or fewer when they do not fit).
template <int LOG>
__global__ void __launch_bounds__(32 * kWarps)
importance_merge_kernel(const float* __restrict__ w, const float* __restrict__ z, float* __restrict__ out, int R,
                        int S, int I, int merge, int chunk_rows, int vec) {
  constexpr int kSearch = (2 << LOG) - 1;  // CDF rows the search may read: the B entries, then +inf
  extern __shared__ __align__(16) float smem[];
  constexpr int W = kWarps;
  const int cdf_rows = max(S, kSearch);
  float* tw = smem;                                          // [cdf_rows][32] weights, then the CDF
  float* tz = tw + cdf_rows * kRays;                         // [S][32] coarse depths
  float* seg = tz + S * kRays;                               // [W][32] per-warp partials
  int* mark = reinterpret_cast<int*>(seg + W * kRays);       // [S + 1][32] (merge only)
  float* tile = reinterpret_cast<float*>(mark + (S + 1) * kRays);  // [chunk_rows][32] merged rows (merge only)
  const int base = blockIdx.x * kRays;
  const int cols = min(kRays, R - base);  // < 32 on the ragged last tile (a multiple of 4 if vec)
  const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. Stage the tile's weights and depths, each read once, coalesced.
  if (vec) {
    for (int idx = threadIdx.x; idx < S * kRays / 4; idx += blockDim.x) {
      const int s = idx >> 3, c = (idx & 7) * 4;
      if (c < cols) {
        const size_t g = (size_t)s * R + base + c;
        cp_async16(tw + 4 * idx, w + g);
        cp_async16(tz + 4 * idx, z + g);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < S * kRays; idx += blockDim.x) {
      const int s = idx >> 5, c = idx & 31;
      if (c < cols) {
        const size_t g = (size_t)s * R + base + c;
        cp_async4(tw + idx, w + g);
        cp_async4(tz + idx, z + g);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. The CDF, written over the weights: x[j] = w[j + 1] + 1e-5, cdf[0] =
  // 0, cdf[j + 1] = (x[0] + ... + x[j]) / (x[0] + ... + x[S - 3]), which is
  // sum_{i <= j} pdf[i] up to the order of the fp32 sums; the last entry is
  // 1 exactly. Rows B .. kSearch - 1 hold +inf. Warp k sums the k-th
  // segment of the S - 2 entries in order, and adds the totals of the
  // segments before it, in order: the very expression that gives the last
  // sum of segment k - 1, so the CDF is non-decreasing across segments as
  // within them.
  float* col = tw + t;
  const float* zc = tz + t;
  const int n_pdf = S - 2;
  const int len = (n_pdf + kWarps - 1) / kWarps;
  const int j0 = warp * len, j1 = min(n_pdf, j0 + len);
  float run = 0.f;
  for (int j = j0; j < j1; ++j) {
    run += col[(j + 1) * kRays] + 1e-5f;
    col[(j + 1) * kRays] = run;
  }
  seg[warp * kRays + t] = run;
  __syncthreads();
  float offset = 0.f, sum = 0.f;
  for (int k = 0; k < kWarps; ++k) {
    if (k == warp) offset = sum;
    sum += seg[k * kRays + t];
  }
  for (int j = j0; j < j1; ++j) col[(j + 1) * kRays] = (offset + col[(j + 1) * kRays]) / sum;
  if (warp == 0) {
    col[0] = 0.f;
    for (int j = S - 1; j < kSearch; ++j) col[j * kRays] = __int_as_float(0x7f800000);
  }
  __syncthreads();

  // 3. Placement. Thread (warp k, lane t) places quantiles k, k + W, ... of
  // ray t, four at a time: their binary searches (LOG + 1 halvings over the
  // +inf-padded column, the same for every lane) run interleaved, and lane t
  // only ever reads column t, so its loads sit in bank t and never conflict.
  // Without the merge, sample q is row q of every ray: a warp stores 32
  // neighbouring rays of it, one 128-byte segment. With the merge, by row
  // chunks of the shared output tile.
  const int B = S - 1;  // bins (coarse midpoints) and CDF entries
  const int rows = merge ? S + I : I;
  const float inv = 1.f / (float)(I - 1);  // u = q * inv is jnp.linspace's value
  // Shared addresses as byte offsets from the CDF (or the depths), so a
  // search step is one load at a register plus a constant.
  const char* cdf_base = reinterpret_cast<const char*>(tw);
  const char* z_base = reinterpret_cast<const char*>(tz);
  const int col0 = t * (int)sizeof(float);  // column t
  const int last_row = col0 + (B - 1) * kRow;
  const bool live = t < cols;
  int* mk = mark + t;
  float* tcol = tile + t;
  float* ocol = out + base + t;  // importance-only: sample q of ray t at ocol[q * R]
  const int slen = (S + W - 1) / W;  // coarse rows a warp ranks
  const int i0 = min(S, warp * slen), i1 = min(S, i0 + slen);
  for (int r0 = 0; r0 < rows; r0 += chunk_rows) {
    const int r1 = min(rows, r0 + chunk_rows);
    if (merge) {
      for (int idx = threadIdx.x; idx < S * kRays / 4; idx += blockDim.x)  // row S is never read
        reinterpret_cast<int4*>(mark)[idx] = make_int4(0, 0, 0, 0);
      __syncthreads();
    }
    const unsigned span = r1 - r0;
    for (int qb = warp; live && qb < I; qb += 4 * W) {
      float u[4];
      int o[4];  // o[k] = col0 + 128 b, b = #(cdf <= u[k]) - 1, the last cdf[b] <= u (cdf[0] = 0 <= u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        u[k] = (float)min(qb + k * W, I - 1) * inv;
        o[k] = col0 - kRow;
      }
#pragma unroll
      for (int step = 1 << LOG; step > 0; step >>= 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (at(cdf_base, o[k] + step * kRow) <= u[k]) o[k] += step * kRow;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = qb + k * W;
        if (q >= I) continue;
        const bool last_bin = o[k] == last_row;  // u >= cdf[-1]: the last bin
        const float cb = at(cdf_base, o[k]), ca = last_bin ? cb : at(cdf_base, o[k] + kRow);
        const float z0 = at(z_base, o[k]), z1 = at(z_base, o[k] + kRow);
        const float z2 = at(z_base, o[k] + 2 * kRow);  // row S (past the depths) for the last bin: unused
        const float bb = 0.5f * (z0 + z1);
        const float ba = last_bin ? bb : 0.5f * (z1 + z2);
        float denom = __fsub_rn(ca, cb);
        if (denom < 1e-5f) denom = 1.f;  // reference rays.py:118
        const float frac = __fmul_rn(__fsub_rn(u[k], cb), rcp(denom));
        const float zs = fminf(__fadd_rn(bb, __fmul_rn(frac, __fsub_rn(ba, bb))), ba);
        if (!merge) {
          ocol[(size_t)q * R] = zs;
          continue;
        }
        // Sample q goes to row q + #(coarse <= zs). zc[0..b] <= mid(b) <=
        // zs <= mid(b + 1) <= zc[b + 2]: that count is b + 1, + 1 past
        // zc[b + 1], + ties.
        const int b = (unsigned)(o[k] - col0) / kRow;
        int c = b + 1 + (z1 <= zs);
        if (z2 <= zs && c == b + 2 && c < S)
          for (++c; c < S && zc[c * kRays] <= zs;) ++c;
        const int row = q + c;
        atomicMax(mk + c * kRays, q + 1);  // at least q + 1 samples lie below zc[c..] (row S: spare)
        if ((unsigned)(row - r0) < span) tcol[(row - r0) * kRays] = zs;
      }
    }
    if (!merge) break;

    // Coarse depth i goes to row i + #(samples < zc[i]), the largest mark at
    // or before i: the segment's own prefix max after the maxima of the
    // segments before it.
    __syncthreads();
    int seg_max = 0;
    for (int i = i0; i < i1; ++i) seg_max = max(seg_max, mk[i * kRays]);
    int* segi = reinterpret_cast<int*>(seg);
    segi[warp * kRays + t] = seg_max;
    __syncthreads();
    if (live) {
      int k = 0;
      for (int v = 0; v < warp; ++v) k = max(k, segi[v * kRays + t]);
      for (int i = i0; i < i1; ++i) {
        k = max(k, mk[i * kRays]);
        const int row = i + k;
        if ((unsigned)(row - r0) < span) tcol[(row - r0) * kRays] = zc[i * kRays];
      }
    }
    __syncthreads();
    if (vec) {
      for (int idx = threadIdx.x; idx < (r1 - r0) * kRays / 4; idx += blockDim.x) {
        const int r = idx >> 3, c = (idx & 7) * 4;
        if (c < cols)
          *reinterpret_cast<float4*>(out + (size_t)(r0 + r) * R + base + c) =
              *reinterpret_cast<const float4*>(tile + 4 * idx);
      }
    } else {
      for (int idx = threadIdx.x; idx < (r1 - r0) * kRays; idx += blockDim.x) {
        const int r = idx >> 5, c = idx & 31;
        if (c < cols) out[(size_t)(r0 + r) * R + base + c] = tile[idx];
      }
    }
    __syncthreads();
  }
}

using Kernel = void (*)(const float*, const float*, float*, int, int, int, int, int, int);
constexpr Kernel kKernels[] = {nullptr,
                               importance_merge_kernel<1>, importance_merge_kernel<2>, importance_merge_kernel<3>,
                               importance_merge_kernel<4>, importance_merge_kernel<5>, importance_merge_kernel<6>,
                               importance_merge_kernel<7>};

__global__ void empty_kernel() {}

}  // namespace

// weights, z: [S, R] fp32 (ray-minor); out: [S + I, R] fp32 with merge, else
// [I, R]. Needs 3 <= S <= 256, I >= 2 and R >= 1. Returns the CUDA error
// code of the launch.
extern "C" int importance_merge_launch(const float* weights, const float* z, float* out, int n_rays, int n_samples,
                                       int n_importance, int merge, void* stream) {
  if (n_samples < 3 || n_samples > kMaxS || n_importance < 2 || n_rays < 1) return (int)cudaErrorInvalidValue;
  // The kernels may take more than 48 KB of shared memory: an attribute
  // set per device, once on each.
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    for (int log = 1; log <= 7; ++log) {
      err = cudaFuncSetAttribute(kKernels[log], cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
      if (err != cudaSuccess) return (int)err;
    }
    ready[device] = true;
  }
  const int blocks = (n_rays + kRays - 1) / kRays;
  const int rows = merge ? n_samples + n_importance : n_importance;
  const int log = 31 - __builtin_clz(n_samples - 1);  // 2^log <= S - 1 < 2^(log + 1)
  const int cdf_rows = max(n_samples, (2 << log) - 1);
  const int fixed = (cdf_rows + n_samples + kWarps + (merge ? n_samples + 1 : 0)) * kRow;
  int chunk_rows = (kSmemBudget - fixed) / kRow;  // the merged rows' tile, in chunks if S + I do not fit
  if (chunk_rows > rows) chunk_rows = rows;
  const int smem = fixed + (merge ? chunk_rows * kRow : 0);
  const bool vec = n_rays % 4 == 0 && ((reinterpret_cast<size_t>(weights) | reinterpret_cast<size_t>(z) |
                                         reinterpret_cast<size_t>(out)) & 15) == 0;
  kKernels[log]<<<blocks, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      weights, z, out, n_rays, n_samples, n_importance, merge != 0, chunk_rows, vec);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel on the stream: the floor that any launch
// through this binding pays, timed beside the placement kernel.
extern "C" int importance_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
