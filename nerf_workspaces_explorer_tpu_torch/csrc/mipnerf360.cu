// mip-NeRF 360's frame on Hopper (ops/mipnerf360.py): the integrated
// encoding (K10), the MLPs' dense layers (K11), placement (K12) and
// compositing (K13). None replaces a TPU kernel: the JAX package serves no
// mip-NeRF 360; they were added with the configuration.
//
// Layout. Every bf16 matrix between kernels (the encoding, the layers'
// activations) lies in slabs: 64-row x 64-column tiles of 8,192 bytes, one
// row of 128 bytes in the 128-byte swizzle (`swz`), tile (m, k) of a matrix
// of KT column tiles at byte (m KT + k) 8192. A tile is then one bulk copy
// into shared memory in the layout wgmma reads, with no tensor map. A
// layer's weights (ops/mipnerf360.py::pack_linear) lie the same way,
// transposed: for each block of BN output columns, KT slabs of BN rows x 128
// bytes.
//
// K11, one dense layer: out = act(A W + b). Its bound is the tensor cores:
// at width 1024 a 128 x 256 output tile does 16 k-tiles' products on 48 KB
// a k-tile, ~530 operations a byte of device memory over a chunk of 65,536
// rows, above the card's ridge of ~295. K3's design (a whole 128-point step
// resident in shared memory, every layer in one kernel) does not fit at
// width 1024: 128 x 1024 x 2 B of activations is more than the 227 KB a
// block has. So each layer of the NeRF MLP is one launch (the proposal MLP,
// at width 256, takes its four in one: each later layer reads the one
// before from the warpgroup's output tile in shared memory, and only the
// weights stream; as four launches its layers read 22-33% of the peak, as
// one 49%, PERF.md). A launch is a block of three warpgroups, two
// consumers that own rows 0-63 and 64-127 of a 128 x BN tile (BN = 256, its
// fp32 sums 128 registers a thread), and a producer whose one thread keeps
// a ring of stages full: each stage the two A tiles of a k-tile and the
// weights' BN x 64 slab, three bulk copies completing on one mbarrier. The
// second source of A is the skip layer's encoding, read after the
// activations. Blocks are persistent, one an SM, each walking tiles in row
// block order, so that the ring's fill overlaps the epilogue before it. The
// epilogue adds the bias (a row's own, per ray, for the view layer),
// applies ReLU and writes bf16 pairs into the warpgroup's output tile in
// shared memory, in its slabs' layout; one bulk store then writes the
// tile's BN / 64 slabs, which lie side by side in the output (4-byte
// stores straight to device memory cost a quarter of a layer's time,
// PERF.md). The density head (one column) and the rgb head (three) are dot
// products of the bf16 row with their weights, summed across the four
// lanes that share a row: the density's per 256-column block, added up in
// K13.
//
// K10, the encoding, is bound by the special-function units and the ALUs
// (a frame evaluates 3.1 G sine/cosine pairs and exponentials): a block of
// 64 sample rows casts each interval's Gaussian, contracts it with its
// Jacobian, then its 256 threads take (row, direction) pairs, each the 12
// degrees' sin/cos of an exact two-term reduction and one exponential, into
// a swizzled 64 KB tile in shared memory, stored to its slabs whole.
//
// K12 (placement: max-dilation, the inverse CDF, the intervals) and K13
// (alphas, weights, colour) give a ray a thread: their work is sequential
// along the ray and small beside the MLPs' (~76,800 rays a frame).

#include "hopper.cuh"

using namespace rk;

namespace {

constexpr int TILE = 8192;      // one 64 x 64 bf16 slab
constexpr int N_BASIS = 21;     // directions of the twice-tessellated icosahedron
constexpr int N_DEG = 12;       // degrees 0-11
constexpr int ENC = 2 * N_DEG * N_BASIS;  // 504 features
constexpr int ENC_KT = 8;       // 512 columns, the last 8 zero
constexpr float F32_EPS = 1.1920928955078125e-07f;

__device__ __forceinline__ size_t tile_off(long long mt, int kt, int KT) {
  return ((size_t)mt * KT + kt) * TILE;
}

__device__ __forceinline__ void expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One bulk store of `bytes` from shared to global memory, and the waits for
// this thread's bulk stores (`.read`: until their sources may be written
// again), by the threads where `pred` holds, predicated, not branched.
__device__ __forceinline__ void bulk_store_if(void* dst, uint32_t src, int bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n@p cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"l"(dst),
      "r"(src), "r"(bytes), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void bulk_wait_read_if(bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group.read 0;\n}\n" ::"r"((int)pred)
               : "memory");
}
__device__ __forceinline__ void bulk_wait_if(bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group 0;\n}\n" ::"r"((int)pred)
               : "memory");
}

// ---------------------------------------------------------------------------
// K11: one dense layer.

// What a launch computes after its products: a hidden layer (ReLU, stored),
// the same with the density head, the density head alone (no launch of its
// own: the last layer of EPI_PROP), the bottleneck (no activation, stored),
// the view layer with the rgb head, and EPI_PROP, the proposal MLP whole:
// PROP_LAYERS layers of width BN, each after the first reading the one
// before from the warpgroup's output tile in shared memory, then its
// density head.
enum { EPI_HIDDEN = 0, EPI_HIDDEN_DENSITY = 1, EPI_DENSITY = 2, EPI_LINEAR = 3, EPI_RGB = 4, EPI_PROP = 5 };
constexpr int PROP_LAYERS = 4;

struct LinArgs {
  const unsigned char* a0;  // slabs of the first input, kt0 column tiles
  const unsigned char* a1;  // slabs of the second (the skip layer's encoding), kt1 column tiles
  int kt0, kt1;
  const unsigned char* w;   // [n / BN][kt0 + kt1][BN x 128 B] (EPI_PROP: then each later layer's BN / 64 slabs)
  const float* bias;        // [n], or [rows / rows_per_bias, n] when rows_per_bias > 0 (EPI_PROP: a layer's after another)
  int rows_per_bias;
  unsigned char* out;       // slabs of the output, kt_out column tiles
  int kt_out;
  float* dens;              // [rows, n / BN] the density head's sums by column block
  const float* wd;          // [n] its weights, bf16 values
  float* rgb;               // [rows, 3] after the sigmoid
  const float* wrgb;        // [n, 3] bf16 values
  const float* brgb;        // [3]
  int n;
  int tiles;                // (rows / 128) x (n / BN), row block major
};

template <int BN> struct LinLay {
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = 2 * TILE + B_BYTES;
  static constexpr int OUT = 64 * BN * 2;  // a warpgroup's output tile, BN / 64 slabs
  static constexpr int RING = (SMEM_LIMIT - 1024 - 256 - 2 * OUT) / STAGE;
  static constexpr int BYTES = 1024 + RING * STAGE + 2 * OUT + 16 * RING;
};

// A persistent block takes tiles blockIdx.x, + gridDim.x, ...: the producer
// runs ahead into the next tile's k-tiles while the consumers store this
// one's (a block a tile paid ~8 us a tile in launch, barrier set-up and the
// ring's first fill, against ~0.68 us a k-tile; PERF.md). KT, the
// k-tiles of a row, is a template argument: the consumers' loop over them is
// unrolled whole, as `product`'s in hopper.cuh.
template <int BN, int EPI, int KT>
__global__ void __launch_bounds__(RK_THREADS, 1) linear_kernel(const __grid_constant__ LinArgs p) {
  typedef LinLay<BN> L;
  constexpr int NL = EPI == EPI_PROP ? PROP_LAYERS : 1;  // layers a tile takes
  constexpr int TOT = KT + (NL - 1) * (BN / 64);          // their k-tiles
  constexpr int LAST = EPI == EPI_PROP ? EPI_DENSITY : EPI;  // the last layer's epilogue
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const uint32_t stage0 = saddr(smem), out0 = stage0 + L::RING * L::STAGE, full0 = out0 + 2 * L::OUT,
                 empty0 = full0 + 8 * L::RING;
  const int tid = threadIdx.x;
  const int NB = p.n / BN;
  if (tid == 0) {
    for (int s = 0; s < L::RING; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(RK_PRODUCER_REGS));
    if (tid == N_CONSUMERS) {
      int g = 0;  // k-tiles issued since the launch
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int nb = tile % NB;
        const long long bm = tile / NB;
        const unsigned char* wsrc = p.w + (size_t)nb * TOT * L::B_BYTES;
        for (int k = 0; k < TOT; ++k, ++g) {
          const int s = g % L::RING, u = g / L::RING;
          if (u > 0) mbar_wait(empty0 + 8 * s, (u - 1) & 1);
          const uint32_t st = stage0 + s * L::STAGE, bar = full0 + 8 * s;
          if (k < KT) {  // the first layer's A tiles; a later layer's A is in shared memory
            const bool first = k < p.kt0;
            const int kts = first ? p.kt0 : p.kt1;
            const unsigned char* a = (first ? p.a0 : p.a1) + tile_off(2 * bm, first ? k : k - p.kt0, kts);
            expect_tx(bar, L::STAGE);
            bulk_copy(st, a, TILE, bar);
            bulk_copy(st + TILE, a + (size_t)kts * TILE, TILE, bar);
          } else {
            expect_tx(bar, L::B_BYTES);
          }
          bulk_copy(st + 2 * TILE, wsrc + (size_t)k * L::B_BYTES, L::B_BYTES, bar);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(RK_CONSUMER_REGS));

  const int wg = tid >> 7;
  const bool leader = (tid & 127) == 0;
  const int t = tid & 127;
  const int r0 = (t >> 5) * 16 + ((t & 31) >> 2), c0 = 2 * (t & 3);
  float d[BN / 2];
  int g0 = 0;  // this tile's first k-tile since the launch
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, g0 += TOT) {
    const int nb = tile % NB;
    const long long mt = 2 * (long long)(tile / NB) + wg;  // this warpgroup's 64-row tile
    unsigned char* out_s = smem + L::RING * L::STAGE + wg * L::OUT;
    const uint32_t out_a = saddr(out_s);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int kts = l == 0 ? KT : BN / 64, gl = g0 + (l == 0 ? 0 : KT + (l - 1) * (BN / 64));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kts; ++k) {
        const int g = gl + k, s = g % L::RING;
        mbar_wait(full0 + 8 * s, (g / L::RING) & 1);
        const uint32_t st = stage0 + s * L::STAGE;
        const uint32_t a = l == 0 ? st + wg * TILE : out_a + k * TILE;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_bf16<BN>(d, desc(a + 32 * kk), desc(st + 2 * TILE + 32 * kk), 1);
        wgmma_commit();
        if (k > 0) {
          wgmma_wait<1>();
          mbar_arrive_if(empty0 + 8 * ((g - 1) % L::RING), leader);
        }
      }
      wgmma_wait<0>();
      mbar_arrive_if(empty0 + 8 * ((gl + kts - 1) % L::RING), leader);
      fence_acc(d);
      if (l < NL - 1) {
        // A hidden layer of the chain: its output is the next layer's A.
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h, cl = c0 + 8 * j;
            const float* bias = p.bias + l * BN;
            const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(d[4 * j + 2 * h] + bias[cl], 0.f),
                                                           fmaxf(d[4 * j + 2 * h + 1] + bias[cl + 1], 0.f));
            *reinterpret_cast<__nv_bfloat162*>(out_s + (cl >> 6) * TILE + swz(r, (cl & 63) * 2)) = v;
          }
        }
        fence_proxy_async();  // the generic writes, seen by the next layer's products
        warpgroup_sync();
        continue;
      }

      // Epilogue: this thread's pairs of columns in rows r0 and r0 + 8, into
      // the warpgroup's output tile in shared memory (its slabs' layout), once
      // the bulk store of the tile before has read it; then one bulk store.
      constexpr bool STORE = LAST == EPI_HIDDEN || LAST == EPI_HIDDEN_DENSITY || LAST == EPI_LINEAR;
      if constexpr (STORE) {
        bulk_wait_read_if(leader);
        warpgroup_sync();
      }
      float head[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, col = nb * BN + c0 + 8 * j;
          const float* bias = p.bias + (NL - 1) * BN +
                              (p.rows_per_bias > 0 ? ((mt * 64 + r) / p.rows_per_bias) * p.n : 0);
          float y0 = d[4 * j + 2 * h] + bias[col], y1 = d[4 * j + 2 * h + 1] + bias[col + 1];
          if constexpr (LAST != EPI_LINEAR) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          const __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
          if constexpr (STORE) {
            const int cl = c0 + 8 * j;
            *reinterpret_cast<__nv_bfloat162*>(out_s + (cl >> 6) * TILE + swz(r, (cl & 63) * 2)) = v;
          }
          const float2 f = __bfloat1622float2(v);
          if constexpr (LAST == EPI_HIDDEN_DENSITY || LAST == EPI_DENSITY)
            head[h][0] += f.x * p.wd[col] + f.y * p.wd[col + 1];
          if constexpr (LAST == EPI_RGB) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) head[h][ch] += f.x * p.wrgb[col * 3 + ch] + f.y * p.wrgb[col * 3 + 3 + ch];
          }
        }
      }
      if constexpr (STORE) {
        fence_proxy_async();  // the tile's generic writes, seen by the bulk copy
        warpgroup_sync();
        bulk_store_if(p.out + tile_off(mt, nb * (BN / 64), p.kt_out), out_a, L::OUT, leader);
      }
      if constexpr (LAST == EPI_HIDDEN_DENSITY || LAST == EPI_DENSITY || LAST == EPI_RGB) {
        constexpr int NH = LAST == EPI_RGB ? 3 : 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int ch = 0; ch < NH; ++ch) {
            head[h][ch] += __shfl_xor_sync(0xffffffffu, head[h][ch], 1);
            head[h][ch] += __shfl_xor_sync(0xffffffffu, head[h][ch], 2);
          }
          const long long row = mt * 64 + r0 + 8 * h;
          if ((t & 3) == 0) {
            if constexpr (LAST == EPI_RGB) {
#pragma unroll
              for (int ch = 0; ch < 3; ++ch)
                p.rgb[row * 3 + ch] = 1.002f / (1.f + expf(-(head[h][ch] + p.brgb[ch]))) - 0.001f;
            } else {
              p.dens[row * NB + nb] = head[h][0];
            }
          }
        }
      }
    }
  }
  bulk_wait_if(leader);  // the last tile's store complete before the block exits
}

template <int BN, int EPI, int KT>
cudaError_t launch_linear(const LinArgs& a, int blocks, cudaStream_t cs) {
  typedef LinLay<BN> L;
  auto kernel = linear_kernel<BN, EPI, KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<blocks < a.tiles ? blocks : a.tiles, RK_THREADS, L::BYTES, cs>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10: the integrated encoding.

constexpr int ENC_ROWS = 64, ENC_THREADS = 256;
constexpr int ENC_SMEM = ENC_KT * TILE;

// sin and cos of p: p - q pi/2 by two fused multiply-adds (q pi/2's head
// exact, the tail's error ~|q| 1.7e-15), then sincos_poly's polynomials.
__device__ __forceinline__ void sincos_red(float p, float& s, float& c) {
  const float q = rintf(p * 0.6366197723675814f);
  float r = fmaf(-q, 1.57079637050628662109375f, p);
  r = fmaf(-q, -4.37113900018624283e-8f, r);
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

__global__ void __launch_bounds__(ENC_THREADS) encode_kernel(const float* __restrict__ o, const float* __restrict__ dir,
                                                             const float* __restrict__ radii,
                                                             const float* __restrict__ tdist,
                                                             const float* __restrict__ basis,
                                                             unsigned char* __restrict__ out, int S) {
  extern __shared__ __align__(16) unsigned char tile[];  // ENC_KT slabs of 64 rows
  __shared__ float g[ENC_ROWS][9];                        // contracted mean, covariance xx xy xz yy yz zz
  __shared__ float bs[N_BASIS * 3];
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * ENC_ROWS;
  if (tid < N_BASIS * 3) bs[tid] = basis[tid];
  for (int i = tid; i < ENC_ROWS; i += ENC_THREADS)  // the zero columns 504..511: bytes 112..127 of slab 7
    *reinterpret_cast<uint4*>(tile + 7 * TILE + swz(i, 112)) = make_uint4(0, 0, 0, 0);
  if (tid < ENC_ROWS) {
    const long long row = row0 + tid;
    const long long ray = row / S;
    const int k = (int)(row % S);
    const float t0 = tdist[ray * (S + 1) + k], t1 = tdist[ray * (S + 1) + k + 1];
    const float mu = (t0 + t1) / 2, hw = (t1 - t0) / 2;
    const float mu2 = mu * mu, hw2 = hw * hw;
    const float denom = fmaxf(F32_EPS, 3 * mu2 + hw2);
    const float t_mean = mu + (2 * mu * hw2) / denom;
    const float t_var = hw2 / 3 - (4.f / 15) * hw2 * hw2 * (12 * mu2 - hw2) / (denom * denom);
    const float rr = radii[ray];
    const float r_var = (mu2 / 4 + (5.f / 12) * hw2 - (4.f / 15) * hw2 * hw2 / denom) * (rr * rr);
    float x[3], dv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dv[a] = dir[ray * 3 + a];
      x[a] = o[ray * 3 + a] + t_mean * dv[a];
    }
    const float dd = fmaxf(1e-10f, dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2]);
    float cov[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        cov[a][b] = t_var * dv[a] * dv[b] + r_var * ((a == b ? 1.f : 0.f) - dv[a] * dv[b] / dd);
    const float ms = fmaxf(F32_EPS, x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
    if (ms > 1.f) {
      // J = s I + c x x^T (symmetric); cov <- J cov J, x <- s x.
      const float n = sqrtf(ms), s = (2 * n - 1) / ms, c = 2 * (1 - n) / (ms * ms);
      float J[3][3], T[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) J[a][b] = (a == b ? s : 0.f) + c * x[a] * x[b];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) T[a][b] = J[a][0] * cov[0][b] + J[a][1] * cov[1][b] + J[a][2] * cov[2][b];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) cov[a][b] = T[a][0] * J[0][b] + T[a][1] * J[1][b] + T[a][2] * J[2][b];
#pragma unroll
      for (int a = 0; a < 3; ++a) x[a] *= s;
    }
    float* gr = g[tid];
    gr[0] = x[0], gr[1] = x[1], gr[2] = x[2];
    gr[3] = cov[0][0], gr[4] = cov[0][1], gr[5] = cov[0][2], gr[6] = cov[1][1], gr[7] = cov[1][2], gr[8] = cov[2][2];
  }
  __syncthreads();
  for (int pr = tid; pr < ENC_ROWS * N_BASIS; pr += ENC_THREADS) {
    const int r = pr / N_BASIS, j = pr % N_BASIS;
    const float* gr = g[r];
    const float b0 = bs[3 * j], b1 = bs[3 * j + 1], b2 = bs[3 * j + 2];
    const float m = b0 * gr[0] + b1 * gr[1] + b2 * gr[2];
    const float v = b0 * (b0 * gr[3] + b1 * gr[4] + b2 * gr[5]) + b1 * (b0 * gr[4] + b1 * gr[6] + b2 * gr[7]) +
                    b2 * (b0 * gr[5] + b1 * gr[7] + b2 * gr[8]);
#pragma unroll
    for (int l = 0; l < N_DEG; ++l) {
      float sn, cs;
      sincos_red(m * (float)(1 << l), sn, cs);
      const float damp = __expf(-0.5f * (float)(1 << (2 * l)) * v);
      const int fs = l * N_BASIS + j, fc = ENC / 2 + fs;
      *reinterpret_cast<bf16*>(tile + (fs >> 6) * TILE + swz(r, (fs & 63) * 2)) = __float2bfloat16(damp * sn);
      *reinterpret_cast<bf16*>(tile + (fc >> 6) * TILE + swz(r, (fc & 63) * 2)) = __float2bfloat16(damp * cs);
    }
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)blockIdx.x * ENC_SMEM);
  const uint4* src = reinterpret_cast<const uint4*>(tile);
  for (int i = tid; i < ENC_SMEM / 16; i += ENC_THREADS) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// K12: placement, a ray a thread; its step functions in shared memory,
// element i of a ray at [i][lane].

constexpr int PL_THREADS = 64, PL_MAX = 196;  // edges: 3 x 64 + 1 after dilating 64 intervals
constexpr int PL_SMEM = 2 * PL_MAX * PL_THREADS * 4;

__global__ void __launch_bounds__(PL_THREADS) place_kernel(const float* __restrict__ t_in,
                                                           const float* __restrict__ w_in, int m, float dil,
                                                           float* __restrict__ s_out, float* __restrict__ t_out,
                                                           int n_out, int n_rays, float inv_near, float inv_far) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  const long long ray = (long long)blockIdx.x * PL_THREADS + lane;
  if (ray >= n_rays) return;
  float* T = sm + lane;                       // T[i * PL_THREADS]: edges, then the CDF's abscissae
  float* W = sm + PL_MAX * PL_THREADS + lane;  // weights, then the CDF
#define TA(i) T[(i) * PL_THREADS]
#define WA(i) W[(i) * PL_THREADS]
  const float* t = t_in + ray * (m + 1);
  const float* w = w_in + ray * m;
  const float eps2 = F32_EPS * F32_EPS;
  int me = m;  // intervals of the step function sampled
  if (dil < 0.f) {
    for (int i = 0; i <= m; ++i) TA(i) = t[i];
    for (int i = 0; i < m; ++i) WA(i) = w[i];
  } else {
    // The sorted union of the edges and the widened edges, clipped to [0, 1].
    int a = 0, b = 0, c = 0;
    for (int k = 0; k <= 3 * m; ++k) {
      const float va = a <= m ? t[a] : INFINITY, vb = b < m ? t[b] - dil : INFINITY,
                  vc = c < m ? t[c + 1] + dil : INFINITY;
      float v;
      if (va <= vb && va <= vc) v = va, ++a;
      else if (vb <= vc) v = vb, ++b;
      else v = vc, ++c;
      TA(k) = fminf(fmaxf(v, 0.f), 1.f);
    }
    // Each interval's density: the largest of those whose widened span
    // [t_i - dil, t_(i+1) + dil) holds its left edge.
    int lo = 0, hi = -1;
    float total = 0.f;
    for (int k = 0; k < 3 * m; ++k) {
      const float x = TA(k);
      while (lo < m && t[lo + 1] + dil <= x) ++lo;
      while (hi + 1 < m && t[hi + 1] - dil <= x) ++hi;
      float pmax = 0.f;
      for (int i = lo; i <= hi; ++i) pmax = fmaxf(pmax, w[i] / fmaxf(eps2, t[i + 1] - t[i]));
      const float wk = pmax * (TA(k + 1) - TA(k));
      WA(k) = wk;
      total += wk;
    }
    const float den = fmaxf(eps2, total);
    for (int k = 0; k + 2 < 3 * m; ++k) WA(k) = WA(k + 1) / den;
    for (int k = 0; k + 1 < 3 * m; ++k) TA(k) = TA(k + 1);
    me = 3 * m - 2;
  }
  // Weights of empty intervals dropped, normalised, into the CDF (in place).
  float sum = 0.f;
  for (int k = 0; k < me; ++k) {
    const float v = TA(k + 1) > TA(k) ? WA(k) : 0.f;
    WA(k) = v;
    sum += v;
  }
  float run = 0.f;
  for (int k = 0; k < me; ++k) {
    const float wk = WA(k) / sum;
    WA(k) = fminf(1.f, run);
    run += wk;
  }
  WA(me) = 1.f;
  // Centres at u = linspace(1/2N, 1 - 1/2N - eps, N); edges the midpoints,
  // the outer two reflected and clipped to [0, 1].
  const float pad = 1.f / (2 * n_out), step = (1.f - pad - F32_EPS - pad) / (n_out - 1);
  float* so = s_out + ray * (n_out + 1);
  float* to = t_out + ray * (n_out + 1);
  auto put = [&](int i, float s) {
    so[i] = s;
    to[i] = 1.f / (s * inv_far + (1.f - s) * inv_near);
  };
  float prev = 0.f, first_c = 0.f;
  for (int k = 0; k < n_out; ++k) {
    const float u = pad + k * step;
    int l = 0, h = me;  // WA(l) <= u < WA(h)
    while (h - l > 1) {
      const int mid = (l + h) >> 1;
      if (WA(mid) <= u) l = mid;
      else h = mid;
    }
    const float x0 = WA(l), dx = WA(l + 1) - x0, f0 = TA(l), f1 = TA(l + 1);
    const float cen = dx <= 1.4e-14f ? f0 : f0 + (u - x0) / dx * (f1 - f0);
    if (k == 0) {
      first_c = cen;
    } else {
      const float mid = (prev + cen) / 2;
      if (k == 1) put(0, fmaxf(0.f, 2 * first_c - mid));
      put(k, mid);
    }
    prev = cen;
  }
  put(n_out, fminf(1.f, 2 * prev - so[n_out - 1]));
#undef TA
#undef WA
}

// ---------------------------------------------------------------------------
// K13: compositing, a ray a thread.

__global__ void composite_kernel(const float* __restrict__ tdist, const float* __restrict__ dens, int parts,
                                 float b_sigma, const float* __restrict__ dnorm, const float* __restrict__ rgb,
                                 float* __restrict__ weights, float* __restrict__ color, int n_rays, int S) {
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const float* t = tdist + ray * (S + 1);
  const float dn = dnorm[ray];
  float cum = 0.f, c[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < S; ++i) {
    const long long row = ray * S + i;
    float raw = 0.f;
    for (int q = 0; q < parts; ++q) raw += dens[row * parts + q];
    const float x = raw + b_sigma - 1.f;
    const float sig = x > 20.f ? x : log1pf(expf(x));
    const float dt = i == S - 1 ? 1e10f : t[i + 1] - t[i];
    const float dd = sig * dt * dn;
    const float wi = (1.f - expf(-dd)) * expf(-cum);
    cum += dd;
    if (weights != nullptr) weights[row] = wi;
    if (rgb != nullptr) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] += wi * rgb[row * 3 + ch];
    }
  }
  if (color != nullptr) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) color[ray * 3 + ch] = c[ch];
  }
}

}  // namespace

extern "C" int m360_encode_launch(const float* o, const float* d, const float* radii, const float* tdist,
                                  const float* basis, void* out, int n_rays, int n_samples, void* stream) {
  const long long rows = (long long)n_rays * n_samples;
  if (n_rays < 1 || n_samples < 2 || rows % ENC_ROWS != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ENC_SMEM);
  if (err != cudaSuccess) return (int)err;
  encode_kernel<<<(unsigned)(rows / ENC_ROWS), ENC_THREADS, ENC_SMEM, static_cast<cudaStream_t>(stream)>>>(
      o, d, radii, tdist, basis, static_cast<unsigned char*>(out), n_samples);
  return (int)cudaGetLastError();
}

extern "C" int m360_linear_launch(int epi, const void* a0, int kt0, const void* a1, int kt1, const void* w,
                                  const float* bias, int rows_per_bias, void* out, int kt_out, float* dens,
                                  const float* wd, float* rgb, const float* wrgb, const float* brgb, int rows, int n,
                                  void* stream) {
  const int bn = epi == EPI_RGB ? 128 : 256;
  if (rows < 128 || rows % 128 != 0 || n < bn || n % bn != 0 || kt0 < 1 || kt1 < 0) return (int)cudaErrorInvalidValue;
  if (epi == EPI_RGB && n != bn) return (int)cudaErrorInvalidValue;  // the rgb head needs the whole row
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const LinArgs a{static_cast<const unsigned char*>(a0), static_cast<const unsigned char*>(a1), kt0, kt1,
                  static_cast<const unsigned char*>(w), bias, rows_per_bias, static_cast<unsigned char*>(out), kt_out,
                  dens, wd, rgb, wrgb, brgb, n, (rows / 128) * (n / bn)};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int kt = kt0 + kt1;
  // The layers mip-NeRF 360 has: the proposal MLP whole (its first layer's
  // k-tiles 8), the NeRF MLP's (8, 16 x 3, 24 at the skip, 16, 16), its
  // bottleneck (16) and view layer (4).
#define LIN_CASE(BN_, EPI_, KT_) \
  if (epi == EPI_ && kt == KT_) return (int)launch_linear<BN_, EPI_, KT_>(a, sms, cs);
  LIN_CASE(256, EPI_PROP, 8)
  LIN_CASE(256, EPI_HIDDEN, 8)
  LIN_CASE(256, EPI_HIDDEN, 16)
  LIN_CASE(256, EPI_HIDDEN, 24)
  LIN_CASE(256, EPI_HIDDEN_DENSITY, 16)
  LIN_CASE(256, EPI_LINEAR, 16)
  LIN_CASE(128, EPI_RGB, 4)
#undef LIN_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int m360_place_launch(const float* t_in, const float* w_in, int m, float dilation, float* s_out,
                                 float* t_out, int n_out, int n_rays, float inv_near, float inv_far, void* stream) {
  if (m < 1 || (dilation >= 0.f ? 3 * m + 1 : m + 1) > PL_MAX || n_out < 2 || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PL_SMEM);
  if (err != cudaSuccess) return (int)err;
  place_kernel<<<(n_rays + PL_THREADS - 1) / PL_THREADS, PL_THREADS, PL_SMEM, static_cast<cudaStream_t>(stream)>>>(
      t_in, w_in, m, dilation, s_out, t_out, n_out, n_rays, inv_near, inv_far);
  return (int)cudaGetLastError();
}

extern "C" int m360_composite_launch(const float* tdist, const float* dens, int parts, float b_sigma,
                                     const float* dnorm, const float* rgb, float* weights, float* color, int n_rays,
                                     int n_samples, void* stream) {
  if (n_rays < 1 || n_samples < 2 || parts < 1) return (int)cudaErrorInvalidValue;
  composite_kernel<<<(n_rays + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      tdist, dens, parts, b_sigma, dnorm, rgb, weights, color, n_rays, n_samples);
  return (int)cudaGetLastError();
}
