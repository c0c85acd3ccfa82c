// Device code shared by the Hopper kernels that stream packed weights
// through a ring of shared-memory stages into wgmma products: the fused
// render kernels (fused_render.cu, K1/K3/K7/K8) and the training field
// kernels (train_field.cu, K4/K5).
//
// A block of RK_THREADS threads is three warpgroups: warpgroups 0 and 1 are
// consumers that own rows [0, 64) and [64, 128) of a 128-point step (MP),
// warpgroup 2 the producer, whose one elected thread bulk-copies the slabs
// of a packed weight stream (`StreamT`: offsets and byte counts into one
// buffer) into a ring of stages, each guarded by an mbarrier full/empty
// pair (`produce`). A consumer's `product` waits for each slab, issues its
// wgmma k-steps and releases the stage once they completed. Operand tiles
// and slabs use the 128-byte swizzle of `swz`; activation regions are
// 128-byte column blocks of WG_ROWS rows (`act_off`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

#define MP 128                 // points of a block step
#define WG_ROWS 64             // rows of a step per consumer warpgroup
#define N_CONSUMERS 256        // threads of the two consumer warpgroups
#define RK_THREADS 384         // + the producer warpgroup
#define SMEM_LIMIT 232448      // dynamic shared memory a block may use
#define RK_CONSUMER_REGS 232   // registers of a consumer / producer thread after setmaxnreg:
#define RK_PRODUCER_REGS 40    // 2 x 128 x 232 + 128 x 40 <= 65,536


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

namespace rk {

typedef signed char s8;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <typename T> struct Tr;
template <> struct Tr<bf16> { typedef float AccT; };
template <> struct Tr<s8> { typedef int AccT; };

// One step's weight stream: slab j is bytes[j] bytes at base + off[j].
template <int MAX_SLABS_> struct StreamT {
  const unsigned char* base;
  int n;
  int off[MAX_SLABS_];
  int bytes[MAX_SLABS_];
};

// ---------------------------------------------------------------------------
// Hopper primitives.

__device__ __forceinline__ uint32_t saddr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// The spin is inside the asm: a loop in C would be a divergent branch to
// the compiler, which then serialises the wgmma around it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra LAB_WAIT;\n}\n" ::"r"(
          bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// mbar_arrive by the threads where `pred` holds, predicated, not branched.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
               "r"((int)pred)
               : "memory");
}

// One bulk copy of `bytes` from global to shared memory, completing on `bar`
// (whose phase expects the bytes).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void consumers_sync() { named_sync(1, N_CONSUMERS); }
__device__ __forceinline__ void warpgroup_sync() { named_sync(2 + (threadIdx.x >> 7), 128); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (stride byte offset), tile bases 1024-aligned; a k-step
// advances the start address by 32 bytes inside the row.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Byte b (< 128) of row r of a 128-byte-row swizzled tile.
__host__ __device__ __forceinline__ int swz(int r, int b) { return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15); }

// Byte b of row r of a warpgroup's activation region: 128-byte column
// blocks of WG_ROWS rows each.
__device__ __forceinline__ int act_off(int r, int b) { return (b >> 7) * (WG_ROWS * 128) + swz(r, b & 127); }

struct SwRow {  // one row of a swizzled tile
  unsigned char* p;
  int r;
  __device__ __forceinline__ unsigned char* at(int b) const { return p + ((((b >> 4) ^ r) & 7) << 4) + (b & 15); }
};

template <typename T, int N>
__device__ __forceinline__ void mma(typename Tr<T>::AccT (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (sizeof(T) == 2)
    wgmma_bf16<N>(d, a, b, 1);
  else
    wgmma_s8<N>(d, a, b, 1);
}

// The consumers' position in the weight ring.
struct Ring {
  uint32_t stage0;  // shared address of stage 0
  uint32_t full0;   // full barriers, 8 bytes apart
  uint32_t empty0;  // empty barriers
  int k;            // slabs consumed since the launch
};

// d1 (+ d2) (+)= A . B^T over KB bytes of depth, B the next ceil(KB / 128)
// slabs of the stream ([N1 (+ N2) rows x 128 B] each; d2 takes rows N1..),
// A this warpgroup's 64 rows at shared address `a`, its 128-byte column
// blocks `a_kbs` bytes apart. Zeroes the accumulators first when ZERO (a
// template argument: a runtime flag would keep the accumulators live across
// a whole step, and put the compiler's wgmma fences on a divergent path).
// Each slab's stage is released once the products reading it completed.
template <typename T, int N1, int N2, int KB, int RING, int STAGE, bool ZERO = true>
__device__ __forceinline__ void product(typename Tr<T>::AccT (&d1)[N1 / 2],
                                        typename Tr<T>::AccT (&d2)[N2 > 0 ? N2 / 2 : 1], uint32_t a, int a_kbs,
                                        Ring& ring) {
  constexpr int NS = (KB + 127) / 128;
  if constexpr (ZERO) {
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) d1[i] = 0;
    if constexpr (N2 > 0) {
#pragma unroll
      for (int i = 0; i < N2 / 2; ++i) d2[i] = 0;
    }
  }
  wgmma_fence();
  int prev = 0;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int s = ring.k % RING;
    mbar_wait(ring.full0 + 8 * s, (ring.k / RING) & 1);
    const uint32_t b = ring.stage0 + s * STAGE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < cmin(4, (KB - 128 * j) / 32)) {
        const uint64_t da = desc(a + j * a_kbs + 32 * kk);
        mma<T, N1>(d1, da, desc(b + 32 * kk));
        if constexpr (N2 > 0) mma<T, N2>(d2, da, desc(b + N1 * 128 + 32 * kk));
      }
    }
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      mbar_arrive_if(ring.empty0 + 8 * prev, (threadIdx.x & 127) == 0);
    }
    prev = s;
    ++ring.k;
  }
  wgmma_wait<0>();
  mbar_arrive_if(ring.empty0 + 8 * prev, (threadIdx.x & 127) == 0);
  fence_acc(d1);
  if constexpr (N2 > 0) fence_acc(d2);
}

// f(local row, column, value at column, value at column + 1) over this
// thread's accumulator pairs of a 64 x N product, in its first NJ blocks of
// 8 columns.
template <int N, int NJ, typename AccT, typename Fn>
__device__ __forceinline__ void for_pairs(const AccT (&d)[N / 2], Fn f) {
  const int t = threadIdx.x & 127;
  const int r0 = (t >> 5) * 16 + ((t & 31) >> 2), c0 = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    f(r0, c0 + 8 * j, d[4 * j], d[4 * j + 1]);
    f(r0 + 8, c0 + 8 * j, d[4 * j + 2], d[4 * j + 3]);
  }
}

// One coordinate's encoding rows in kernel order from its base phase p, into a
// swizzled bf16 row: e[c] = p, e[3 + 3k + c] = sin(2^k p), e[3 + 3F + 3k + c] =
// cos(2^k p), by octave doubling from one polynomial sin/cos pair (the TPU
// kernels' _encode_ladder), each rounded to bf16.
template <int F>
__device__ __forceinline__ void encode_coord_sw(SwRow e, int c, float p) {
  auto put = [&](int k, float x) { *reinterpret_cast<bf16*>(e.at(2 * k)) = __float2bfloat16(x); };
  put(c, p);
  float sn, cs;
  sincos_poly(p, sn, cs);
  for (int k = 0; k < F; ++k) {
    put(3 + 3 * k + c, sn);
    put(3 + 3 * F + 3 * k + c, cs);
    const float s2 = 2.f * sn * cs;
    cs = 1.f - 2.f * sn * sn;
    sn = s2;
  }
}

// The producer: one thread keeps the ring full for n_groups steps of
// st.n slabs, until the consumers raise `stop` (drain rule, fused_render.cu's note).
template <int RING, int STAGE, typename S>
__device__ __forceinline__ void produce(const S& st, int n_groups, uint32_t stage0, uint32_t full0,
                                        uint32_t empty0, uint32_t done, volatile int* stop, int* n_issued) {
  const int total = st.n * n_groups;
  int k = 0;
  for (int j = 0; k < total; ++k) {
    const int s = k % RING, u = k / RING;
    if (u > 0) {
      bool ok;
      while (!(ok = mbar_try_wait(empty0 + 8 * s, (u - 1) & 1)) && !*stop) {
      }
      if (!ok) break;
    }
    if (*stop) break;
    bulk_load(stage0 + s * STAGE, st.base + st.off[j], st.bytes[j], full0 + 8 * s);
    if (++j == st.n) j = 0;
  }
  *n_issued = k;
  mbar_arrive(done);
}

}  // namespace rk
