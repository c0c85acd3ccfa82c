// int4 probe legs for Hopper (sm_90a): int4 widened to bf16 on wgmma.
//
// Replaces: scripts/probe_int4_tpu.py's two pallas_call legs (:42 and :72),
//   each `int4 [M, K] widened to bf16 @ bf16 [K, N] -> fp32`. Leg 1 takes the
//   int4 matrix one value per byte (int8 storage holding [-8, 7]: PyTorch has
//   no arithmetic int4 type); leg 2 packed two to a byte, uint8 [M/2, K], the
//   low nibble row 2i and the high nibble row 2i + 1, sign-extended by shifts.
//
// What bounds it on this card: at the probe's 128 x 128 x 128, nothing but
//   the launch: 4.2 MFLOP and ~110 KB take a few nanoseconds at the peaks,
//   and a launch through the ctypes binding costs microseconds. The
//   question is whether int4 operands reach the tensor cores: wgmma has no
//   4-bit type and mma.sync multiplies s4 only by s4, so, as on the TPU, each
//   value widens to bf16 (exact for [-8, 7]) before a bf16 product with fp32
//   accumulation.
//
// What the design does: a block of one warpgroup owns a 64-row stripe of A
//   and 128 columns of the result (2 blocks at the probe's shape). It starts
//   16-byte cp.async copies of its B columns ([K, 128], row-major, so an
//   MN-major wgmma operand: the transpose bit) into their 128-byte-swizzled
//   places, meanwhile reads its A stripe with 16-byte vector loads, widens
//   it in registers (the nibbles of leg 2 by shifts) and stores it as a
//   K-major swizzled bf16 tile; after a proxy fence and one barrier, 8 wgmma
//   m64n128k16 k-steps accumulate in fp32 registers, which are stored to the
//   result directly. K is 128: A and B fit the 48 KB of static shared memory.

#include "hopper.cuh"

namespace {

using namespace rk;

constexpr int BM = 64;                // rows of a block (one warpgroup)
constexpr int BN = 128;               // result columns of a block
constexpr int KD = 128;               // the depth the kernel takes
constexpr int A_BLOCK = BM * 128;     // one 64-value (128-byte) column block of the A tile
constexpr int B_BLOCK = KD * 128;     // one 64-column block of the B tile: K rows of 128 bytes
constexpr int A_BYTES = 2 * A_BLOCK;  // K = 128 bf16: two column blocks
constexpr int SMEM = A_BYTES + 2 * B_BLOCK;

// B in the 128-byte swizzle, MN-major: rows are k, 8-row groups 1024 bytes
// apart (stride byte offset), the two 64-column blocks B_BLOCK apart
// (leading byte offset); a k-step of 16 rows advances 2048 bytes.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(B_BLOCK >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// 8 widened values (v0 .. v7, ints in [-8, 7]) as 8 bf16 in 16 bytes.
__device__ __forceinline__ uint4 widen8(const int (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn((float)v[2 * i], (float)v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Values k0 .. k0 + 15 of row r into the K-major swizzled A tile (two 16-byte chunks).
__device__ __forceinline__ void store_a16(unsigned char* a_tile, int r, int k0, const int (&v)[16]) {
  int lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lo[i] = v[i];
    hi[i] = v[8 + i];
  }
  const int b = 2 * k0;  // byte in the row: block b / 128, byte b % 128 within it
  unsigned char* blk = a_tile + (b >> 7) * A_BLOCK;
  *reinterpret_cast<uint4*>(blk + swz(r, b & 127)) = widen8(lo);
  *reinterpret_cast<uint4*>(blk + swz(r, (b & 127) + 16)) = widen8(hi);
}

// The signed 4-bit value in bits [4 s, 4 s + 4) of w, by shifts.
__device__ __forceinline__ int nibble(uint32_t w, int s) { return (int)(w << (28 - 4 * s)) >> 28; }

template <bool PACKED>
__global__ void __launch_bounds__(128, 1)
int4_probe_kernel(const unsigned char* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                  float* __restrict__ out, int N) {
  __shared__ __align__(1024) unsigned char smem[SMEM];
  unsigned char* a_tile = smem;
  const uint32_t a_s = saddr(smem), b_s = a_s + A_BYTES;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // B columns [n0, n0 + 128): 16-byte chunk c of row k (columns n0 + 8 c ..)
  // to block c / 8, swizzled row k.
  for (int v = tid; v < KD * (BN / 8); v += 128) {
    const int k = v >> 4, c = v & 15;
    cp_async16(b_s + (c >> 3) * B_BLOCK + swz(k, 16 * (c & 7)), b + (size_t)k * N + n0 + 8 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  if constexpr (PACKED) {
    // Packed rows m0 / 2 .. + 31, 8 chunks of 16 bytes each: chunk c of
    // packed row p gives rows 2 p (low nibbles) and 2 p + 1 (high) at
    // k = 16 c .. 16 c + 15.
    for (int v = tid; v < (BM / 2) * (KD / 16); v += 128) {
      const int p = v >> 3, c = v & 7;
      const uint4 q = *reinterpret_cast<const uint4*>(a + (size_t)(m0 / 2 + p) * KD + 16 * c);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
      int lo[16], hi[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        lo[i] = nibble(w[i >> 2], 2 * (i & 3));
        hi[i] = nibble(w[i >> 2], 2 * (i & 3) + 1);
      }
      store_a16(a_tile, 2 * p, 16 * c, lo);
      store_a16(a_tile, 2 * p + 1, 16 * c, hi);
    }
  } else {
    for (int v = tid; v < BM * (KD / 16); v += 128) {
      const int r = v >> 3, c = v & 7;
      const uint4 q = *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * KD + 16 * c);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
      int x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = (int)(w[i >> 2] << (24 - 8 * (i & 3))) >> 24;  // sign-extended byte
      store_a16(a_tile, r, 16 * c, x);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  fence_proxy_async();  // the widened A tile and B, written by this proxy, to wgmma's
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks)
    wgmma_bf16_bt<BN>(acc, desc(a_s + (ks >> 2) * A_BLOCK + 32 * (ks & 3)), desc_b(b_s + ks * 2048), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);

  const int lane = tid & 31;
  const int r = m0 + (tid >> 5) * 16 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float* row = out + (size_t)r * N + c0 + 8 * j;
    *reinterpret_cast<float2*>(row) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(row + (size_t)8 * N) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace

// a: int8 [M, K] holding [-8, 7] (packed = 0) or uint8 [M / 2, K] of nibble
// pairs (packed = 1); b: bf16 [K, N]; out: fp32 [M, N]; all row-major on the
// device, a and b 16-byte aligned, out 8-byte aligned. Takes M a multiple
// of 64, N a multiple of 128 and K = 128. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int int4_probe_launch(const void* a, const void* b, float* out, int m, int n, int k, int packed,
                                 void* stream) {
  if (m < BM || n < BN || m % BM || n % BN || k != KD) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) & 15 || reinterpret_cast<size_t>(out) & 7)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid(m / BM, n / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* a8 = static_cast<const unsigned char*>(a);
  const __nv_bfloat16* b16 = static_cast<const __nv_bfloat16*>(b);
  if (packed)
    int4_probe_kernel<true><<<grid, 128, 0, st>>>(a8, b16, out, n);
  else
    int4_probe_kernel<false><<<grid, 128, 0, st>>>(a8, b16, out, n);
  return (int)cudaGetLastError();
}
