// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
// Grid cap for the grid-stride row loops: 132 SMs x 8 resident blocks of
// 256 threads, times 4 so the tail of a wave stays short.
constexpr int64_t kMaxBlocks = 132 * 8 * 4;
// A block's most shared memory on sm_90: 227 KB.
constexpr int64_t kMaxSmem = 232448;

__host__ __device__ constexpr int64_t align128(int64_t x) {
  return (x + 127) & ~int64_t{127};
}

// Lets Kernel take up to `limit` bytes of dynamic shared memory on
// `device` (kMaxSmem less the kernel's static shared memory): raised once
// a device, on the first launch that needs more than the default 48 KB.
template <auto Kernel>
cudaError_t allow_smem(int device, int64_t smem, int64_t limit = kMaxSmem) {
  static int64_t allowed[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && allowed[device] < limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(limit));
    if (e != cudaSuccess) return e;
    allowed[device] = limit;
  }
  return cudaSuccess;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// A read-only load: through the non-coherent path from device memory, a
// plain load from shared memory (SHARED).
template <bool SHARED, typename P>
__device__ __forceinline__ P load_ro(const P* p) {
  if constexpr (SHARED) return *p;
  else return __ldg(p);
}

// One row of a row-major matrix dotted with an f32 vector by one warp, f32
// accumulation.  With VEC each lane moves 16 bytes per load (4 f32 or
// 8 bf16); the caller guarantees 16-byte alignment of every row.  Every
// lane returns the same sum (the xor butterfly adds the same pairs on all
// lanes), and every row takes the same path, so equal rows give equal
// results bit for bit.  SHARED: the row and the vector lie in shared
// memory (corr's wide route); the order is the same.
template <typename T, bool VEC, bool SHARED = false>
__device__ __forceinline__ float row_dot(const T* __restrict__ row,
                                         const float* __restrict__ v,
                                         int64_t d, int lane) {
  float acc = 0.f;
  int64_t tail = 0;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int64_t nv = d / V;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int64_t j = lane; j < nv; j += 32) {
      const uint4 raw = load_ro<SHARED>(rv + j);
      const T* e = reinterpret_cast<const T*>(&raw);
      const float* vv = v + j * V;
#pragma unroll
      for (int q = 0; q < V; ++q)
        acc = fmaf(to_f32(e[q]), load_ro<SHARED>(vv + q), acc);
    }
    tail = nv * V;
  }
  for (int64_t j = tail + lane; j < d; j += 32)
    acc = fmaf(to_f32(row[j]), load_ro<SHARED>(v + j), acc);
  return warp_sum(acc);
}

// Masked argmax across parallel blocks.  A candidate's (score, index) packs
// into one 64-bit key: order-preserving float bits (with -0.0 folded onto
// +0.0, so equal scores compare equal) over the bitwise-inverted index.
// The max key is the highest score and, among equal scores, the lowest
// index, so one atomicMax per block folds the blocks in any order and
// keeps the reference's tie rule.  0 is below every key (the key of -inf
// is 0x007fffff'xxxxxxxx), so a scratch word memset to 0 starts the fold,
// and an all-masked input (every score -inf) decodes to (0, -inf).
__device__ __forceinline__ unsigned long long pack_key(float s, int64_t i) {
  if (s == 0.f) s = 0.f;
  unsigned int u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(~static_cast<unsigned int>(i));
}

__device__ __forceinline__ unsigned long long warp_max_key(
    unsigned long long k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o > k ? o : k;
  }
  return k;
}

namespace {

// One thread decodes the folded key into (index, value).  Internal
// linkage: every source that includes this header has its own copy.
__global__ void argmax_decode_kernel(
    const unsigned long long* __restrict__ best, int* __restrict__ idx,
    float* __restrict__ val) {
  const unsigned long long k = *best;
  if (k == 0ull) {  // no rows at all
    *idx = 0;
    *val = -INFINITY;
    return;
  }
  unsigned int u = static_cast<unsigned int>(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  *idx = static_cast<int>(~static_cast<unsigned int>(k & 0xffffffffull));
  *val = __uint_as_float(u);
}

}  // namespace

inline int64_t blocks_for_rows(int64_t n) {
  const int64_t b = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// Start and finish a masked argmax fold on stream s: zero the key word,
// run `launch` (which folds keys into it), decode into idx/val.
template <typename Launch>
cudaError_t argmax_fold(void* best, int* idx, float* val, cudaStream_t s,
                        Launch launch) {
  auto* b = static_cast<unsigned long long*>(best);
  cudaError_t e = cudaMemsetAsync(b, 0, sizeof(unsigned long long), s);
  if (e != cudaSuccess) return e;
  launch(b);
  argmax_decode_kernel<<<1, 1, 0, s>>>(b, idx, val);
  return cudaGetLastError();
}

}  // namespace repro_torch
