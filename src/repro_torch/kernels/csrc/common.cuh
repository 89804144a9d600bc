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

// One row of a row-major matrix dotted with an f32 vector by one warp, f32
// accumulation.  With VEC each lane moves 16 bytes per load (4 f32 or
// 8 bf16); the caller guarantees 16-byte alignment of every row.  Every
// lane returns the same sum (the xor butterfly adds the same pairs on all
// lanes), and every row takes the same path, so equal rows give equal
// results bit for bit.
template <typename T, bool VEC>
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
      const uint4 raw = __ldg(rv + j);
      const T* e = reinterpret_cast<const T*>(&raw);
      const float* vv = v + j * V;
#pragma unroll
      for (int q = 0; q < V; ++q) acc = fmaf(to_f32(e[q]), __ldg(vv + q), acc);
    }
    tail = nv * V;
  }
  for (int64_t j = tail + lane; j < d; j += 32)
    acc = fmaf(to_f32(row[j]), __ldg(v + j), acc);
  return warp_sum(acc);
}

inline int64_t blocks_for_rows(int64_t n) {
  const int64_t b = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace repro_torch
