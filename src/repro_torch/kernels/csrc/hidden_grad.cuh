// The two passes that both head-gradient kernels share (hidden_grad.cu,
// the FFMA kernel, and hidden_grad_tc.cu, the tensor-core kernel): the
// row statistics of Z before the product, and the fold of the V slices'
// partial tiles after it.  Internal linkage: each source that includes
// this header has its own copy.
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace {

// Online-softmax pair (m, l): l = sum exp(x - m).  -inf marks "no term".
struct MaxSum {
  float m, l;
};

__device__ __forceinline__ MaxSum combine(MaxSum a, MaxSum b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f};
  const float la = a.m == -INFINITY ? 0.f : a.l * expf(a.m - m);
  const float lb = b.m == -INFINITY ? 0.f : b.l * expf(b.m - m);
  return {m, la + lb};
}

// 2^x on the special-function unit (2 ulp; results below 2^-126 are 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Fold `k` logits into a thread's running (m, l): the new maximum first,
// then one exp a logit against it.
template <int K>
__device__ __forceinline__ void fold_logits(MaxSum& acc, const float* x) {
  float cm = x[0];
#pragma unroll
  for (int q = 1; q < K; ++q) cm = fmaxf(cm, x[q]);
  if (cm > acc.m) {
    acc.l = acc.m == -INFINITY ? 0.f : acc.l * ex2((acc.m - cm) * kLog2e);
    acc.m = cm;
  }
  if (acc.m == -INFINITY) return;
#pragma unroll
  for (int q = 0; q < K; ++q) acc.l += ex2((x[q] - acc.m) * kLog2e);
}

// One block of 256 threads a row: each thread folds its share of the row
// in a fixed order (16-byte loads where the row is 16-byte aligned, one
// logit at a time otherwise), then the threads' pairs fold in a fixed
// tree.  One read of Z, one exp a logit.
template <typename TZ>
__global__ void __launch_bounds__(kThreads)
hidden_grad_stats_kernel(const TZ* __restrict__ z, int64_t v_len,
                         float2* __restrict__ stats) {
  constexpr int kVec = 16 / sizeof(TZ);
  __shared__ MaxSum part[kWarpsPerBlock];
  const int64_t i = blockIdx.x;
  const TZ* row = z + i * v_len;
  MaxSum acc{-INFINITY, 0.f};
  int64_t tail = 0;
  if (reinterpret_cast<uintptr_t>(row) % 16 == 0) {
    const int64_t nv = v_len / kVec;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < nv; j += kThreads) {
      const uint4 raw = __ldg(rv + j);
      const TZ* e = reinterpret_cast<const TZ*>(&raw);
      float x[kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) x[q] = to_f32(e[q]);
      fold_logits<kVec>(acc, x);
    }
    tail = nv * kVec;
  }
  for (int64_t v = tail + threadIdx.x; v < v_len; v += kThreads) {
    const float x = to_f32(row[v]);
    fold_logits<1>(acc, &x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MaxSum o;
    o.m = __shfl_xor_sync(0xffffffffu, acc.m, off);
    o.l = __shfl_xor_sync(0xffffffffu, acc.l, off);
    acc = combine(acc, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    MaxSum s = part[0];
    for (int w = 1; w < kWarpsPerBlock; ++w) s = combine(s, part[w]);
    stats[i] = make_float2(s.m, s.l);
  }
}

// out[e] = sum over s of part[s total + e], s in increasing order.
__global__ void __launch_bounds__(kThreads)
hidden_grad_reduce_kernel(const float* __restrict__ part, int splits,
                          int64_t total, float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += stride) {
    float acc = part[e];
    for (int k = 1; k < splits; ++k) acc += part[k * total + e];
    out[e] = acc;
  }
}

// The row statistics (m_i, l_i) of z (n, V) into stats (n, 2): one block a
// row, every row folded in one fixed order.
template <typename TZ>
cudaError_t launch_hidden_grad_stats(const void* z, int64_t n, int64_t v_len,
                                     float2* stats, cudaStream_t s) {
  hidden_grad_stats_kernel<TZ><<<static_cast<unsigned>(n), kThreads, 0, s>>>(
      static_cast<const TZ*>(z), v_len, stats);
  return cudaGetLastError();
}

// out (total,) = the sum of the `splits` partials of part, in slice order.
inline cudaError_t launch_hidden_grad_reduce(const float* part, int splits,
                                            int64_t total, float* out,
                                            cudaStream_t s) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  blocks = blocks > kMaxBlocks ? kMaxBlocks : blocks;
  hidden_grad_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      part, splits, total, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch
