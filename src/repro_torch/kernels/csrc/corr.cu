// OMP scoring kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   rt_corr        <- src/repro/kernels/corr.py: corr         (scores = G @ r)
//   rt_corr_argmax <- src/repro/kernels/corr.py: corr_argmax  (masked argmax
//                     of base - C @ w, optionally abs)
//
// What bounds them on an H100: both are matrix-vector products with one
// multiply-add per element read, so device-memory bandwidth bounds them
// (n*d*4 bytes of G at 3.35 TB/s; the vector is L1/L2-resident).  The design
// reads G once, in 16-byte loads when rows are aligned, one warp per row and
// f32 accumulation.  corr_argmax never writes the (n,) score vector: each
// warp folds its rows into a packed 64-bit key (order-preserving float bits
// over the bitwise-inverted row index), the block reduces the keys of its
// warps, and one atomicMax per block folds the blocks in any order.  The max
// key is the highest score and, among equal scores, the lowest index, so
// the reference's tie rule holds whatever order the blocks finish in.  The
// TPU kernel carried that pair in SMEM across a sequential grid; blocks here
// run in parallel, which is why the pair is packed into one atomic word.
#include "common.cuh"

namespace repro_torch {
namespace {

// Order-preserving map of a float to 32 bits, with -0.0 folded onto +0.0 so
// that equal scores compare equal, packed over the inverted index.
__device__ __forceinline__ unsigned long long pack_key(float s, int64_t i) {
  if (s == 0.f) s = 0.f;
  unsigned int u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned long long>(~static_cast<unsigned int>(i));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
corr_kernel(const T* __restrict__ g, const float* __restrict__ r,
            float* __restrict__ out, int64_t n, int64_t d) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       i < n; i += nwarps) {
    const float s = row_dot<T, VEC>(g + i * d, r, d, lane);
    if (lane == 0) out[i] = s;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
corr_argmax_kernel(const float* __restrict__ c, const float* __restrict__ w,
                   const float* __restrict__ base,
                   const uint8_t* __restrict__ mask, int64_t n, int64_t p,
                   int absolute, unsigned long long* __restrict__ best) {
  __shared__ unsigned long long warp_keys[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  // 0 is below every packed key (the key of -inf is 0x007fffff'xxxxxxxx).
  unsigned long long key = 0ull;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + wib;
       i < n; i += nwarps) {
    float s = base[i] - row_dot<float, VEC>(c + i * p, w, p, lane);
    if (absolute) s = fabsf(s);
    if (!mask[i]) s = -INFINITY;
    const unsigned long long k = pack_key(s, i);
    key = k > key ? k : key;
  }
  if (lane == 0) warp_keys[wib] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = warp_keys[0];
#pragma unroll
    for (int q = 1; q < kWarpsPerBlock; ++q)
      m = warp_keys[q] > m ? warp_keys[q] : m;
    if (m != 0ull) atomicMax(best, m);
  }
}

__global__ void argmax_decode_kernel(const unsigned long long* __restrict__ best,
                                     int* __restrict__ idx,
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

template <typename T, bool VEC>
void launch_corr(const void* g, const float* r, float* out, int64_t n,
                 int64_t d, cudaStream_t s) {
  corr_kernel<T, VEC><<<blocks_for_rows(n), kThreads, 0, s>>>(
      static_cast<const T*>(g), r, out, n, d);
}

template <bool VEC>
void launch_corr_argmax(const float* c, const float* w, const float* base,
                        const uint8_t* mask, int64_t n, int64_t p,
                        int absolute, unsigned long long* best,
                        cudaStream_t s) {
  corr_argmax_kernel<VEC><<<blocks_for_rows(n), kThreads, 0, s>>>(
      c, w, base, mask, n, p, absolute, best);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when every row of the matrix
// starts on a 16-byte boundary and the row length is a multiple of the
// 16-byte vector.  Returns cudaGetLastError() after the launches.
int rt_corr(int device, const void* g, int dtype, const float* r, float* out,
            int64_t n, int64_t d, int vec, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (vec) launch_corr<__nv_bfloat16, true>(g, r, out, n, d, s);
    else launch_corr<__nv_bfloat16, false>(g, r, out, n, d, s);
  } else {
    if (vec) launch_corr<float, true>(g, r, out, n, d, s);
    else launch_corr<float, false>(g, r, out, n, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32 only.  best: one 8-byte scratch word on the device.  idx/val: one
// int32 and one float32 on the device.
int rt_corr_argmax(int device, const float* c, const float* w,
                   const float* base, const uint8_t* mask, int64_t n,
                   int64_t p, int absolute, int vec, void* best, int* idx,
                   float* val, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<unsigned long long*>(best);
  e = cudaMemsetAsync(b, 0, sizeof(unsigned long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vec) launch_corr_argmax<true>(c, w, base, mask, n, p, absolute, b, s);
  else launch_corr_argmax<false>(c, w, base, mask, n, p, absolute, b, s);
  argmax_decode_kernel<<<1, 1, 0, s>>>(b, idx, val);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
