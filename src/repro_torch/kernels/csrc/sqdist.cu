// Pairwise squared distances for Hopper (sm_90a):
//   out_ij = max(|a_i|^2 + |b_j|^2 - 2 a_i . b_j, 0)     (n, m) f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/sqdist.py: sqdist, which
// CRAIG reaches through greedy.pairwise_sim's dist_fn to build a resident
// similarity.
//
// What bounds it on an H100: 2 n m d FLOPs of dot products against n m f32
// written.  At n = m = 45 000, d = 65 that is 263 GFLOP (3.9 ms at the
// CUDA cores' 67 TFLOP/s) and 8.1 GB written (2.4 ms at 3.35 TB/s): the f32
// rate bounds it.
//
// Design.  One block per (128, 64) output tile: dot_tile.cuh accumulates the
// products in f32 with FFMA (no TF32: the similarity feeds gain sums that
// the lazy greedy certifies at a relative margin of 1e-6), and the epilogue
// adds the squared norms and clamps at 0, as the TPU kernel does on its last
// contraction chunk.  bf16 inputs are widened to f32 on load, as the TPU
// kernel casts its tiles.  The squared norms come in from the caller, as
// the TPU kernel's do.
#include "common.cuh"
#include "dot_tile.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sqdist_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ an, const float* __restrict__ bn,
              int64_t n, int64_t m, int64_t d, float* __restrict__ out) {
  __shared__ DotSmem sm;
  const int tr = threadIdx.x / kGroupsJ;
  const int tc = threadIdx.x % kGroupsJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTileI;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTileJ;
  float acc[kMicroI][kMicroJ];
  dot_tile<T>(a, n, b, m, d, i0, j0, sm, acc);
  float bj[kMicroJ];
#pragma unroll
  for (int c = 0; c < kMicroJ; ++c) {
    const int64_t j = j0 + tc * kMicroJ + c;
    bj[c] = j < m ? bn[j] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kMicroI; ++r) {
    const int64_t i = i0 + tr * kMicroI + r;
    if (i >= n) break;
    const float ai = an[i];
    float* row = out + i * m;
#pragma unroll
    for (int c = 0; c < kMicroJ; ++c) {
      const int64_t j = j0 + tc * kMicroJ + c;
      if (j < m) row[j] = fmaxf(ai + bj[c] - 2.f * acc[r][c], 0.f);
    }
  }
}

template <typename T>
void launch_sqdist(const void* a, const void* b, const float* an,
                   const float* bn, int64_t n, int64_t m, int64_t d,
                   float* out, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kTileJ - 1) / kTileJ),
                  static_cast<unsigned>((n + kTileI - 1) / kTileI));
  sqdist_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), an, bn, n, m, d,
      out);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// a (n, d), b (m, d) row-major, both float32 (dtype 0) or both bfloat16
// (dtype 1); an (n,), bn (m,) f32 squared row norms; out (n, m) f32; all
// on the device.  Returns cudaGetLastError() after the launch.
int rt_sqdist(int device, const void* a, const void* b, int dtype,
              const float* an, const float* bn, int64_t n, int64_t m,
              int64_t d, float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_sqdist<__nv_bfloat16>(a, b, an, bn, n, m, d, out, s);
  else
    launch_sqdist<float>(a, b, an, bn, n, m, d, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
