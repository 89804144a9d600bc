// Interval-bound scan of the streaming OMP certificate for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/corr.py: bound_max.
// Over the compressed chunk cache (bf16 rows with f32 sidecars) it forms,
// for every masked row, the upper bound
//     u_i = s_i + (e_i + acc * ||g_i||) * ||r||,   s_i = g_i . r  (abs opt.)
// and returns max u, its lowest index, and the count of masked rows with
// u >= thresh.  u is never written to device memory.
//
// What bounds it on an H100: one multiply-add per element read, so device
// memory (the rows plus 9 bytes a row of sidecars and mask, at 3.35 TB/s);
// at the streaming path's shapes (65 536 rows of 10 or 65 bf16) that is
// 1.9 or 9.1 MB, 0.6 or 2.7 us, below the cost of a launch.  The design is
// the simple one: one thread a row (rows of 20 or 130 bytes are not 16-byte
// aligned, and a warp a row would leave most lanes idle at d = 10), f32
// accumulation in column order, the residual read through the read-only
// cache.  ||r|| is computed by every block in one fixed order, so all
// blocks use the same value and no pre-pass or host sync is needed.  The
// TPU kernel folded (max, index, count) in SMEM across a sequential grid;
// blocks here run in parallel, so the (u, index) pair is folded through the
// packed 64-bit key of common.cuh with one atomicMax a block (the lowest
// index wins a tie, an all-masked input decodes to (0, -inf)), and the
// count with one integer atomicAdd a block.  thresh is read from device
// memory, so a caller that holds it on the device never syncs for it.
#include "common.cuh"

namespace repro_torch {
namespace {

// ||r|| by one block in a fixed order: every block gets the same bits.
__device__ __forceinline__ float block_norm(const float* __restrict__ r,
                                            int64_t d, float* part) {
  float acc = 0.f;
  for (int64_t j = threadIdx.x; j < d; j += kThreads)
    acc = fmaf(r[j], r[j], acc);
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kWarpsPerBlock; ++q) s += part[q];
  return sqrtf(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bound_max_kernel(const T* __restrict__ rows, const float* __restrict__ norms,
                 const float* __restrict__ errn, const float* __restrict__ r,
                 float acc, const float* __restrict__ thresh,
                 const uint8_t* __restrict__ mask, int64_t n, int64_t d,
                 int absolute, unsigned long long* __restrict__ best,
                 int* __restrict__ count) {
  __shared__ float part[kWarpsPerBlock];
  __shared__ unsigned long long warp_keys[kWarpsPerBlock];
  __shared__ int warp_cnt[kWarpsPerBlock];
  const float rnorm = block_norm(r, d, part);
  const float th = *thresh;
  unsigned long long key = 0ull;
  int cnt = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    if (!mask[i]) continue;
    const T* row = rows + i * d;
    float s = 0.f;
    for (int64_t j = 0; j < d; ++j) s = fmaf(to_f32(row[j]), __ldg(r + j), s);
    if (absolute) s = fabsf(s);
    const float u = s + (errn[i] + acc * norms[i]) * rnorm;
    const unsigned long long k = pack_key(u, i);
    key = k > key ? k : key;
    cnt += u >= th;
  }
  key = warp_max_key(key);
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  const int wib = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_keys[wib] = key;
    warp_cnt[wib] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = warp_keys[0];
    int c = warp_cnt[0];
#pragma unroll
    for (int q = 1; q < kWarpsPerBlock; ++q) {
      m = warp_keys[q] > m ? warp_keys[q] : m;
      c += warp_cnt[q];
    }
    if (m != 0ull) atomicMax(best, m);
    if (c != 0) atomicAdd(count, c);
  }
}

template <typename T>
void launch_bound_max(const void* rows, const float* norms, const float* errn,
                      const float* r, float acc, const float* thresh,
                      const uint8_t* mask, int64_t n, int64_t d, int absolute,
                      unsigned long long* best, int* count, cudaStream_t s) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  bound_max_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(rows), norms, errn, r, acc, thresh, mask, n, d,
      absolute, best, count);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 rows.  thresh: one float32 on the
// device.  best: one 8-byte scratch word on the device.  idx/val/count:
// one int32, one float32 and one int32 on the device.  Returns
// cudaGetLastError() after the launches.
int rt_bound_max(int device, const void* rows, int dtype, const float* norms,
                 const float* errn, const float* r, float acc,
                 const float* thresh, const uint8_t* mask, int64_t n,
                 int64_t d, int absolute, void* best, int* idx, float* val,
                 int* count, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      argmax_fold(best, idx, val, s, [&](unsigned long long* b) {
    if (dtype == 1)
      launch_bound_max<__nv_bfloat16>(rows, norms, errn, r, acc, thresh, mask,
                                      n, d, absolute, b, count, s);
    else
      launch_bound_max<float>(rows, norms, errn, r, acc, thresh, mask, n, d,
                              absolute, b, count, s);
  }));
}

}  // extern "C"
