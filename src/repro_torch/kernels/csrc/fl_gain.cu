// Facility-location gain scans for Hopper (sm_90a): the full scan of the
// lazy CRAIG greedy, gain_j = sum_i relu(s_ij - cover_i), and its masked
// argmax.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   rt_fl_gain_argmax     <- src/repro/kernels/fl_gain.py: fl_gain_argmax
//                            (resident (n, n) similarity)
//   rt_fl_gain_argmax_otf <- src/repro/kernels/fl_gain.py: fl_gain_argmax_otf
//                            (s_ij = (l_max - |g_i - g_j|) * row_ok_i built
//                            tile by tile from grads (n, d); the (n, n)
//                            matrix never exists)
//
// What bounds them on an H100.  The resident scan reads n^2 f32 once and
// does one subtract, max and add per element: device-memory bandwidth bounds
// it (8.1 GB at n = 45 000, 2.4 ms at 3.35 TB/s).  The on-the-fly scan does
// 2 n^2 d FLOPs of dot products plus a sqrt per element from an (n, d)
// matrix that stays in L2.  This file's route for it, FFMA tiles on the
// CUDA cores, is bounded by their f32 rate.  It takes the shapes the
// wrapper's plan (kernels/fl_gain.py: fl_gain_otf_plan) does not send to
// the tensor cores (fl_gain_tc.cu: 3xTF32 wgmma fed by TMA, rows of up to
// 104 columns): wider rows, whose tiles do not fit a block's shared memory
// there.
//
// Design.  The TPU kernels carry each column's partial gain in VMEM across
// a sequential grid of row tiles.  Here one block owns a tile of adjacent
// columns and walks every row itself, so each column's sum has one fixed
// order (no float atomics, no partials buffer) and the scan is
// deterministic run to run.  The resident kernel reads 32 columns of a row
// per warp (128 contiguous bytes), 8 warps on rows i = w (mod 8), with
// cover staged in shared memory.  Its sums are compensated (Kahan), warp
// chains and the fold of the 8 warp partials alike: the lazy greedy
// certifies these gains against row sums of the same matrix taken by
// torch at a relative margin of 1e-6, and 8 plain f32 chains of 5 625 terms
// (n = 45 000) drift 1.3e-6 from those on the card.  The compensation
// costs 3 adds a term in a kernel bound by memory.  The on-the-fly kernel computes dot tiles with dot_tile.cuh and
// folds the epilogue (norms, sqrt, l_max, row_ok, cover, relu) straight
// into per-column accumulators; its 16 row-group partials are added in
// group order.  The masked argmax then folds the tile's columns into the
// packed 64-bit key of common.cuh (lowest index on ties, (0, -inf) when
// every column is masked).
#include "common.cuh"
#include "dot_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kColTile = 32;          // resident: columns per block
constexpr int kRowLanes = kWarpsPerBlock;
constexpr int kCoverChunk = 2048;     // resident: cover rows staged at once

// One compensated (Kahan) step: sum += x, with c carrying the rounding
// error.  No multiplies, so no FMA contraction can merge the steps.
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = x - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

__global__ void __launch_bounds__(kThreads)
fl_gain_kernel(const float* __restrict__ sim, const float* __restrict__ cover,
               const uint8_t* __restrict__ mask, int64_t n,
               float* __restrict__ gains,
               unsigned long long* __restrict__ best) {
  __shared__ float cover_s[kCoverChunk];
  __shared__ float part[kRowLanes][kColTile];
  __shared__ float part_c[kRowLanes][kColTile];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kColTile + lane;
  const bool col_in = j < n;
  float acc = 0.f, comp = 0.f;
  for (int64_t c0 = 0; c0 < n; c0 += kCoverChunk) {
    const int len = static_cast<int>(n - c0 < kCoverChunk ? n - c0
                                                          : kCoverChunk);
    __syncthreads();
    for (int q = threadIdx.x; q < len; q += kThreads)
      cover_s[q] = cover[c0 + q];
    __syncthreads();
    if (col_in) {
      const float* col = sim + c0 * n + j;
#pragma unroll 4
      for (int r = w; r < len; r += kRowLanes)
        kahan_add(acc, comp,
                  fmaxf(__ldg(col + static_cast<int64_t>(r) * n) -
                            cover_s[r],
                        0.f));
    }
  }
  part[w][lane] = acc;
  part_c[w][lane] = comp;
  __syncthreads();
  if (w == 0) {
    float g = 0.f, gc = 0.f;
#pragma unroll
    for (int q = 0; q < kRowLanes; ++q) {
      kahan_add(g, gc, part[q][lane]);
      kahan_add(g, gc, -part_c[q][lane]);
    }
    unsigned long long key = 0ull;
    if (col_in) {
      gains[j] = g;
      key = pack_key(mask[j] ? g : -INFINITY, j);
    }
    key = warp_max_key(key);
    if (lane == 0 && key != 0ull) atomicMax(best, key);
  }
}

__global__ void __launch_bounds__(kThreads)
fl_gain_otf_kernel(const float* __restrict__ g, const float* __restrict__ sqn,
                   const float* __restrict__ cover,
                   const uint8_t* __restrict__ row_ok,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ l_max, int64_t n, int64_t d,
                   float* __restrict__ gains,
                   unsigned long long* __restrict__ best) {
  __shared__ DotSmem sm;
  __shared__ float part[kGroupsI][kTileJ];
  const int tr = threadIdx.x / kGroupsJ;
  const int tc = threadIdx.x % kGroupsJ;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTileJ;
  const float lm = *l_max;
  float cn[kMicroJ];
#pragma unroll
  for (int c = 0; c < kMicroJ; ++c) {
    const int64_t j = j0 + tc * kMicroJ + c;
    cn[c] = j < n ? sqn[j] : 0.f;
  }
  float gacc[kMicroJ] = {0.f, 0.f, 0.f, 0.f};
  float acc[kMicroI][kMicroJ];
  for (int64_t i0 = 0; i0 < n; i0 += kTileI) {
    dot_tile<float>(g, n, g, n, d, i0, j0, sm, acc);
#pragma unroll
    for (int r = 0; r < kMicroI; ++r) {
      const int64_t i = i0 + tr * kMicroI + r;
      if (i >= n) break;
      const float rn = sqn[i];
      const float cv = cover[i];
      const float ok = row_ok[i] ? 1.f : 0.f;
#pragma unroll
      for (int c = 0; c < kMicroJ; ++c) {
        const float d2 = rn + cn[c] - 2.f * acc[r][c];
        const float s = (lm - sqrtf(fmaxf(d2, 0.f))) * ok;
        gacc[c] += fmaxf(s - cv, 0.f);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMicroJ; ++c) part[tr][tc * kMicroJ + c] = gacc[c];
  __syncthreads();
  if (threadIdx.x < kTileJ) {
    const int col = threadIdx.x;
    const int64_t j = j0 + col;
    float s = part[0][col];
#pragma unroll
    for (int q = 1; q < kGroupsI; ++q) s += part[q][col];
    unsigned long long key = 0ull;
    if (j < n) {
      gains[j] = s;
      key = pack_key(mask[j] ? s : -INFINITY, j);
    }
    key = warp_max_key(key);
    if ((threadIdx.x & 31) == 0 && key != 0ull) atomicMax(best, key);
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// sim (n, n) f32 row-major, cover (n,) f32, mask (n,) bool.  gains (n,) f32
// out; best: one 8-byte scratch word; idx/val: one int32 and one float32,
// all on the device.  Returns cudaGetLastError() after the launches.
int rt_fl_gain_argmax(int device, const float* sim, const float* cover,
                      const uint8_t* mask, int64_t n, float* gains,
                      void* best, int* idx, float* val, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kColTile - 1) / kColTile;
  return static_cast<int>(
      argmax_fold(best, idx, val, s, [&](unsigned long long* b) {
    fl_gain_kernel<<<blocks, kThreads, 0, s>>>(sim, cover, mask, n, gains,
                                               b);
  }));
}

// grads (n, d) f32 row-major, sqnorms/cover (n,) f32, row_ok/mask (n,)
// bool, l_max one f32, all on the device; outputs as rt_fl_gain_argmax.
int rt_fl_gain_argmax_otf(int device, const float* grads,
                          const float* sqnorms, const float* cover,
                          const uint8_t* row_ok, const uint8_t* mask,
                          const float* l_max, int64_t n, int64_t d,
                          float* gains, void* best, int* idx, float* val,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kTileJ - 1) / kTileJ;
  return static_cast<int>(
      argmax_fold(best, idx, val, s, [&](unsigned long long* b) {
    fl_gain_otf_kernel<<<blocks, kThreads, 0, s>>>(
        grads, sqnorms, cover, row_ok, mask, l_max, n, d, gains, b);
  }));
}

}  // extern "C"
