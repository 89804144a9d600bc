// A (TILE_I x TILE_J) tile of row dot products A_i . B_j, f32 FFMA on the
// CUDA cores, shared by the on-the-fly facility-location scan (fl_gain.cu)
// and the pairwise squared distances (sqdist.cu).
//
// 256 threads as 16 x 16: thread (tr, tc) owns the 8 x 4 micro-tile of rows
// i0 + 8 tr + r and columns j0 + 4 tc + c.  The contraction walks d in
// chunks of TILE_D: both operand tiles are staged in shared memory k-major
// (A and B transposed), so the inner loop reads the thread's 8 A values and
// 4 B values as three 16-byte loads and issues 32 FFMAs.  Rows and
// contraction columns past the edge load as 0, so a ragged tile computes
// exactly what the in-bounds part needs; callers skip rows and columns past
// the edge in their epilogues.  Every element's dot product is summed over
// k in increasing order with one fmaf per term, so the result for a given
// (i, j) does not depend on where the tile boundaries fall.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kTileI = 128;
constexpr int kTileJ = 64;
constexpr int kTileD = 16;
constexpr int kMicroI = 8;
constexpr int kMicroJ = 4;
constexpr int kGroupsI = kTileI / kMicroI;  // 16
constexpr int kGroupsJ = kTileJ / kMicroJ;  // 16
static_assert(kGroupsI * kGroupsJ == kThreads, "one micro-tile a thread");

struct DotSmem {
  // +4 keeps each k-row 16-byte aligned and halves store bank conflicts.
  __align__(16) float a[kTileD][kTileI + 4];
  __align__(16) float b[kTileD][kTileJ + 4];
};

template <typename T>
__device__ __forceinline__ void dot_tile(
    const T* __restrict__ A, int64_t na, const T* __restrict__ B, int64_t nb,
    int64_t d, int64_t i0, int64_t j0, DotSmem& sm,
    float acc[kMicroI][kMicroJ]) {
  const int t = threadIdx.x;
  const int tr = t / kGroupsJ;
  const int tc = t % kGroupsJ;
#pragma unroll
  for (int r = 0; r < kMicroI; ++r)
#pragma unroll
    for (int c = 0; c < kMicroJ; ++c) acc[r][c] = 0.f;
  for (int64_t k0 = 0; k0 < d; k0 += kTileD) {
    // Thread t loads element (row e / TILE_D, col e % TILE_D) of the
    // chunk, e = t + 256 q: 16 neighbouring threads read one row's 16
    // contiguous values.
#pragma unroll
    for (int q = 0; q < kTileI * kTileD / kThreads; ++q) {
      const int e = t + kThreads * q;
      const int row = e / kTileD;
      const int kk = e % kTileD;
      const int64_t i = i0 + row;
      const int64_t k = k0 + kk;
      sm.a[kk][row] = (i < na && k < d) ? to_f32(A[i * d + k]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kTileJ * kTileD / kThreads; ++q) {
      const int e = t + kThreads * q;
      const int row = e / kTileD;
      const int kk = e % kTileD;
      const int64_t j = j0 + row;
      const int64_t k = k0 + kk;
      sm.b[kk][row] = (j < nb && k < d) ? to_f32(B[j * d + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileD; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.a[kk][tr * kMicroI]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.a[kk][tr * kMicroI + 4]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&sm.b[kk][tc * kMicroJ]);
      const float av[kMicroI] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
      const float bw[kMicroJ] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < kMicroI; ++r)
#pragma unroll
        for (int c = 0; c < kMicroJ; ++c)
          acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
    }
    __syncthreads();
  }
}

}  // namespace repro_torch
