// The exact head-input gradient of an LM head, for Hopper (sm_90a):
//   out = (softmax(Z) - onehot(Y)) @ W^T        Z (n, V), W (d_h, V) -> (n, d_h)
// with no (n, V) residual in device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lastlayer_grad.py:
// hidden_grad_fused, the two-phase flash-style head gradient of an LM
// candidate pool, for the inputs the tensor-core kernel (hidden_grad_tc.cu)
// does not take: an f32 head, or rows TMA cannot address (the wrapper's
// routing rule).
//
// What bounds it on an H100: 2 n V d_h FLOPs against one read of Z and W
// and one write of the output.  On the LM path (n = 512 tokens, V = 256 000,
// d_h = 2 048, bf16 Z and W) that is 5.4e11 FLOPs, 8.0 ms at the CUDA
// cores' 67 TFLOP/s, against 1.3 GB moved, 0.39 ms at 3.35 TB/s: the f32
// rate bounds it.
//
// Design: two passes, both f32.
//   1. hidden_grad_stats_kernel (hidden_grad.cuh): one block of 256
//      threads per row walks V with an online softmax (running max and
//      denominator), then folds its threads' pairs in a fixed tree:
//      (m_i, l_i) per row.
//   2. hidden_grad_kernel: one block per (128-row, 64-column) output tile
//      and slice of V walks its slice in chunks of 32.  Its prologue forms
//      p - onehot = exp(z - m_i) * (1 / l_i) - [v == y_i] from the Z chunk
//      and the row statistics straight into shared memory (the one-hot
//      inside the tile, as the TPU kernel and the plain version subtract
//      it), W's chunk is widened to f32 on the way in, and 256 threads,
//      each with an 8 x 4 micro-tile, run the FFMA product as dot_tile.cuh
//      does.  The next chunk's loads are issued into registers before the
//      current chunk's product, so they are in flight while it runs.
//   3. When the output tiles alone would leave SMs idle (the LM path has
//      128 of them for 132 SMs that hold two blocks each), V is split into
//      `splits` slices, one block per tile and slice, each writing its own
//      partial tile; hidden_grad_reduce_kernel (hidden_grad.cuh) adds the
//      partials in slice order.
// Every output element is summed over v in increasing order with one fmaf
// a term within a slice and the slices in a fixed order, and the row
// statistics in one fixed order: no float atomics, so two calls give the
// same bits.  Columns of V past the edge act as the TPU
// kernel's padding (logits -1e30, zero weight rows): they add nothing.
// W is read through its two strides, so both embed^T (a tied head: W^T is
// the contiguous (V, d_h) embedding) and a contiguous (d_h, V) head are
// read in place, each with neighbouring threads on neighbouring addresses.
// Offsets are 64-bit (n V reaches 1.7e10 at the sizes the TPU kernel was
// written for).
#include "hidden_grad.cuh"

namespace repro_torch {
namespace {

constexpr int kHgRows = 128;   // output rows per block
constexpr int kHgCols = 64;    // output columns per block
constexpr int kHgDepth = 32;   // vocabulary entries per chunk
constexpr int kHgMicroI = 8;
constexpr int kHgMicroJ = 4;
constexpr int kHgGroupsJ = kHgCols / kHgMicroJ;             // 16
constexpr int kZPerThread = kHgRows * kHgDepth / kThreads;  // 16
constexpr int kWPerThread = kHgCols * kHgDepth / kThreads;  // 8
static_assert((kHgRows / kHgMicroI) * kHgGroupsJ == kThreads,
              "one micro-tile a thread");
static_assert(kHgDepth == 32, "one warp reads one row's chunk");

struct HgSmem {
  // +4 keeps each k-row 16-byte aligned and halves store bank conflicts.
  __align__(16) float a[kHgDepth][kHgRows + 4];  // p - onehot, k-major
  __align__(16) float b[kHgDepth][kHgCols + 4];  // W, k-major
  float m[kHgRows];
  float il[kHgRows];   // 1 / l_i
  int64_t y[kHgRows];
};

// Block (x, y, z) computes output tile (y, x) over the V slice
// [z slice, (z + 1) slice) into out + z n d_h.
template <typename TZ, typename TW, typename L>
__global__ void __launch_bounds__(kThreads, 2)
hidden_grad_kernel(const TZ* __restrict__ z, const L* __restrict__ labels,
                   const TW* __restrict__ w, int64_t sh, int64_t sv,
                   const float2* __restrict__ stats, int64_t n,
                   int64_t v_len, int64_t dh, int64_t slice,
                   float* __restrict__ out) {
  __shared__ HgSmem sm;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tr = t / kHgGroupsJ;
  const int tc = t % kHgGroupsJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kHgRows;
  const int64_t h0 = static_cast<int64_t>(blockIdx.x) * kHgCols;
  // Neighbouring threads on neighbouring addresses of W: along h for a
  // contiguous W^T (a tied head), along v for a contiguous (d_h, V) W.
  const bool h_fast = sh == 1;
  const int64_t v_begin = static_cast<int64_t>(blockIdx.z) * slice;
  const int64_t v_end = v_begin + slice < v_len ? v_begin + slice : v_len;
  out += static_cast<int64_t>(blockIdx.z) * n * dh;

  for (int r = t; r < kHgRows; r += kThreads) {
    const int64_t i = i0 + r;
    if (i < n) {
      const float2 st = stats[i];
      sm.m[r] = st.x;
      sm.il[r] = 1.f / st.y;
      sm.y[r] = static_cast<int64_t>(labels[i]);
    } else {  // a row past n: z reads as -inf, so p = 0 and no one-hot
      sm.m[r] = 0.f;
      sm.il[r] = 1.f;
      sm.y[r] = -1;
    }
  }

  // Chunk k0's loads into registers: Z element (row warp + 8 q, v k0 +
  // lane), so one warp reads 32 consecutive logits of a row; W element
  // (kk, col) of the chunk by the layout's fast axis.
  float zr[kZPerThread];
  float wr[kWPerThread];
  auto load = [&](int64_t k0) {
    const int64_t v = k0 + lane;
#pragma unroll
    for (int q = 0; q < kZPerThread; ++q) {
      const int64_t i = i0 + warp + kWarpsPerBlock * q;
      zr[q] = (i < n && v < v_end) ? to_f32(z[i * v_len + v]) : -INFINITY;
    }
#pragma unroll
    for (int q = 0; q < kWPerThread; ++q) {
      const int e = t + kThreads * q;
      const int kk = h_fast ? e / kHgCols : e % kHgDepth;
      const int col = h_fast ? e % kHgCols : e / kHgDepth;
      const int64_t vv = k0 + kk;
      const int64_t h = h0 + col;
      wr[q] = (vv < v_end && h < dh) ? to_f32(w[h * sh + vv * sv]) : 0.f;
    }
  };

  float acc[kHgMicroI][kHgMicroJ];
#pragma unroll
  for (int r = 0; r < kHgMicroI; ++r)
#pragma unroll
    for (int c = 0; c < kHgMicroJ; ++c) acc[r][c] = 0.f;

  __syncthreads();
  load(v_begin);
  for (int64_t k0 = v_begin; k0 < v_end; k0 += kHgDepth) {
    const int64_t v = k0 + lane;
#pragma unroll
    for (int q = 0; q < kZPerThread; ++q) {
      const int r = warp + kWarpsPerBlock * q;
      const float p = expf(zr[q] - sm.m[r]) * sm.il[r];
      sm.a[lane][r] = (v < v_end && v == sm.y[r]) ? p - 1.f : p;
    }
#pragma unroll
    for (int q = 0; q < kWPerThread; ++q) {
      const int e = t + kThreads * q;
      const int kk = h_fast ? e / kHgCols : e % kHgDepth;
      const int col = h_fast ? e % kHgCols : e / kHgDepth;
      sm.b[kk][col] = wr[q];
    }
    __syncthreads();
    if (k0 + kHgDepth < v_end) load(k0 + kHgDepth);
#pragma unroll
    for (int kk = 0; kk < kHgDepth; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.a[kk][tr * kHgMicroI]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.a[kk][tr * kHgMicroI + 4]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&sm.b[kk][tc * kHgMicroJ]);
      const float av[kHgMicroI] = {a0.x, a0.y, a0.z, a0.w,
                                   a1.x, a1.y, a1.z, a1.w};
      const float bw[kHgMicroJ] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < kHgMicroI; ++r)
#pragma unroll
        for (int c = 0; c < kHgMicroJ; ++c)
          acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kHgMicroI; ++r) {
    const int64_t i = i0 + tr * kHgMicroI + r;
    if (i >= n) break;
    float* row = out + i * dh;
#pragma unroll
    for (int c = 0; c < kHgMicroJ; ++c) {
      const int64_t h = h0 + tc * kHgMicroJ + c;
      if (h < dh) row[h] = acc[r][c];
    }
  }
}

struct HgArgs {
  const void* z;
  const void* labels;
  const void* w;
  int64_t sh, sv;
  float2* stats;
  int64_t n, v_len, dh, slice;
  int splits;
  float* part;
  float* out;
};

template <typename TZ, typename TW, typename L>
cudaError_t launch_hidden_grad(const HgArgs& a, cudaStream_t s) {
  cudaError_t e =
      launch_hidden_grad_stats<TZ>(a.z, a.n, a.v_len, a.stats, s);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((a.dh + kHgCols - 1) / kHgCols),
                  static_cast<unsigned>((a.n + kHgRows - 1) / kHgRows),
                  static_cast<unsigned>(a.splits));
  float* dst = a.splits > 1 ? a.part : a.out;
  hidden_grad_kernel<TZ, TW, L><<<grid, kThreads, 0, s>>>(
      static_cast<const TZ*>(a.z), static_cast<const L*>(a.labels),
      static_cast<const TW*>(a.w), a.sh, a.sv, a.stats, a.n, a.v_len, a.dh,
      a.slice, dst);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  return launch_hidden_grad_reduce(a.part, a.splits, a.n * a.dh, a.out, s);
}

template <typename TZ, typename TW>
cudaError_t dispatch_labels(int label64, const HgArgs& a, cudaStream_t s) {
  return label64 ? launch_hidden_grad<TZ, TW, int64_t>(a, s)
                 : launch_hidden_grad<TZ, TW, int32_t>(a, s);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// z (n, V) row-major, float32 (z_dtype 0) or bfloat16 (1); labels (n,)
// int32 (label64 0) or int64 (1); w the (d_h, V) head, float32 (w_dtype 0)
// or bfloat16 (1), element (h, v) at w[h * sh + v * sv]; stats an (n, 2)
// f32 scratch; V cut into `splits` slices of `slice` entries (a multiple of
// 32; splits = ceil(V / slice)), part a (splits, n, d_h) f32 scratch when
// splits > 1 (else unused); out (n, d_h) f32.  n >= 1, V >= 1, d_h >= 1,
// all on the device.  Returns the first launch error, or
// cudaGetLastError() after the last launch.
int rt_hidden_grad(int device, const void* z, int z_dtype,
                   const void* labels, int label64, const void* w,
                   int w_dtype, int64_t sh, int64_t sv, float* stats,
                   int64_t n, int64_t v_len, int64_t dh, int64_t slice,
                   int splits, float* part, float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HgArgs a{z, labels, w, sh, sv, reinterpret_cast<float2*>(stats),
                 n, v_len, dh, slice, splits, part, out};
  if (z_dtype == 1 && w_dtype == 1)
    e = dispatch_labels<__nv_bfloat16, __nv_bfloat16>(label64, a, s);
  else if (z_dtype == 1)
    e = dispatch_labels<__nv_bfloat16, float>(label64, a, s);
  else if (w_dtype == 1)
    e = dispatch_labels<float, __nv_bfloat16>(label64, a, s);
  else
    e = dispatch_labels<float, float>(label64, a, s);
  return static_cast<int>(e);
}

}  // extern "C"
