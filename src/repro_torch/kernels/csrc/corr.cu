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
//
// corr_argmax is one device operation a call: the key word and a completion
// counter live in a workspace the wrapper keeps per (device, stream), zero
// between calls; the last block to finish (the counter behind
// __threadfence) decodes the key into idx / val and returns both words to
// 0.  This file is the warp route.  The wrapper's plan (kernels/corr.py:
// corr_argmax_plan) sends a pool of width <= 96 and at least
// ARGMAX_MIN_ROWS rows to the row tiles of corr_batched.cu at B = 1
// instead (one thread a row replaying row_dot's lane order, rows by bulk
// copy), which give the same bits.
//
// corr launches by its own plan (kernels/corr.py: corr_plan), one device
// operation a call on each of three routes that give the same bits, each
// row's score a function of the row, r, d, the dtype and row_dot's lane
// order alone (not of n, the tile, the grid or the route), so the
// streaming engine, the in-memory solver and the batched kernels agree:
//   warps (corr_kernel below): one warp a row in a grid-stride loop; the
//     bit oracle, and the route of small pools and of what the others do
//     not take.  Each lane walks its chain of row_dot with a few loads in
//     flight, so a pool of few rows waits on memory latency: at the LM's
//     (16, 3 584) 16 warps on 132 SMs, each lane 28 16-byte loads.
//   rows (corr_batched.cu's row tiles at B = 1, f32 or bf16): pools of
//     width <= 96 from CORR_MIN_ROWS rows.  At d = 65 a warp a row leaves
//     most lanes idle on a row's third pass and pays a butterfly a row;
//     a thread a row, tiles by bulk copy, replays the lanes serially.
//   wide (corr_wide_kernel below): rows of more than 1 KB when they are
//     too few to fill the card (up to WIDE_MAX_ROWS).  A block of W warps,
//     one row each (W consecutive rows, one contiguous span), has thread 0
//     bring the rows and r into shared memory by two bulk copies on one
//     mbarrier (BulkSpan: any alignment); every lane then walks
//     row_dot's exact chain out of shared memory.  The row's bytes are all
//     in flight at once, so a block pays one round trip to device memory
//     where the warp route pays one a few loads.  Registers loaded ahead
//     would do the same for the row, but not for r (28 + 28 16-byte
//     loads a lane at (16, 3 584) f32, past the register file a thread
//     may hold), and r would then come through L1 at a round trip a
//     chunk of the chain; the bulk copies cost no registers, handle any
//     alignment of either operand, and read r once a block.
#include <climits>

#include "common.cuh"
#include "mbarrier.cuh"

namespace repro_torch {
namespace {

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

constexpr int kWideMaxWarps = 8;  // kWarpsPerBlock: the launch bounds

// Shared memory of a wide-route block of `warps` rows of d elements of
// `itemsize` bytes, in bytes from the dynamic base (kernels/corr.py:
// wide_smem mirrors the total for the plan's fit decision):
//   [0, 128)  the mbarrier;
//   v         r: d floats, and 16 bytes for its offset from a 16-byte
//             boundary;
//   rows      the block's rows, one span, and 16 bytes for its offset.
struct WideLayout {
  int64_t v, rows, total;
  __host__ __device__ WideLayout(int64_t d, int64_t itemsize,
                                 int64_t warps) {
    v = 128;
    rows = align128(v + 4 * d + 16);
    total = rows + align128(warps * d * itemsize + 16);
  }
};

// Block b scores rows W b .. W b + W - 1, warp w row W b + w.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
corr_wide_kernel(const T* __restrict__ g, const float* __restrict__ r,
                 float* __restrict__ out, int64_t n, int64_t d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = static_cast<int>(blockDim.x >> 5);
  const WideLayout lay(d, sizeof(T), warps);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * warps;
  const int64_t rows = n - i0 < warps ? n - i0 : warps;
  const uint32_t full = smem_u32(smem);
  const BulkSpan<float> vs(r, d, smem + lay.v);
  const BulkSpan<T> gs(g + i0 * d, rows * d, smem + lay.rows);
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // The plain head and tail stores reach the readers through the
    // barrier's arrival.
    vs.copy_ends();
    gs.copy_ends();
    mbar_expect_tx(full, vs.bulk_bytes() + gs.bulk_bytes());
    vs.bulk(full);
    gs.bulk(full);
  }
  __syncthreads();
  // Warp 0 always has a row, so the block outlives its copies.
  const int w = static_cast<int>(threadIdx.x >> 5);
  if (w >= rows) return;
  mbar_wait(full, 0);
  const int lane = threadIdx.x & 31;
  const float s = row_dot<T, VEC, true>(
      reinterpret_cast<const T*>(gs.dst) + w * d,
      reinterpret_cast<const float*>(vs.dst), d, lane);
  if (lane == 0) out[i0 + w] = s;
}

// The workspace's completion counter: a 128-byte line past the key word
// (kernels/corr.py: KEY_STRIDE, the batched argmax's layout at B = 1).
constexpr int kArgmaxDone = 16;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
corr_argmax_kernel(const float* __restrict__ c, const float* __restrict__ w,
                   const float* __restrict__ base,
                   const uint8_t* __restrict__ mask, int64_t n, int64_t p,
                   int absolute, unsigned long long* __restrict__ ws,
                   int* __restrict__ idx, float* __restrict__ val) {
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
  if (threadIdx.x != 0) return;
  unsigned long long m = warp_keys[0];
#pragma unroll
  for (int q = 1; q < kWarpsPerBlock; ++q)
    m = warp_keys[q] > m ? warp_keys[q] : m;
  if (m != 0ull) atomicMax(ws, m);
  __threadfence();
  unsigned int* done = reinterpret_cast<unsigned int*>(ws + kArgmaxDone);
  if (atomicAdd(done, 1u) != gridDim.x - 1) return;
  // The last block: every block's key is in.  Decode it (argmax_fold's
  // decode) and return the workspace to 0 for the next call.
  __threadfence();
  const unsigned long long k = atomicExch(ws, 0ull);
  if (k == 0ull) {  // no rows at all
    *idx = 0;
    *val = -INFINITY;
  } else {
    unsigned int u = static_cast<unsigned int>(k >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    *idx = static_cast<int>(~static_cast<unsigned int>(k & 0xffffffffull));
    *val = __uint_as_float(u);
  }
  atomicExch(done, 0u);
}

template <typename T, bool VEC>
void launch_corr(const void* g, const float* r, float* out, int64_t n,
                 int64_t d, cudaStream_t s) {
  corr_kernel<T, VEC><<<blocks_for_rows(n), kThreads, 0, s>>>(
      static_cast<const T*>(g), r, out, n, d);
}

template <typename T, bool VEC>
cudaError_t launch_corr_wide(const void* g, const float* r, float* out,
                             int64_t n, int64_t d, int warps, int64_t grid,
                             int64_t smem, int device, cudaStream_t s) {
  const cudaError_t e = allow_smem<corr_wide_kernel<T, VEC>>(device, smem);
  if (e != cudaSuccess) return e;
  corr_wide_kernel<T, VEC>
      <<<static_cast<unsigned int>(grid), warps * 32,
         static_cast<size_t>(smem), s>>>(static_cast<const T*>(g), r, out, n,
                                          d);
  return cudaGetLastError();
}

template <bool VEC>
void launch_corr_argmax(const float* c, const float* w, const float* base,
                        const uint8_t* mask, int64_t n, int64_t p,
                        int absolute, unsigned long long* ws, int* idx,
                        float* val, cudaStream_t s) {
  corr_argmax_kernel<VEC><<<blocks_for_rows(n), kThreads, 0, s>>>(
      c, w, base, mask, n, p, absolute, ws, idx, val);
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

// corr's wide route: a block of `warps` (1, 2, 4 or 8) warps a span of as
// many rows, `grid` = ceil(n / warps) blocks; dtype and vec as rt_corr's.
// Refused where the layout does not fit a block's shared memory.
int rt_corr_wide(int device, const void* g, int dtype, const float* r,
                 float* out, int64_t n, int64_t d, int vec, int warps,
                 int64_t grid, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t itemsize = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || n < 1 || d < 1 ||
      (warps != 1 && warps != 2 && warps != 4 && warps != kWideMaxWarps) ||
      grid != (n + warps - 1) / warps || grid > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = WideLayout(d, itemsize, warps).total;
  if (smem > kMaxSmem ||
      (vec && (reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
               d % (16 / itemsize) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    e = vec ? launch_corr_wide<__nv_bfloat16, true>(g, r, out, n, d, warps,
                                                    grid, smem, device, s)
            : launch_corr_wide<__nv_bfloat16, false>(g, r, out, n, d, warps,
                                                     grid, smem, device, s);
  else
    e = vec ? launch_corr_wide<float, true>(g, r, out, n, d, warps, grid,
                                            smem, device, s)
            : launch_corr_wide<float, false>(g, r, out, n, d, warps, grid,
                                             smem, device, s);
  return static_cast<int>(e);
}

// f32 only.  ws: 17 8-byte words on the device, zero before the call and
// zero after it (the key at word 0, the completion counter at word 16).
// idx/val: one int32 and one float32 on the device.  One launch.
int rt_corr_argmax(int device, const float* c, const float* w,
                   const float* base, const uint8_t* mask, int64_t n,
                   int64_t p, int absolute, int vec, void* ws, int* idx,
                   float* val, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(ws);
  if (vec) launch_corr_argmax<true>(c, w, base, mask, n, p, absolute, keys,
                                    idx, val, s);
  else launch_corr_argmax<false>(c, w, base, mask, n, p, absolute, keys,
                                 idx, val, s);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
