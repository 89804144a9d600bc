// Batched OMP scoring kernels for Hopper (sm_90a): B problems, one launch.
//
// Replaces two dispatch functions of the JAX package that reach Pallas TPU
// kernels through a lax.map over the batch:
//   rt_corr_batched        <- src/repro/kernels/ops.py: corr_batched
//                             ((n, d) @ (B, d)^T -> pool-major (n, B) f32)
//   rt_corr_argmax_batched <- src/repro/kernels/ops.py: corr_argmax_batched
//                             (per-problem masked argmax of base - mat @ w,
//                             optionally abs; mat shared (n, p) or
//                             per-problem (B, n, p); base, mask (n, B))
//
// What bounds them on an H100: one multiply-add per element of the pool
// read, so device-memory bandwidth (n*d*4 bytes at 3.35 TB/s).  The TPU
// mapped B launches of the single kernels, each reading the pool; here
// one launch reads each row of a shared pool once for all B problems (a
// chunk of up to 32 problems at a time; B > 32 re-reads the pool, from L2
// at the main path's sizes, once per further chunk).
//
// Design: one warp per row, as rt_corr, in one wave of blocks whose warps
// walk many rows each.  Each lane keeps one accumulator per problem of the
// chunk and walks the row in row_dot's lane order (csrc/common.cuh), so
// every problem's partial sums are those of row_dot.  On the shared pool
// with scalar lanes (d not a multiple of 4, as the main path's 65) a lane
// holds its elements of every problem's vector in registers for the whole
// chunk and loads the next row while it sums the current one, so a row
// costs its own bytes and the multiply-adds.  The 32 partials of each problem are then summed across the
// warp by a transposed butterfly: at each of the xor offsets 16, 8, ...
// a lane hands half of the sums it still holds to its partner and keeps
// the other half, and once a lane holds one sum the plain butterfly
// finishes.  Every addition pairs the same two partial sums as row_dot's
// warp_sum, so column b equals rt_corr(grads, vecs[b]) and problem b's
// (index, value) equals rt_corr_argmax on its slice, bit for bit, at
// 2^m - 1 + (5 - m) shuffles a row for a chunk of 2^m problems instead of
// 5 * 2^m.  After the butterfly lane L holds problem L >> (5 - m).
//
// The argmax never writes the (n, B) scores: each lane folds its problem's
// packed 64-bit keys (pack_key: the highest score, then the lowest row),
// the block folds its warps' keys in shared memory, and one atomicMax per
// (block, problem) folds the blocks into a (B,) key array, which one
// launch decodes.  Base and mask stay pool-major (n, B) as the reference
// lays them out: row i's B entries are contiguous, and the lanes that
// hold a row's problems read them side by side.
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxChunk = 32;

template <int BC>
struct ChunkLog {
  static constexpr int value = BC <= 1 ? 0 : 1 + ChunkLog<BC / 2>::value;
};

// One halving step of the transposed butterfly, then the next: at xor
// offset 16 >> STEP a lane keeps half of the sums it holds and adds its
// partner's, handing over the other half.  The recursion makes every
// register index a constant (a runtime loop here would select registers
// through chains of predicated moves).
template <int BC, int STEP>
__device__ __forceinline__ void fold_step(float (&acc)[BC], int lane) {
  if constexpr (STEP < ChunkLog<BC>::value) {
    constexpr int off = 16 >> STEP;
    constexpr int half = BC >> (STEP + 1);
    const bool low = (lane & off) == 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = low ? acc[half + j] : acc[j];
      const float keep = low ? acc[j] : acc[half + j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    fold_step<BC, STEP + 1>(acc, lane);
  }
}

// Sum each problem's 32 lane partials; returns the sum of problem
// lane >> (5 - log2(BC)).  The pairing of every addition is warp_sum's.
template <int BC>
__device__ __forceinline__ float chunk_sum(float (&acc)[BC], int lane) {
  constexpr int M = ChunkLog<BC>::value;
  fold_step<BC, 0>(acc, lane);
  float x = acc[0];
#pragma unroll
  for (int off = 16 >> M; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lane elements j = lane + 32 t, t < Cached<BC>::value, of every problem's
// vector that a lane keeps in registers for the whole chunk (scalar lanes
// only): all of them up to d = 96 (64 for a chunk of 32), so at the main
// path's d = 65 the multiply-adds read no memory but the row.
template <int BC>
struct Cached {
  static constexpr int value = BC >= 32 ? 2 : 3;
};

template <int BC>
struct VecCache {
  float v[Cached<BC>::value][BC];
};

// The chunk's vectors v_b = v + b * ldv, b < nb, at this lane's cached
// elements; 0 past d and for the idle problems of the chunk.
template <int BC>
__device__ __forceinline__ void load_cache(VecCache<BC>& c,
                                           const float* __restrict__ v,
                                           int64_t ldv, int nb, int64_t d,
                                           int lane) {
#pragma unroll
  for (int t = 0; t < Cached<BC>::value; ++t) {
    const int64_t j = lane + 32 * t;
#pragma unroll
    for (int b = 0; b < BC; ++b)
      c.v[t][b] = (b < nb && j < d) ? __ldg(v + b * ldv + j) : 0.f;
  }
}

// acc[b] += row_b . v_b over the elements j >= from of this lane, in
// row_dot's order (j ascending, fmaf into one accumulator), the vectors
// read through L1.  SHARED: every problem reads the same row; else problem
// b's row is row + b * stride.
template <int BC, bool SHARED>
__device__ __forceinline__ void dot_from(
    float (&acc)[BC], const float* __restrict__ row, int64_t stride,
    const float* __restrict__ v, int64_t ldv, int nb, int64_t d, int lane,
    int64_t from) {
  for (int64_t j = from + lane; j < d; j += 32) {
    float g = 0.f;
    if constexpr (SHARED) g = __ldg(row + j);
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      if (b < nb) {  // warp-uniform: the chunk's last problems may be idle
        if constexpr (!SHARED) g = __ldg(row + b * stride + j);
        acc[b] = fmaf(g, __ldg(v + b * ldv + j), acc[b]);
      }
    }
  }
}

// The same with 16-byte lanes: element group j of 4 per step, as row_dot's
// VEC loop; the rows and vectors start on 16-byte boundaries.
template <int BC, bool SHARED>
__device__ __forceinline__ void dot_vec(
    float (&acc)[BC], const float* __restrict__ row, int64_t stride,
    const float* __restrict__ v, int64_t ldv, int nb, int64_t d, int lane) {
  const int64_t nv = d / 4;
  for (int64_t j = lane; j < nv; j += 32) {
    float4 g;
    if constexpr (SHARED) g = __ldg(reinterpret_cast<const float4*>(row) + j);
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      if (b < nb) {
        if constexpr (!SHARED)
          g = __ldg(reinterpret_cast<const float4*>(row + b * stride) + j);
        const float* vv = v + b * ldv + j * 4;
        acc[b] = fmaf(g.x, __ldg(vv + 0), acc[b]);
        acc[b] = fmaf(g.y, __ldg(vv + 1), acc[b]);
        acc[b] = fmaf(g.z, __ldg(vv + 2), acc[b]);
        acc[b] = fmaf(g.w, __ldg(vv + 3), acc[b]);
      }
    }
  }
}

// Walks this warp's rows i = first, first + step, ... < n of mat and calls
// done(i, s), s the lane's problem's dot product row_b . v_b (v_b = v + b
// * ldv, b < nb; row_b = mat + i * d shared, or mat + (b * n + i) * d per
// problem).  The shared pool with scalar lanes, the main path's case,
// keeps the vectors in the register cache and loads the next row's cached
// elements before the current row's multiply-adds and butterfly.
template <int BC, bool VEC, bool SHARED, typename Done>
__device__ __forceinline__ void walk_rows(
    const float* __restrict__ mat, int64_t n, int64_t d,
    const float* __restrict__ v, int64_t ldv, int nb, int lane,
    int64_t first, int64_t step, Done&& done) {
  float acc[BC];
  if constexpr (SHARED && !VEC) {
    constexpr int KC = Cached<BC>::value;
    VecCache<BC> vc;
    load_cache(vc, v, ldv, nb, d, lane);
    float next[KC];
    auto load_row = [&](int64_t i) {
#pragma unroll
      for (int t = 0; t < KC; ++t) {
        const int64_t j = lane + 32 * t;
        next[t] = (i < n && j < d) ? __ldg(mat + i * d + j) : 0.f;
      }
    };
    load_row(first);
    for (int64_t i = first; i < n; i += step) {
      float cur[KC];
#pragma unroll
      for (int t = 0; t < KC; ++t) cur[t] = next[t];
      load_row(i + step);
#pragma unroll
      for (int b = 0; b < BC; ++b) acc[b] = 0.f;
#pragma unroll
      for (int t = 0; t < KC; ++t) {
        if (lane + 32 * t < d) {
          // Idle problems multiply cached zeros into sums nobody reads.
#pragma unroll
          for (int b = 0; b < BC; ++b)
            acc[b] = fmaf(cur[t], vc.v[t][b], acc[b]);
        }
      }
      dot_from<BC, true>(acc, mat + i * d, 0, v, ldv, nb, d, lane, 32 * KC);
      done(i, chunk_sum<BC>(acc, lane));
    }
  } else {
    for (int64_t i = first; i < n; i += step) {
      const float* row = mat + i * d;
#pragma unroll
      for (int b = 0; b < BC; ++b) acc[b] = 0.f;
      if constexpr (VEC) {
        dot_vec<BC, SHARED>(acc, row, n * d, v, ldv, nb, d, lane);
        dot_from<BC, SHARED>(acc, row, n * d, v, ldv, nb, d, lane,
                             (d / 4) * 4);
      } else {
        dot_from<BC, SHARED>(acc, row, n * d, v, ldv, nb, d, lane, 0);
      }
      done(i, chunk_sum<BC>(acc, lane));
    }
  }
}

// One wave of 4 blocks an SM: each warp walks ~n / 4224 rows, so its
// register cache and prefetch pay off over many rows.
inline int64_t batched_blocks(int64_t n) {
  const int64_t b = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return b < 1 ? 1 : (b > 132 * 4 ? 132 * 4 : b);
}

template <int BC, bool VEC>
__global__ void __launch_bounds__(kThreads)
corr_batched_kernel(const float* __restrict__ g, const float* __restrict__ v,
                    float* __restrict__ out, int64_t n, int64_t d,
                    int64_t B) {
  constexpr int SHIFT = 5 - ChunkLog<BC>::value;
  const int lane = threadIdx.x & 31;
  const int mine = lane >> SHIFT;
  const bool writer = (lane & ((1 << SHIFT) - 1)) == 0;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t b0 = 0; b0 < B; b0 += BC) {
    const int nb = static_cast<int>(B - b0 < BC ? B - b0 : BC);
    walk_rows<BC, VEC, true>(g, n, d, v + b0 * d, d, nb, lane, first, step,
                             [&](int64_t i, float s) {
      if (writer && mine < nb) out[i * B + b0 + mine] = s;
    });
  }
}

template <int BC, bool VEC, bool SHARED>
__global__ void __launch_bounds__(kThreads)
corr_argmax_batched_kernel(const float* __restrict__ mat,
                           const float* __restrict__ w,
                           const float* __restrict__ base,
                           const uint8_t* __restrict__ mask, int64_t n,
                           int64_t p, int64_t B, int absolute,
                           unsigned long long* __restrict__ best) {
  constexpr int SHIFT = 5 - ChunkLog<BC>::value;
  __shared__ unsigned long long warp_keys[kWarpsPerBlock][BC];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int mine = lane >> SHIFT;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        wib;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t b0 = 0; b0 < B; b0 += BC) {
    const int nb = static_cast<int>(B - b0 < BC ? B - b0 : BC);
    const bool live = mine < nb;
    // 0 is below every packed key (the key of -inf is 0x007fffff'...).
    unsigned long long key = 0ull;
    walk_rows<BC, VEC, SHARED>(SHARED ? mat : mat + b0 * n * p, n, p,
                               w + b0 * p, p, nb, lane, first, step,
                               [&](int64_t i, float dot) {
      if (live) {
        const int64_t at = i * B + b0 + mine;
        float s = base[at] - dot;
        if (absolute) s = fabsf(s);
        if (!mask[at]) s = -INFINITY;
        const unsigned long long k = pack_key(s, i);
        key = k > key ? k : key;
      }
    });
    if ((lane & ((1 << SHIFT) - 1)) == 0) warp_keys[wib][mine] = key;
    __syncthreads();
    if (threadIdx.x < nb) {
      unsigned long long m = warp_keys[0][threadIdx.x];
#pragma unroll
      for (int q = 1; q < kWarpsPerBlock; ++q)
        m = warp_keys[q][threadIdx.x] > m ? warp_keys[q][threadIdx.x] : m;
      if (m != 0ull) atomicMax(best + b0 + threadIdx.x, m);
    }
    __syncthreads();
  }
}

// One thread a problem decodes its folded key, as argmax_decode_kernel.
__global__ void argmax_decode_batched_kernel(
    const unsigned long long* __restrict__ best, int64_t B,
    int* __restrict__ idx, float* __restrict__ val) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= B) return;
  const unsigned long long k = best[b];
  if (k == 0ull) {  // no rows at all
    idx[b] = 0;
    val[b] = -INFINITY;
    return;
  }
  unsigned int u = static_cast<unsigned int>(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  idx[b] = static_cast<int>(~static_cast<unsigned int>(k & 0xffffffffull));
  val[b] = __uint_as_float(u);
}

// The chunk width for B problems: the least power of two >= B, at most 32.
template <typename F>
void with_chunk(int64_t B, F&& f) {
  if (B <= 1) f(std::integral_constant<int, 1>{});
  else if (B <= 2) f(std::integral_constant<int, 2>{});
  else if (B <= 4) f(std::integral_constant<int, 4>{});
  else if (B <= 8) f(std::integral_constant<int, 8>{});
  else if (B <= 16) f(std::integral_constant<int, 16>{});
  else f(std::integral_constant<int, kMaxChunk>{});
}

}  // namespace

}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// g (n, d) f32, v (B, d) f32, out (n, B) f32.  vec: 1 when g's rows start
// on 16-byte boundaries and d is a multiple of 4 (as rt_corr's vec).
int rt_corr_batched(int device, const float* g, const float* v, float* out,
                    int64_t n, int64_t d, int64_t B, int vec, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_chunk(B, [&](auto bc) {
    constexpr int BC = decltype(bc)::value;
    if (vec)
      corr_batched_kernel<BC, true><<<batched_blocks(n), kThreads, 0, s>>>(
          g, v, out, n, d, B);
    else
      corr_batched_kernel<BC, false><<<batched_blocks(n), kThreads, 0, s>>>(
          g, v, out, n, d, B);
  });
  return static_cast<int>(cudaGetLastError());
}

// mat (n, p) shared (per_problem 0) or (B, n, p) (per_problem 1), f32;
// w (B, p) f32; base (n, B) f32; mask (n, B) bool.  best: B 8-byte scratch
// words on the device; idx (B,) int32, val (B,) float32 on the device.
int rt_corr_argmax_batched(int device, const float* mat, const float* w,
                           const float* base, const uint8_t* mask, int64_t n,
                           int64_t p, int64_t B, int per_problem,
                           int absolute, int vec, void* best, int* idx,
                           float* val, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(best);
  e = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * B, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  with_chunk(B, [&](auto bc) {
    constexpr int BC = decltype(bc)::value;
    const int64_t grid = batched_blocks(n);
    if (per_problem) {
      if (vec)
        corr_argmax_batched_kernel<BC, true, false><<<grid, kThreads, 0, s>>>(
            mat, w, base, mask, n, p, B, absolute, keys);
      else
        corr_argmax_batched_kernel<BC, false, false><<<grid, kThreads, 0, s>>>(
            mat, w, base, mask, n, p, B, absolute, keys);
    } else {
      if (vec)
        corr_argmax_batched_kernel<BC, true, true><<<grid, kThreads, 0, s>>>(
            mat, w, base, mask, n, p, B, absolute, keys);
      else
        corr_argmax_batched_kernel<BC, false, true><<<grid, kThreads, 0, s>>>(
            mat, w, base, mask, n, p, B, absolute, keys);
    }
  });
  const int64_t threads = 256;
  argmax_decode_batched_kernel<<<(B + threads - 1) / threads, threads, 0,
                                 s>>>(keys, B, idx, val);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
