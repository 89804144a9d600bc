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
// memory: every row's mask byte, and the bf16 row and 8 bytes of sidecars
// of each masked-in row.  At the streaming paths' arenas, (88 064, 10) and
// (86 016, 65) bf16 with about half the rows in empty slots, that is 1.2
// and 5.7 MB, 0.37 and 1.69 us at 3.35 TB/s: less than one device
// operation costs.  So the latency of the call bounds it.
//
// The row loop's first form was four device operations a call (a memset
// of the count, a memset of the key word, the kernel, a decode launch), and
// it gives each thread a row to walk element by element in device memory:
// a warp's 2-byte loads fall on 32 rows 20 or 130 bytes apart, and every
// row of the arena's empty half is visited.  Now:
//
// 1. One device operation a call, on both routes.  The wrapper keeps a
//    workspace per (device, stream): the key word, the count word and a
//    completion counter, each on its own 128-byte line, zero when made.
//    Each block folds its key with one atomicMax and its count with one
//    atomicAdd; the last block to finish (the counter behind
//    __threadfence) writes val, idx and count and returns the words to 0.
// 2. The tile route (kernels/corr.py: bound_max_plan): tiles of 256 rows,
//    one thread a row.  A block first reads its tiles' mask bytes with
//    16-byte loads and lists the tiles with a live row; only those are
//    copied (one cp.async.bulk of the tile's rows, 256 d 2 bytes, a
//    multiple of 16 for any d, into a ring of one or two shared-memory
//    slots, counted on the slot's mbarrier) and scanned, so the arena's
//    empty half costs its mask bytes only.  While a tile is in flight a
//    thread loads its row's mask byte and, if live, its two sidecars.  At
//    the arenas every tile has its own block and every live tile is in
//    flight at once (one slot a block, one wave); a larger n takes a
//    persistent wave and a ring of two.
// 3. The same bits as the row loop: a thread dots its row from shared
//    memory in column order with the same fmaf chain, ||r|| comes from the
//    same block_norm, and u from the same expression (bound_u), so max,
//    index and count equal the row loop's exactly.  Where the row stride
//    puts four or more of a warp's rows on one bank (a multiple of 16
//    bytes: d 32, 64, 96 bf16), lane l walks column s - l at step s, so
//    the warp's reads spread over the banks (the chain keeps its order).
//    The row loop stays as the route for rows or a mask whose base is not
//    16-byte aligned, for a small n, and for rows under 32 columns: there a
//    warp's 32 rows span at most 2 KB and the row loop, one device
//    operation now as well, is the faster on an H100 (8.2 against 9.0 us
//    at the (88 064, 10) arena; the tiles 10.8 against 14.2 us at
//    (88 064, 65); tools/kernel_turns.py --routes, PERF.md).
//
// The (u, index) pair folds through the packed 64-bit key of common.cuh
// (the lowest index wins a tie; an all-masked input decodes to (0, -inf)).
// thresh is read from device memory, so a caller that holds it on the
// device never syncs for it.
#include <climits>

#include "common.cuh"
#include "mbarrier.cuh"

namespace repro_torch {
namespace {

// The workspace (kernels/corr.py: BOUND_WS_WORDS 8-byte words): the key
// word at word 0, the count at word 16, the completion counter at word 32.
constexpr int kWsCount = 16;
constexpr int kWsDone = 32;

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

// The bound of a row from its dot product s, its sidecars e (error norm)
// and nm (norm): one expression for both routes, so both round alike.
__device__ __forceinline__ float bound_u(float s, float e, float nm,
                                         float acc, float rnorm) {
  return s + (e + acc * nm) * rnorm;
}

// The block's last act: fold its (key, count) into the workspace, count
// the block finished, and in the grid's last block write (val, idx,
// count) and return the workspace to 0.  Every thread calls it.
__device__ __forceinline__ void fold_bound(unsigned long long key, int cnt,
                                           unsigned long long* ws, int* idx,
                                           float* val, int* count) {
  __shared__ unsigned long long warp_keys[kWarpsPerBlock];
  __shared__ int warp_cnt[kWarpsPerBlock];
  key = warp_max_key(key);
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  const int wib = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_keys[wib] = key;
    warp_cnt[wib] = cnt;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long m = warp_keys[0];
  int c = warp_cnt[0];
#pragma unroll
  for (int q = 1; q < kWarpsPerBlock; ++q) {
    m = warp_keys[q] > m ? warp_keys[q] : m;
    c += warp_cnt[q];
  }
  auto* cword = reinterpret_cast<unsigned int*>(ws + kWsCount);
  auto* done = reinterpret_cast<unsigned int*>(ws + kWsDone);
  if (m != 0ull) atomicMax(ws, m);
  if (c != 0) atomicAdd(cword, static_cast<unsigned int>(c));
  __threadfence();
  if (atomicAdd(done, 1u) != gridDim.x - 1) return;
  __threadfence();
  const unsigned long long k = atomicExch(ws, 0ull);
  *count = static_cast<int>(atomicExch(cword, 0u));
  if (k == 0ull) {  // no masked-in row
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

struct BoundArgs {
  const void* rows;          // (n, d) bf16 or f32
  const float* norms;        // (n,)
  const float* errn;         // (n,)
  const float* r;            // (d,)
  float acc;
  const float* thresh;       // one float on the device
  const uint8_t* mask;       // (n,) bool
  int64_t n, d;
  int absolute;
  int tile_rows;             // the tile route's rows a tile (kBoundRows)
  int stages;                // the tile route's ring slots
  int skew;                  // the tile route's skewed column walk
  unsigned long long* ws;    // the workspace
  int* idx;
  float* val;
  int* count;
};

// ---------------------------------------------------------------------------
// The row loop: one thread a row, rows walked in device memory.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) bound_rows_kernel(
    const BoundArgs a) {
  __shared__ float part[kWarpsPerBlock];
  const T* rows = static_cast<const T*>(a.rows);
  const int64_t n = a.n, d = a.d;
  const float rnorm = block_norm(a.r, d, part);
  const float th = *a.thresh;
  unsigned long long key = 0ull;
  int cnt = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    if (!a.mask[i]) continue;
    const T* row = rows + i * d;
    float s = 0.f;
    for (int64_t j = 0; j < d; ++j)
      s = fmaf(to_f32(row[j]), __ldg(a.r + j), s);
    if (a.absolute) s = fabsf(s);
    const float u = bound_u(s, a.errn[i], a.norms[i], a.acc, rnorm);
    const unsigned long long k = pack_key(u, i);
    key = k > key ? k : key;
    cnt += u >= th;
  }
  fold_bound(key, cnt, a.ws, a.idx, a.val, a.count);
}

// ---------------------------------------------------------------------------
// The tile route: live tiles by bulk copy, one thread a row.
// ---------------------------------------------------------------------------

constexpr int kBoundRows = kThreads;  // rows a tile: one a thread
static_assert(kBoundRows == 256, "a tile's mask bytes are 16 lanes' loads");
constexpr int kBoundMaxTiles = 64;    // tiles a block walks, at most
constexpr int kBoundMaxStages = 2;
// A block's dynamic shared memory, at most: 227 KB, a block's most on
// sm_90, less 1 KB for the kernel's static shared variables.
constexpr int64_t kBoundSmem = kMaxSmem - 1024;

// Dynamic shared memory of a tile block, in bytes from its base
// (kernels/corr.py: bound_smem mirrors the total):
//   [0, 128)  the slots' "full" mbarriers (tile landed) and "empty" ones
//             (every thread is done with the tile);
//   r         the residual, d floats;
//   slots     `stages` slots of one tile's rows, R d sizeof(T) bytes.
struct BoundLayout {
  int64_t r, slot, slot_bytes, total;
  __host__ __device__ BoundLayout(int64_t d, int64_t es, int64_t rows,
                                  int64_t stages) {
    r = 128;
    slot = align128(r + d * 4);
    slot_bytes = align128(rows * d * es);
    total = slot + stages * slot_bytes;
  }
};

// Thread 0 starts copying the rows of tile `tile` into a slot: the
// 16-byte multiple of its bytes by one bulk copy counted on `bar`, the
// < 16-byte rest of a tail tile by plain 2-byte copies.  The tile starts
// on a 16-byte boundary (the base is aligned and R d sizeof(T) is a
// multiple of 16).
template <typename T>
__device__ __forceinline__ void start_rows(const BoundArgs& a, int64_t tile,
                                           unsigned char* slot,
                                           uint32_t bar) {
  const int64_t r0 = tile * a.tile_rows;
  const int64_t rows = a.n - r0 < a.tile_rows ? a.n - r0 : a.tile_rows;
  const auto* src =
      reinterpret_cast<const unsigned char*>(static_cast<const T*>(a.rows) +
                                             r0 * a.d);
  const uint32_t bytes = static_cast<uint32_t>(rows * a.d * sizeof(T));
  const uint32_t bulk = bytes & ~15u;
  for (uint32_t p = bulk; p < bytes; p += 2)
    *reinterpret_cast<uint16_t*>(slot + p) =
        *reinterpret_cast<const uint16_t*>(src + p);
  mbar_expect_tx(bar, bulk);
  if (bulk > 0) bulk_load(smem_u32(slot), src, bulk, bar);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bound_tiles_kernel(
    const BoundArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float part[kWarpsPerBlock];
  __shared__ int live[kBoundMaxTiles];
  __shared__ int nlive;
  const int t = threadIdx.x;
  const int64_t n = a.n, d = a.d;
  const int R = a.tile_rows, ST = a.stages;
  const BoundLayout lay(d, sizeof(T), R, ST);
  float* rs = reinterpret_cast<float*>(smem + lay.r);
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * kBoundMaxStages;
  const int64_t tiles = (n + R - 1) / R;
  const int64_t grid = gridDim.x;
  const int mine = blockIdx.x < tiles
                       ? static_cast<int>((tiles - 1 - blockIdx.x) / grid + 1)
                       : 0;
  const auto tile_of = [&](int k) { return blockIdx.x + k * grid; };

  // Warp 0 reads the block's tiles' mask bytes, 16 a lane and two tiles a
  // step (a tile's 256 bytes on 16 lanes), lists the tiles with a live row
  // and starts the first ST copies as soon as it finds them; the other
  // warps meanwhile stage the residual and its norm.
  if (t < 32) {
    if (t == 0) {
      for (int s = 0; s < ST; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, kThreads);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    int count = 0;
    for (int k0 = 0; k0 < mine; k0 += 2) {
      const int k = k0 + (t >> 4);
      bool any = false;
      if (k < mine) {
        const int64_t i0 = tile_of(k) * R + 16 * (t & 15);
        if (i0 + 16 <= n) {
          const uint4 m = *reinterpret_cast<const uint4*>(a.mask + i0);
          any = (m.x | m.y | m.z | m.w) != 0u;
        } else {
          for (int64_t i = i0; i < n; ++i) any = any || a.mask[i] != 0;
        }
      }
      const unsigned int b = __ballot_sync(0xffffffffu, any);
      for (int h = 0; h < 2 && k0 + h < mine; ++h) {
        if ((b >> (16 * h)) & 0xffffu) {
          if (t == 0) {
            live[count] = k0 + h;
            if (count < ST)
              start_rows<T>(a, tile_of(k0 + h),
                            smem + lay.slot + count * lay.slot_bytes,
                            full0 + 8 * count);
          }
          ++count;
        }
      }
    }
    if (t == 0) nlive = count;
  }
  for (int64_t j = t; j < d; j += kThreads) rs[j] = __ldg(a.r + j);
  // Syncs the block: the barriers, the live list and the residual are in.
  const float rnorm = block_norm(a.r, d, part);
  const int L = nlive;
  const float th = *a.thresh;
  unsigned long long key = 0ull;
  int cnt = 0;
  for (int j = 0; j < L; ++j) {
    const int s = j % ST;
    const uint32_t use = static_cast<uint32_t>((j / ST) & 1);
    const int64_t r0 = tile_of(live[j]) * R;
    const int64_t i = r0 + t;
    // This row's mask byte and sidecars, in flight beside the tile.
    bool in = false;
    float nm = 0.f, er = 0.f;
    if (i < n && a.mask[i]) {
      in = true;
      nm = a.norms[i];
      er = a.errn[i];
    }
    unsigned char* slot = smem + lay.slot + s * lay.slot_bytes;
    mbar_wait(full0 + 8 * s, use);
    const T* row = reinterpret_cast<const T*>(slot) + t * d;
    float sd = 0.f;
    if (a.skew) {
      // Rows whose stride puts a warp's 32 rows on a few banks (a stride
      // of a multiple of 16 bytes): lane l reads column s - l at step s,
      // so the warp's reads spread over the banks; each lane's chain is
      // still in column order.
      if (__any_sync(0xffffffffu, in)) {
        const int64_t lane = t & 31;
        for (int64_t s = 0; s < d + 31; ++s) {
          const int64_t c = s - lane;
          if (in && c >= 0 && c < d)
            sd = fmaf(to_f32(row[c]), rs[c], sd);
        }
      }
    } else if (in) {
      for (int64_t c = 0; c < d; ++c) sd = fmaf(to_f32(row[c]), rs[c], sd);
    }
    if (in) {
      if (a.absolute) sd = fabsf(sd);
      const float u = bound_u(sd, er, nm, a.acc, rnorm);
      const unsigned long long k = pack_key(u, i);
      key = k > key ? k : key;
      cnt += u >= th;
    }
    // Every thread is done with the slot: once all have said so, thread 0
    // refills it with the live tile ST further on.  The proxy fence orders
    // this thread's reads of the slot before the bulk copy's writes (the
    // async proxy), which a barrier alone does not.
    if (j + ST < L) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(empty0 + 8 * s);
      if (t == 0) {
        mbar_wait(empty0 + 8 * s, use);
        start_rows<T>(a, tile_of(live[j + ST]), slot, full0 + 8 * s);
      }
    }
  }
  fold_bound(key, cnt, a.ws, a.idx, a.val, a.count);
}

template <typename T>
cudaError_t launch_tiles(const BoundArgs& a, int device, int64_t grid,
                         int64_t smem, cudaStream_t s) {
  const cudaError_t e =
      allow_smem<bound_tiles_kernel<T>>(device, smem, kBoundSmem);
  if (e != cudaSuccess) return e;
  bound_tiles_kernel<T><<<static_cast<unsigned int>(grid), kThreads,
                          static_cast<size_t>(smem), s>>>(a);
  return cudaGetLastError();
}

// The tile route after the plan's checks: tiles of one row a thread, at
// most kBoundMaxTiles a block, the rows and the mask 16-byte aligned, the
// layout within a block's shared memory.
template <typename T>
cudaError_t bound_tiles(const BoundArgs& a, int device, int64_t grid,
                        cudaStream_t s) {
  const int64_t tiles = (a.n + a.tile_rows - 1) / a.tile_rows;
  if (a.d < 1 || a.n < 1 || a.tile_rows != kBoundRows || a.stages < 1 ||
      a.stages > kBoundMaxStages || grid < 1 || grid > tiles ||
      grid * kBoundMaxTiles < tiles ||
      reinterpret_cast<uintptr_t>(a.rows) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.mask) % 16 != 0)
    return cudaErrorInvalidValue;
  const int64_t smem =
      BoundLayout(a.d, sizeof(T), a.tile_rows, a.stages).total;
  if (smem > kBoundSmem) return cudaErrorInvalidValue;
  return launch_tiles<T>(a, device, grid, smem, s);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 rows.  thresh: one float32 on the
// device.  route 1: the tile route, `tile_rows` rows a tile, `stages` ring
// slots, `skew` 1 for the skewed column walk; route 0: the row loop.
// grid: the plan's blocks.  ws: the workspace, 33 8-byte words on the
// device, zero before the call and zero after it.  idx / val / count: one
// int32, one float32 and one int32 on the device.  Returns
// cudaGetLastError() after the launch.
int rt_bound_max(int device, const void* rows, int dtype, const float* norms,
                 const float* errn, const float* r, float acc,
                 const float* thresh, const uint8_t* mask, int64_t n,
                 int64_t d, int absolute, int route, int tile_rows,
                 int stages, int skew, int64_t grid, void* ws, int* idx,
                 float* val,
                 int* count, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || grid > INT_MAX || n < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BoundArgs a{};
  a.rows = rows;
  a.norms = norms;
  a.errn = errn;
  a.r = r;
  a.acc = acc;
  a.thresh = thresh;
  a.mask = mask;
  a.n = n;
  a.d = d;
  a.absolute = absolute;
  a.tile_rows = tile_rows;
  a.stages = stages;
  a.skew = skew;
  a.ws = static_cast<unsigned long long*>(ws);
  a.idx = idx;
  a.val = val;
  a.count = count;
  if (route == 1)
    return static_cast<int>(
        dtype == 1 ? bound_tiles<__nv_bfloat16>(a, device, grid, s)
                   : bound_tiles<float>(a, device, grid, s));
  const unsigned int blocks = static_cast<unsigned int>(grid);
  if (dtype == 1)
    bound_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(a);
  else
    bound_rows_kernel<float><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
