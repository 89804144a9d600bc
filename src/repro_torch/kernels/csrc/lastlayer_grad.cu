// Fused last-layer gradient pieces for classification heads, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lastlayer_grad.py:
// lastlayer_grad:
//   resid = softmax(Z) - onehot(Y)        (n, C)
//   hgrad = resid[i, y_i] * hidden_i      (n, d_h)
//
// What bounds it on an H100: a few flops and one exp per logit, so device
// memory bounds it: it reads hidden, Z and the labels once and writes resid
// and hgrad once; at the main path's (45 000, 64, 10) with int64 labels
// that is 27.0 MB, 8.06 us at 3.35 TB/s.
//
// The warp route (the first kernel, below) gives one warp a row and makes
// two dependent trips to memory a row: the logits (40 bytes on 10 of 32
// lanes), two butterflies and the resid store, and only then the 256 bytes
// of hidden and the hgrad store.  No hidden row is in flight while a
// softmax runs, and the grid's cap leaves a second, partial wave of rows.
//
// The tile route (kernels/lastlayer_grad.py: lastlayer_plan) puts a block's
// rows in flight at once: a tile of R rows (R a multiple of 4, at most 128)
// arrives by three cp.async.bulk copies, its hidden rows (R d_h 4 bytes),
// logits (R C 4) and labels (R 4 or R 8), all multiples of 16 bytes, into a
// shared-memory slot counted on the slot's mbarrier.  Where the tiles fit
// one wave of blocks each block takes one tile and one slot, so every
// tile is in flight at once (at the main path: 352 tiles of 39.4 KB, 13.7
// MB, ~101 KB an SM); a larger n takes a persistent wave and a ring of two
// slots, a tile loading while the one before it is computed and stored.
// One thread takes a row's softmax out of shared memory, in place, and
// replays the warp route's arithmetic exactly: the same row max (fmaxf, in any
// order the same value), the exp sum of lane c's term folded in warp_sum's
// butterfly order as a serial tree (lane_tree: every addition rounds the
// same two operands as the warp's), the same expf, the same division, and
// own as the same expression as resid[i, y].  So resid and hgrad equal the
// warp route's bit for bit, and a row's bits depend on that row alone,
// never on n or on where its tile starts.  The block then writes the
// tile's resid and hgrad (own times hidden, as the warp route's product)
// with 16-byte coalesced stores.  The tile route takes C <= 32 (one term a
// lane); the warp route stays for a larger C, for C 16 and 32 (a warp's
// 32 logits rows on one bank in 16 or 32), a base that is not 16-byte
// aligned and n under 8 192, where its shorter latency wins.  On an H100
// at 700 W (tools/kernel_turns.py, PERF.md): 12.3-13.0 us at the main
// path against the warps' 19.3-20.0 (the bound 8.06, two copies of the
// same bytes 15.2-15.5); 6.2 us on the warps at n 1 024.
#include <climits>

#include "common.cuh"
#include "mbarrier.cuh"

namespace repro_torch {
namespace {

template <typename L>
__global__ void __launch_bounds__(kThreads)
lastlayer_grad_kernel(const float* __restrict__ hidden,
                      const float* __restrict__ logits,
                      const L* __restrict__ labels, float* __restrict__ resid,
                      float* __restrict__ hgrad, int64_t n, int64_t dh,
                      int64_t nc) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       i < n; i += nwarps) {
    const float* z = logits + i * nc;
    float m = -INFINITY;
    for (int64_t c = lane; c < nc; c += 32) m = fmaxf(m, z[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int64_t c = lane; c < nc; c += 32) sum += expf(z[c] - m);
    sum = warp_sum(sum);
    const int64_t y = static_cast<int64_t>(labels[i]);
    float* out = resid + i * nc;
    for (int64_t c = lane; c < nc; c += 32)
      out[c] = expf(z[c] - m) / sum - (c == y ? 1.f : 0.f);
    // The same expression as resid[i, y], so the two outputs agree exactly.
    const float own = (y >= 0 && y < nc) ? expf(z[y] - m) / sum - 1.f : 0.f;
    const float* h = hidden + i * dh;
    float* hg = hgrad + i * dh;
    for (int64_t j = lane; j < dh; j += 32) hg[j] = own * h[j];
  }
}

// ---------------------------------------------------------------------------
// The tile route: rows in flight by bulk copy, one thread a row's softmax.
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 128;
constexpr int kTileMaxRows = 128;   // rows a tile: one softmax a thread
constexpr int kTileMaxC = 32;       // classes: one term a lane
constexpr int kTileMaxStages = 2;

// Shared memory of a tile block, in bytes from its base
// (kernels/lastlayer_grad.py: tile_smem mirrors the total):
//   [0, 128)  the slots' "full" mbarriers (tile landed) and "empty" ones
//             (every thread is done with the tile);
//   slots     `stages` slots, each: the tile's hidden rows (R d_h f32),
//             its logits (R C f32, turned into resid in place), its labels
//             (R int32 or int64) and own (R f32), each part 128-aligned.
struct TileLayout {
  int64_t h, z, y, own, slot_bytes, total;
  __host__ __device__ TileLayout(int64_t dh, int64_t nc, int64_t label_bytes,
                                 int64_t rows, int64_t stages) {
    h = 0;
    z = align128(rows * dh * 4);
    y = z + align128(rows * nc * 4);
    own = y + align128(rows * label_bytes);
    slot_bytes = own + align128(rows * 4);
    total = 128 + stages * slot_bytes;
  }
};

struct TileArgs {
  const float* hidden;
  const float* logits;
  const void* labels;
  float* resid;
  float* hgrad;
  int64_t n, dh, nc;
  int rows;     // rows a tile
  int stages;   // ring slots
};

// One part of a tile (its hidden rows, logits or labels): `bytes` from
// device memory at `src` (16-byte aligned) into shared memory at `dst`.
// The 16-byte multiple goes by one bulk copy; the < 16-byte rest of a tail
// tile by plain 4-byte copies, made first.
struct Part {
  unsigned char* dst;
  const unsigned char* src;
  uint32_t bulk;
};

__device__ __forceinline__ Part copy_rest(unsigned char* dst,
                                          const void* src, int64_t bytes) {
  const uint32_t all = static_cast<uint32_t>(bytes);
  const Part p{dst, static_cast<const unsigned char*>(src), all & ~15u};
  for (uint32_t q = p.bulk; q < all; q += 4)
    *reinterpret_cast<uint32_t*>(dst + q) =
        *reinterpret_cast<const uint32_t*>(p.src + q);
  return p;
}

// Thread 0 starts loading tile `tile` into a slot: its hidden rows, logits
// and labels.  The plain copies of the tails come before the arrival on
// `bar` (which releases them to the waiting threads), the three bulk
// copies after it, on one transaction count.
template <typename L>
__device__ __forceinline__ void start_tile(const TileArgs& a,
                                           const TileLayout& lay,
                                           int64_t tile, unsigned char* slot,
                                           uint32_t bar) {
  const int64_t r0 = tile * a.rows;
  const int64_t rows = a.n - r0 < a.rows ? a.n - r0 : a.rows;
  const Part parts[3] = {
      copy_rest(slot + lay.h, a.hidden + r0 * a.dh, rows * a.dh * 4),
      copy_rest(slot + lay.z, a.logits + r0 * a.nc, rows * a.nc * 4),
      copy_rest(slot + lay.y, static_cast<const L*>(a.labels) + r0,
                rows * static_cast<int64_t>(sizeof(L)))};
  mbar_expect_tx(bar, parts[0].bulk + parts[1].bulk + parts[2].bulk);
  for (const Part& p : parts)
    if (p.bulk > 0) bulk_load(smem_u32(p.dst), p.src, p.bulk, bar);
}

// warp_sum's butterfly over 32 lane terms as a serial tree: after the step
// at xor offset OFF lane l holds F(l, OFF) = F(l, 2 OFF) + F(l + OFF,
// 2 OFF) (l < OFF), with F(l, 32) lane l's term; IEEE addition is
// commutative, so each addition here rounds the same two operands as the
// warp's.  Lane c's term is e[c] for c < nc and 0 past it, as a lane with
// no class keeps its 0.f (C <= 32: one term a lane).  __fadd_rn: an
// addition the compiler never fuses into a multiply-add.
template <int L, int OFF>
__device__ __forceinline__ float lane_tree(const float* e, int nc) {
  if constexpr (OFF == 32) {
    return L < nc ? e[L] : 0.f;
  } else {
    return __fadd_rn(lane_tree<L, 2 * OFF>(e, nc),
                     lane_tree<L + OFF, 2 * OFF>(e, nc));
  }
}

// One row's softmax residual in place (z: its C logits in shared memory)
// with label y; returns own = resid[y] (0 for a label outside [0, C)).
// The warp route's arithmetic, term for term.
__device__ __forceinline__ float softmax_row(float* z, int nc, int64_t y) {
  float m = -INFINITY;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, z[c]);
  for (int c = 0; c < nc; ++c) z[c] = expf(z[c] - m);
  const float sum = lane_tree<0, 1>(z, nc);
  for (int c = 0; c < nc; ++c)
    z[c] = z[c] / sum - (c == y ? 1.f : 0.f);
  return (y >= 0 && y < nc) ? z[y] : 0.f;
}

template <typename L>
__global__ void __launch_bounds__(kTileThreads) lastlayer_tiles_kernel(
    const TileArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int R = a.rows, ST = a.stages;
  const int64_t n = a.n, dh = a.dh;
  const int nc = static_cast<int>(a.nc);
  const TileLayout lay(dh, nc, sizeof(L), R, ST);
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * kTileMaxStages;
  const int64_t tiles = (n + R - 1) / R;
  const int64_t grid = gridDim.x;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / grid + 1 : 0;
  // e / d_h for a tile's element e (< 2^16 here, e d_h < 2^32): the high
  // half of e (2^32 / d_h + 1), exact in that range.
  const unsigned long long inv = (1ull << 32) / static_cast<uint64_t>(dh) + 1;

  if (t == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kTileThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int64_t k = 0; k < mine && k < ST; ++k)
      start_tile<L>(a, lay, blockIdx.x + k * grid,
                    smem + 128 + k * lay.slot_bytes, full0 + 8 * k);
  }
  __syncthreads();

  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % ST);
    const uint32_t use = static_cast<uint32_t>((k / ST) & 1);
    const int64_t tile = blockIdx.x + k * grid;
    const int64_t r0 = tile * R;
    const int rows = static_cast<int>(n - r0 < R ? n - r0 : R);
    unsigned char* slot = smem + 128 + s * lay.slot_bytes;
    const float* h = reinterpret_cast<const float*>(slot + lay.h);
    float* z = reinterpret_cast<float*>(slot + lay.z);
    const L* y = reinterpret_cast<const L*>(slot + lay.y);
    float* own = reinterpret_cast<float*>(slot + lay.own);
    mbar_wait(full0 + 8 * s, use);
    if (t < rows)
      own[t] = softmax_row(z + t * nc, nc, static_cast<int64_t>(y[t]));
    __syncthreads();
    // resid: the tile's rows x C floats, one contiguous span.
    float* ro = a.resid + r0 * nc;
    const int zn = rows * nc;
    for (int q = t; q < zn / 4; q += kTileThreads)
      reinterpret_cast<float4*>(ro)[q] = reinterpret_cast<const float4*>(z)[q];
    for (int e = zn / 4 * 4 + t; e < zn; e += kTileThreads) ro[e] = z[e];
    // hgrad: own times each hidden row, rows x d_h floats, one span.
    float* ho = a.hgrad + r0 * dh;
    const int hn = static_cast<int>(rows * dh);
    for (int q = t; q < hn / 4; q += kTileThreads) {
      const unsigned int e = 4u * q;
      int row = static_cast<int>((e * inv) >> 32);
      int col = static_cast<int>(e - row * dh);
      float4 v = reinterpret_cast<const float4*>(h)[q];
      float o = own[row];
      float* x = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (col == dh) {
          col = 0;
          o = own[++row];
        }
        x[p] = o * x[p];
        ++col;
      }
      reinterpret_cast<float4*>(ho)[q] = v;
    }
    for (int e = hn / 4 * 4 + t; e < hn; e += kTileThreads)
      ho[e] = own[static_cast<int>((static_cast<unsigned int>(e) * inv) >> 32)]
              * h[e];
    // Every thread is done with the slot: once all have said so, thread 0
    // refills it with the tile ST further on.  The proxy fence orders this
    // thread's accesses to the slot before the bulk copy's writes (the
    // async proxy), which a barrier alone does not.
    if (k + ST < mine) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(empty0 + 8 * s);
      if (t == 0) {
        mbar_wait(empty0 + 8 * s, use);
        start_tile<L>(a, lay, tile + ST * grid, slot, full0 + 8 * s);
      }
    }
  }
}

template <typename L>
cudaError_t launch_tiles(const TileArgs& a, int device, int64_t grid,
                         int64_t smem, cudaStream_t s) {
  const cudaError_t e = allow_smem<lastlayer_tiles_kernel<L>>(device, smem);
  if (e != cudaSuccess) return e;
  lastlayer_tiles_kernel<L><<<static_cast<unsigned int>(grid), kTileThreads,
                              static_cast<size_t>(smem), s>>>(a);
  return cudaGetLastError();
}

// The tile route after the plan's checks: 1 <= C <= 32, d_h >= 1, tiles
// of a multiple of 4 rows up to 128, every base 16-byte aligned, the
// layout within a block's shared memory (and a tile's elements below
// 2^16), at most a grid of tiles.
template <typename L>
cudaError_t lastlayer_tiles(const TileArgs& a, int device, int64_t grid,
                            cudaStream_t s) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (a.n < 1 || a.dh < 1 || a.nc < 1 || a.nc > kTileMaxC || a.rows < 4 ||
      a.rows > kTileMaxRows || a.rows % 4 != 0 || a.stages < 1 ||
      a.stages > kTileMaxStages || grid < 1 ||
      grid > (a.n + a.rows - 1) / a.rows || misaligned(a.hidden) ||
      misaligned(a.logits) || misaligned(a.labels) || misaligned(a.resid) ||
      misaligned(a.hgrad) || a.rows * a.dh >= (1 << 16))
    return cudaErrorInvalidValue;
  const int64_t smem =
      TileLayout(a.dh, a.nc, sizeof(L), a.rows, a.stages).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return launch_tiles<L>(a, device, grid, smem, s);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// label64: 1 for int64 labels, 0 for int32.  route 1: the tile route,
// `rows` rows a tile, `stages` ring slots; route 0: the warp route.
// grid: the plan's blocks.  Returns cudaGetLastError().
int rt_lastlayer_grad(int device, const float* hidden, const float* logits,
                      const void* labels, int label64, float* resid,
                      float* hgrad, int64_t n, int64_t dh, int64_t nc,
                      int route, int rows, int stages, int64_t grid,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || grid > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    const TileArgs a{hidden, logits, labels, resid, hgrad, n, dh, nc, rows,
                     stages};
    return static_cast<int>(
        label64 ? lastlayer_tiles<int64_t>(a, device, grid, s)
                : lastlayer_tiles<int32_t>(a, device, grid, s));
  }
  const unsigned int blocks = static_cast<unsigned int>(grid);
  if (label64)
    lastlayer_grad_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        hidden, logits, static_cast<const int64_t*>(labels), resid, hgrad, n,
        dh, nc);
  else
    lastlayer_grad_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        hidden, logits, static_cast<const int32_t*>(labels), resid, hgrad, n,
        dh, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
