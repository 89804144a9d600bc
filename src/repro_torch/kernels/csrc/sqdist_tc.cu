// Pairwise squared distances on Hopper's tensor cores (sm_90a):
//   out_ij = max(|a_i|^2 + |b_j|^2 - 2 a_i . b_j, 0)     (n, m) f32
// for a (n, d), b (m, d), both f32 or both bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sqdist.py: sqdist, which
// CRAIG reaches through greedy.pairwise_sim's dist_fn to build a resident
// similarity, beside the FFMA kernel of sqdist.cu, which keeps the shapes
// this one does not take or loses on (the wrapper's plan, kernels/sqdist.py:
// sqdist_plan).  The squared norms come in from the caller, as the TPU
// kernel's do, and the epilogue is sqdist.cu's expression.
//
// What bounds it on an H100.  At the craig-resident path's (45 000, 45 000,
// 65) the dot products are 2 n m d = 263 GFLOP, 3.9 ms at the CUDA cores'
// 67 TFLOP/s; the tensor cores take f32 only as TF32, so the f32 grade costs
// three TF32 passes (below), 0.79 TFLOP at 494.5 TFLOP/s: 1.6 ms, and half
// that when a is b and each unordered pair is computed once.  The output,
// 8.1 GB of f32, takes 2.42 ms to write at 3.35 TB/s: with the products on
// the tensor cores, the bytes written bound the call.  Written as 128 x 128
// tiles and their transposes (512-byte pieces of rows 180 000 bytes apart)
// the card takes them at ~2 TB/s, not at a sequential fill's 3.3
// (tools/sqdist_breakdown.py): that pattern, not the products, sets the
// kernel's time.
//
// Arithmetic.  f32 inputs: 3xTF32, as fl_gain_tc.cu.  The prologue
// (sq_split_kernel) cuts each x into hi = tf32_rna(x) and lo = tf32_rna(x -
// hi), and every dot product is hi.lo, then lo.hi, then hi.hi on the tensor
// cores, summed in f32 (lo.lo, under 2^-22 of it, is dropped): the tensor
// cores cut each k step's sum to f32 toward zero, so only the last pass's
// steps are cut at the dot's full magnitude.  (The two small passes run in
// the other order than fl_gain_tc.cu's, so that B's lo planes, which only
// the first reads, are released first; the two orders round alike.)  The
// last pass's steps alternate between two accumulators, added once at the
// end (round to nearest): each holds about half of the dot and takes half
// of the steps, which halves the bias the cuts leave.  That bias shows where
// the distance is 0 (a row against itself), and only against an absolute
// tolerance.  bf16 inputs widen into TF32 exactly (8 significant bits of
// the 11), lo is 0, and one hi.hi pass gives exact products summed in f32.
// That pass is TF32 wgmma, not bf16 (k16): the bf16 route is bound by its
// output bytes just as the f32 one is (its products are under a tenth of
// the time its writes take at the chip_smoke.py shape), and one layout,
// one prologue and one instruction serve both types.
//
// Layout.  TMA needs 16-byte row strides, which (n, 65) f32 and (n, 130)
// bf16 rows do not have, so the prologue writes the operands into planes of
// 32-byte rows (tf32_tc.cuh): P planes an operand, P = 2 k8 for f32 (hi,
// then lo) and k8 for bf16 (hi), k8 = ceil(d / 8) (for bf16 rounded up to
// an even count, so that half as many depths are instantiated).  One 3-D
// TMA box brings 128 rows of any run of planes in wgmma's K-major layout for
// the 32-byte swizzle.
//
// Design.  Output tiles of 128 x 128; a block runs persistently over a
// contiguous range of the tile list (one block an SM: 214 KB of shared
// memory at d 65).  When a is b (the resident build's only call: route
// "tc-sym") the list holds the tiles I <= J only, in row-major order, so a
// block's range spans one to three row panels I: the panel's 128 rows (A,
// every plane) stay resident, and each column tile J (B) streams in as two
// slots, its lo planes and its hi planes (with its columns' norms).  Warp 8's
// first thread issues the TMA loads ("full" mbarriers count the bytes,
// "empty" ones the eight consumer warps' releases).  Warpgroups 0 and 1 each
// own 64 of the tile's rows (wgmma.m64n128k8, two accumulators of 64 f32 a
// thread); a warpgroup releases B's lo planes after the first pass and its
// hi planes after the last, so the next tile's B loads while it runs the
// rest.  The epilogue adds the norms and clamps at 0, and stages the tile
// in shared memory a quarter (32 columns) at a time, double-buffered, in
// boxes of 32 x 32 f32 with the 128-byte swizzle; the four warps' first
// lanes each write one box out with a TMA store (cp.async.bulk.tensor,
// committed as a bulk group, marked to leave L2 first), which runs while
// the next quarter is staged and the next tile's products run.  Each warp
// computes its values on the path every warp of its warpgroup takes: ptxas
// serializes every wgmma of a kernel whose accumulators are read on a path
// some warps of the group skip (C7520), and a wait between two wgmmas
// does the same.  The block is 288 threads, not 384: nine warps leave ptxas
// the same 168 registers a thread as twelve, and a whole producer
// warpgroup is of no use here.
//
// Symmetry.  On tc-sym each off-diagonal tile is written twice: as itself,
// and transposed through its own staged boxes (the epilogue stages every
// value at [r][c] and at [c][r]) into the tile (J, I).  On a diagonal tile
// the boxes above the diagonal do the same, the boxes below it are not
// written from their own products, and each box on the diagonal is filled
// from its upper half.  Each unordered pair is computed once and written to
// both places, so out == out^T bit for bit by construction.  (Computed
// twice it would not be: (i, j) sums hi_i.lo_j then lo_i.hi_j, (j, i) the
// same two terms in the other order.)  The diagonal itself, a row against
// itself, is all rounding in the expanded form; a last launch
// (sq_diag_kernel) rewrites it with the FFMA kernel's dot.
//
// Output rows whose stride is not a multiple of 16 bytes (m % 4 != 0) TMA
// cannot address: there the warpgroup's threads copy each staged box out
// with plain stores.  Rows and columns past n and m load as zeros and are
// not stored.  Every element's sum runs in one fixed order: the same bits
// run to run.  A stalled barrier wait traps after ~2^34 cycles rather than
// hang.
#include "common.cuh"
#include "mbarrier.cuh"
#include "tf32_tc.cuh"

namespace repro_torch {
namespace {

constexpr int kSqTile = 128;      // output tile rows and columns (wgmma's N)
constexpr int kSqThreads = 288;   // two consumer warpgroups, a producer warp
constexpr int kSqMaxPlanes = 20;  // 32-byte planes an operand, at most
constexpr int kSqMaxK8F32 = 10;   // f32: hi and lo, d <= 80
constexpr int kSqMaxK8Bf16 = 20;  // bf16: hi only, d <= 160
constexpr int kSqPlane = kSqTile * kRowBytes;  // 4 096 bytes
// A staged box: 32 x 32 f32 with the 128-byte swizzle.  A warpgroup stages
// a quarter as two boxes of its rows (N) and two of their transpose (T),
// in two buffers: 2 warpgroups x 2 buffers x 4 boxes.
constexpr int kSqBox = 32;
constexpr int kSqBoxBytes = kSqBox * kSqBox * 4;            // 4 096
constexpr int kSqBufBytes = 4 * kSqBoxBytes;                // 16 384
constexpr int kSqStageBytes = 65536;
static_assert(kSqStageBytes == 2 * 2 * kSqBufBytes, "staged boxes");
constexpr int kSqAlignSlack = 1024;
constexpr int kSqMaxSmem = 232448;
constexpr int kSqStaticSmem = 1088;

struct SqStatic {
  // B's hi planes [0] and, for f32, its lo planes [1], each their own slot
  unsigned long long a_full, a_empty, b_full[2], b_empty[2];
  // B's 128 columns' squared norms, loaded with its hi planes; two tiles'
  // worth, as the epilogue reads them after it has released B
  float bn[2][kSqTile];
};
static_assert(sizeof(SqStatic) <= kSqStaticSmem, "static shared memory");

// Dynamic shared memory of a block: the alignment slack, the staged boxes,
// A's and B's planes.  kernels/sqdist.py: sq_smem mirrors it.
__host__ __device__ constexpr int sq_dynamic_smem(int planes) {
  return kSqAlignSlack + kSqStageBytes + 2 * planes * kSqPlane;
}
static_assert(sq_dynamic_smem(kSqMaxPlanes) + kSqStaticSmem <= kSqMaxSmem,
              "the widest operands fit");

// The prologue: a (n, d) and, unless b is null, b (m, d) into their plane
// layouts (zeros past d).  f32 inputs split into hi and lo; bf16 widen.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_split_kernel(const T* __restrict__ a, int n, const T* __restrict__ b,
                int m, int d, int k8, float* __restrict__ sa,
                float* __restrict__ sb) {
  constexpr bool kLo = sizeof(T) == 4;
  const int width = 8 * k8;
  const int64_t rows = static_cast<int64_t>(n) + (b != nullptr ? m : 0);
  const int64_t total = rows * width;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / width;
    const int k = static_cast<int>(e - r * width);
    const bool in_a = r < n;
    const T* src = in_a ? a : b;
    const int64_t i = in_a ? r : r - n;
    const float x = k < d ? to_f32(src[i * d + k]) : 0.f;
    split_put<kLo>(x, i, k, in_a ? n : m, k8, in_a ? sa : sb);
  }
}

// The tiles of a block's range, in the list's order: row-major over every
// (I, J), or over I <= J when `sym`.
struct TileWalk {
  int I, J, tj;
  bool sym;
  __device__ void start(int64_t f, int ti, int tj_, bool sym_) {
    tj = tj_;
    sym = sym_;
    if (!sym) {
      I = static_cast<int>(f / tj);
      J = static_cast<int>(f - static_cast<int64_t>(I) * tj);
      return;
    }
    I = 0;
    while (f >= ti - I) {
      f -= ti - I;
      ++I;
    }
    J = I + static_cast<int>(f);
  }
  __device__ void next() {
    if (++J == tj) {
      ++I;
      J = sym ? I : 0;
    }
  }
};

// Byte offset of element (row, col) of a staged 32 x 32 f32 box under the
// 128-byte swizzle: 16-byte chunk col / 4 of the row's 128 bytes, xor the
// row's low three bits.
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return static_cast<uint32_t>(row * 128 +
                               ((((col >> 2) ^ (row & 7)) << 4) |
                                ((col & 3) << 2)));
}

__device__ __forceinline__ void st_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_f32x2(uint32_t addr, float v0, float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v0),
               "f"(v1)
               : "memory");
}
__device__ __forceinline__ float ld_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// A staged box out to the (n, m) output at (row0, col0) by TMA, marked to
// leave L2 first (the output is not read again here; the operands are).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int col0,
                                             int row0) {
  asm volatile(
      "{\n .reg .b64 pol;\n"
      " createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      " cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], pol;\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col0), "r"(row0)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// The bulk groups but the newest one have read their shared memory.
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The same box out by the warpgroup's 128 threads (lt), a row of 32
// columns a warp at a time, clipped at (n, m).
__device__ __forceinline__ void copy_box(uint32_t src, int row0, int col0,
                                         int n, int m, int lt,
                                         float* __restrict__ out) {
#pragma unroll
  for (int q = 0; q < kSqBox * kSqBox / 128; ++q) {
    const int e = lt + 128 * q;
    const int r = e >> 5, c = e & 31;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < n && gc < m)
      out[static_cast<int64_t>(gr) * m + gc] = ld_f32(src + sw128(r, c));
  }
}

// How a staged box (rows 32 bi .. of the tile, columns 32 bj ..) leaves:
// 0 not at all, 1 as itself, 2 as itself and transposed, 3 as itself with
// its lower half taken from its upper half (a box on a diagonal tile's
// diagonal).
__device__ __forceinline__ int box_kind(bool sym, bool diag, int bi,
                                        int bj) {
  if (!sym) return 1;
  if (!diag) return 2;
  return bi < bj ? 2 : (bi == bj ? 3 : 0);
}

// The diagonal of sqdist(a, a), where the expanded form is nothing but
// rounding, rewritten after the tiles: each row's dot with itself as the
// FFMA kernel forms it (fmaf over k in order, dot_tile.cuh), so each
// diagonal element is sqdist.cu's bit for bit.  A lazy greedy over the
// similarity weighs each candidate's own term, lm - sqrt(d_jj), which that
// noise moves by up to ~1e-2; from the FFMA kernel it is the FFMA
// kernel's and the plain version's (ties that the off-diagonal's last bits
// decide still part, PERF.md §6).  A thread a row; a launch of its own,
// as the same code in the tiles' epilogue cost them ~5% of their time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_diag_kernel(const T* __restrict__ a, const float* __restrict__ an, int n,
               int d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T* row = a + static_cast<int64_t>(i) * d;
  float acc = 0.f;
  for (int k = 0; k < d; ++k) {
    const float x = to_f32(row[k]);
    acc = fmaf(x, x, acc);
  }
  out[static_cast<int64_t>(i) * n + i] = fmaxf(an[i] + an[i] - 2.f * acc,
                                               0.f);
}

// Block b computes tiles [b T / grid, (b + 1) T / grid) of the list.  K8 (k
// steps a pass) is a template argument: with every wgmma's operands and
// scale known at compile time the products issue back to back.
template <int K8, bool kThree>
__global__ void __launch_bounds__(kSqThreads, 1)
sqdist_tc_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap out_map,
                 const float* __restrict__ an, const float* __restrict__ bn,
                 int n, int m, int ti, int tj, int sym, int tma_store,
                 int64_t tiles, float* __restrict__ out) {
  constexpr int kPlanes = kThree ? 2 * K8 : K8;
  constexpr uint32_t kOpBytes = kPlanes * kSqPlane;
  constexpr uint32_t kHalfBytes = K8 * kSqPlane;  // B's hi (or lo) planes
  __shared__ SqStatic st;
  extern __shared__ uint8_t smem_raw[];
  // Everything starts on a 1 024-byte boundary: the 128-byte swizzle of
  // the staged boxes repeats every 1 024 bytes, the 32-byte one of the
  // planes every 256.
  const uint32_t stage = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_buf = stage + kSqStageBytes;
  const uint32_t b_buf = a_buf + kOpBytes;
  const uint32_t a_full = smem_u32(&st.a_full);
  const uint32_t a_empty = smem_u32(&st.a_empty);
  const uint32_t b_full = smem_u32(&st.b_full[0]);    // + 8: lo
  const uint32_t b_empty = smem_u32(&st.b_empty[0]);
  const int t = threadIdx.x;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * tiles / gridDim.x;
  const int64_t hi =
      static_cast<int64_t>(blockIdx.x + 1) * tiles / gridDim.x;

  if (t == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, 8);
    for (int h = 0; h < 2; ++h) {
      mbar_init(b_full + 8 * h, 1);
      mbar_init(b_empty + 8 * h, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (t >= 256) {
    // Producer warp: its first thread issues every TMA load, A when the
    // row panel changes, B's planes every tile.
    if (t == 256) {
      TileWalk w;
      w.start(lo, ti, tj, sym);
      int cur = -1;
      uint32_t au = 0, bu = 0;
      for (int64_t f = lo; f < hi; ++f, w.next()) {
        if (w.I != cur) {
          // Load u of a buffer waits for the consumers' release of load
          // u - 1 (parity (u - 1) & 1); load 0 passes at once.
          mbar_wait(a_empty, (au & 1) ^ 1);
          mbar_expect_tx(a_full, kOpBytes);
          tma_load_3d(a_buf, &a_map, a_full, 0, w.I * kSqTile, 0);
          ++au;
          cur = w.I;
        }
        // lo first: the first pass reads it, and releases it first
        for (int h = kThree ? 1 : 0; h >= 0; --h) {
          mbar_wait(b_empty + 8 * h, (bu & 1) ^ 1);
          mbar_expect_tx(b_full + 8 * h,
                         kHalfBytes + (h == 0 ? kSqTile * 4 : 0));
          tma_load_3d(b_buf + h * kHalfBytes, &b_map, b_full + 8 * h, 0,
                      w.J * kSqTile, h * K8);
        }
        bulk_load(smem_u32(&st.bn[bu & 1][0]), bn + w.J * kSqTile,
                  kSqTile * 4, b_full);
        ++bu;
      }
    }
    return;
  }

  // Consumer warpgroups: wg owns rows 64 wg .. 64 wg + 63 of every tile.
  const int wg = t >> 7;
  const int lt = t & 127;
  const int warp = (t >> 5) & 3;
  const int lane = t & 31;
  const int tq = lane & 3;
  // This thread's accumulator rows r0 and r0 + 8 of the warpgroup's 64,
  // its columns 8 j + 2 tq (+1), j < 16 (register 4 j + 2 h (+1): row
  // r0 + 8 h, column 8 j + 2 tq (+1)).  Rows 0-31 stage into box 0, rows
  // 32-63 into box 1: warps 0-1 and 2-3.
  const int r0 = warp * 16 + (lane >> 2);
  const int sb = warp >> 1;
  const int rb = r0 - 32 * sb;  // the rows within the box: rb, rb + 8
  const uint32_t my_stage = stage + wg * 2 * kSqBufBytes;
  // This thread's places in its staged boxes (sw128), the same every
  // quarter: in box sb, row rb + 8 h, columns 8 jj + 2 tq (+1): n_off[jj]
  // + 1 024 h; in its transpose, row 8 jj + 2 tq + e, column rb + 8 h:
  // t_off[2 h + e] + 1 024 jj.
  uint32_t n_off[4], t_off[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) n_off[jj] = sw128(rb, 8 * jj + 2 * tq);
#pragma unroll
  for (int he = 0; he < 4; ++he)
    t_off[he] = sw128(2 * tq + (he & 1), rb + 8 * (he >> 1));
  const uint64_t a_desc = sw32_desc(a_buf + wg * 64 * kRowBytes);
  const uint64_t b_desc = sw32_desc(b_buf);
  constexpr uint64_t kP = kSqPlane >> 4;
  float acc[64], acc2[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = acc2[q] = 0.f;

  TileWalk w;
  w.start(lo, ti, tj, sym);
  int cur = -1;
  uint32_t au = 0, bu = 0, u = 0;
  for (int64_t f = lo; f < hi; ++f) {
    const int I = w.I, J = w.J;
    w.next();
    const bool new_panel_next = f + 1 < hi && w.I != I;
    const int row0 = I * kSqTile + 64 * wg;   // this warpgroup's rows
    const int col0 = J * kSqTile;
    // The two rows' norms, read before the waits so their latency hides
    // under them.  A row past n is 0 and is not stored.
    float rn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + r0 + 8 * h;
      rn[h] = i < n ? an[i] : 0.f;
    }
    if (I != cur) {
      mbar_wait(a_full, au & 1);
      ++au;
      cur = I;
    }
    // Both of B's slots before the products: a wait between them would put
    // a divergent path (the wait's loop) among the wgmmas, which ptxas
    // then serializes.
    if constexpr (kThree) mbar_wait(b_full + 8, bu & 1);
    mbar_wait(b_full, bu & 1);
#pragma unroll
    for (int q = 0; q < 64; ++q) {
      hold(acc[q]);
      hold(acc2[q]);
    }
    wgmma_fence();
    if constexpr (kThree) {
#pragma unroll
      for (int c = 0; c < K8; ++c)  // hi . lo, from 0
        wgmma_tf32(acc, a_desc + c * kP, b_desc + (K8 + c) * kP, c > 0);
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < K8; ++c)  // + lo . hi
        wgmma_tf32(acc, a_desc + (K8 + c) * kP, b_desc + c * kP, 1);
#pragma unroll
      for (int c = 0; c < K8; ++c) {  // + hi . hi, even steps and odd ones
        if (c % 2 == 0)
          wgmma_tf32(acc, a_desc + c * kP, b_desc + c * kP, 1);
        else
          wgmma_tf32(acc2, a_desc + c * kP, b_desc + c * kP, c > 1);
      }
    } else {
#pragma unroll
      for (int c = 0; c < K8; ++c) {  // hi . hi, even steps and odd ones
        if (c % 2 == 0)
          wgmma_tf32(acc, a_desc + c * kP, b_desc + c * kP, c > 0);
        else
          wgmma_tf32(acc2, a_desc + c * kP, b_desc + c * kP, c > 1);
      }
    }
    wgmma_commit();
    ++bu;
    if constexpr (kThree) {
      // The first pass is done with B's lo planes: the next tile's load
      // while the other two passes run.
      wgmma_wait_1();
      __syncwarp();
      if (lane == 0) mbar_arrive(b_empty + 8);
    }
    wgmma_wait_all();
#pragma unroll
    for (int q = 0; q < 64; ++q) {
      hold(acc[q]);
      hold(acc2[q]);
    }
    // This warp is done with B's hi planes, and with A when the next
    // tile's panel is another.
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(b_empty);
      if (new_panel_next) mbar_arrive(a_empty);
    }
    if constexpr (K8 > 1) {
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[q] += acc2[q];
    }

    // The epilogue, a quarter of 32 columns at a time.
    const bool diag = sym && I == J;
    const float* cnorm = st.bn[(bu - 1) & 1];
#pragma unroll
    for (int qc = 0; qc < 4; ++qc, ++u) {
      const uint32_t buf = my_stage + (u & 1) * kSqBufBytes;
      const int kind = box_kind(sym, diag, 2 * wg + sb, qc);
      // The quarter's values, computed on every warp of the warpgroup: the
      // accumulators read on a path some warps skip (the stores below
      // branch by warp) would make ptxas fence every wgmma.
      float v[16];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * qc + jj;
        const float2 c2 =
            *reinterpret_cast<const float2*>(&cnorm[8 * j + 2 * tq]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[4 * jj + 2 * h] =
              fmaxf(rn[h] + c2.x - 2.f * acc[4 * j + 2 * h], 0.f);
          v[4 * jj + 2 * h + 1] =
              fmaxf(rn[h] + c2.y - 2.f * acc[4 * j + 2 * h + 1], 0.f);
          hold(v[4 * jj + 2 * h]);
          hold(v[4 * jj + 2 * h + 1]);
        }
      }
      // The bulk groups that last read this buffer (two quarters back)
      // are done before anyone writes it again.
      if (lane == 0) bulk_wait_read_1();
      named_sync(2 + wg, 128);
      const uint32_t nbox = buf + sb * kSqBoxBytes;
      const uint32_t tbox = buf + (2 + sb) * kSqBoxBytes;
      if (kind == 1 || kind == 2) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            st_f32x2(nbox + n_off[jj] + 1024 * h, v[4 * jj + 2 * h],
                     v[4 * jj + 2 * h + 1]);
      }
      if (kind == 2) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int he = 0; he < 4; ++he)
            st_f32(tbox + t_off[he] + 1024 * jj, v[4 * jj + he]);
      }
      if (kind == 3) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int he = 0; he < 4; ++he) {
            const int rr = rb + 8 * (he >> 1);
            const int cc = 8 * jj + 2 * tq + (he & 1);
            if (rr <= cc) st_f32(nbox + sw128(rr, cc), v[4 * jj + he]);
            if (rr < cc) st_f32(nbox + sw128(cc, rr), v[4 * jj + he]);
          }
      }
      fence_async_shared();
      named_sync(2 + wg, 128);
      // Box s: rows row0 + 32 s .. of columns col0 + 32 qc ..; its
      // transpose: rows col0 + 32 qc .. of columns row0 + 32 s ...  The
      // four boxes leave by the first lanes of the four warps, one each.
      const int ccol = col0 + 32 * qc;
      if (tma_store) {
        if (lane == 0) {
          const int s = warp & 1;
          const int k = box_kind(sym, diag, 2 * wg + s, qc);
          const int rs = row0 + 32 * s;
          if (rs < n && ccol < m) {
            if (warp < 2 && k != 0)
              tma_store_2d(&out_map, buf + s * kSqBoxBytes, ccol, rs);
            if (warp >= 2 && k == 2)
              tma_store_2d(&out_map, buf + (2 + s) * kSqBoxBytes, rs, ccol);
          }
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int k = box_kind(sym, diag, 2 * wg + s, qc);
          const int rs = row0 + 32 * s;
          if (k != 0)
            copy_box(buf + s * kSqBoxBytes, rs, ccol, n, m, lt, out);
          if (k == 2)
            copy_box(buf + (2 + s) * kSqBoxBytes, ccol, rs, n, m, lt, out);
        }
      }
    }
  }
  if (tma_store && lane == 0) bulk_wait_all();
}

struct SqArgs {
  const float* an;
  const float* bn;
  int n, m, ti, tj, sym, tma_store, grid, smem;
  int64_t tiles;
  float* out;
};

// The kernel instantiation for depth k8, launched: f32 (kThree) k8 1 ..
// kSqMaxK8F32, bf16 k8 2, 4, .. kSqMaxK8Bf16.
template <bool kThree, int K8 = (kThree ? 1 : 2)>
cudaError_t launch_sq(int k8, const CUtensorMap& a_map,
                      const CUtensorMap& b_map, const CUtensorMap& out_map,
                      const SqArgs& a, cudaStream_t s) {
  constexpr int kStep = kThree ? 1 : 2;
  constexpr int kMax = kThree ? kSqMaxK8F32 : kSqMaxK8Bf16;
  if constexpr (K8 + kStep <= kMax) {
    if (k8 != K8)
      return launch_sq<kThree, K8 + kStep>(k8, a_map, b_map, out_map, a, s);
  } else {
    if (k8 != K8) return cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      sqdist_tc_kernel<K8, kThree>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return e;
  sqdist_tc_kernel<K8, kThree><<<a.grid, kSqThreads, a.smem, s>>>(
      a_map, b_map, out_map, a.an, a.bn, a.n, a.m, a.ti, a.tj, a.sym,
      a.tma_store, a.tiles, a.out);
  return cudaGetLastError();
}

// A 2-D map of the (n, m) f32 output, written in boxes of 32 x 32 with the
// 128-byte swizzle; elements past (n, m) are not written.
cudaError_t make_out_map(CUtensorMap* map, float* out, int n, int m) {
  EncodeTiledFn encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m) * 4};
  const cuuint32_t box[2] = {kSqBox, kSqBox};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// a (n, d), b (m, d) row-major, both float32 (dtype 0) or both bfloat16
// (dtype 1); an, bn: the f32 squared row norms, in buffers of whole tiles
// (ceil(n / 128) 128 and ceil(m / 128) 128 floats, 16-byte aligned: a
// tile's 128 load at once; the tail is never stored); sym: a and b are the
// same rows (n == m), and only tiles I <= J are computed, each written to
// both places; k8: k steps a pass (f32: ceil(d / 8) <= 10; bf16: the even
// count of 2 .. 20 that first reaches d / 8); grid: blocks, at most the
// tiles; split: P (n + m) 8 f32 of scratch (P (n) 8 when sym; P = 2 k8
// for f32, k8 for bf16), 16-byte aligned; out (n, m) f32; all on the
// device.  Returns cudaErrorInvalidValue for arguments the kernel has no
// form for (or a tensor map the driver refuses), else cudaGetLastError()
// after the launches (the prologue, the tiles and, when sym, the
// diagonal).
int rt_sqdist_tc(int device, const void* a, const void* b, int dtype,
                 const float* an, const float* bn, int64_t n, int64_t m,
                 int64_t d, int k8, int sym, int grid, float* split,
                 float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0;
  const int planes = f32 ? 2 * k8 : k8;
  const bool depth_ok =
      f32 ? (k8 >= 1 && k8 <= kSqMaxK8F32 && 8 * (k8 - 1) < d)
          : (dtype == 1 && k8 >= 2 && k8 <= kSqMaxK8Bf16 && k8 % 2 == 0 &&
             8 * (k8 - 2) < d);
  const int64_t ti = (n + kSqTile - 1) / kSqTile;
  const int64_t tj = (m + kSqTile - 1) / kSqTile;
  const int64_t tiles = sym ? ti * (ti + 1) / 2 : ti * tj;
  if (n < 1 || m < 1 || d < 1 || !depth_ok || 8 * k8 < d ||
      n >= (int64_t{1} << 31) || m >= (int64_t{1} << 31) ||
      (sym && (n != m || a != b)) || grid < 1 || grid > tiles ||
      reinterpret_cast<uintptr_t>(split) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bn) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ni = static_cast<int>(n), mi = static_cast<int>(m);
  float* sa = split;
  float* sb = sym ? split : split + static_cast<int64_t>(planes) * 8 * n;
  CUtensorMap a_map, b_map, out_map;
  e = make_split_map(&a_map, sa, ni, planes, kSqTile);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = make_split_map(&b_map, sb, mi, planes, kSqTile, k8);
  if (e != cudaSuccess) return static_cast<int>(e);
  // TMA addresses rows whose stride is a multiple of 16 bytes.
  const int tma_store = m % 4 == 0;
  if (tma_store) {
    e = make_out_map(&out_map, out, ni, mi);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    out_map = CUtensorMap{};
  }
  const int64_t work = (n + (sym ? 0 : m)) * 8 * k8;
  const int64_t split_blocks = (work + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(
      split_blocks < kMaxBlocks ? split_blocks : kMaxBlocks);
  if (f32)
    sq_split_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), ni,
        sym ? nullptr : static_cast<const float*>(b), mi,
        static_cast<int>(d), k8, sa, sb);
  else
    sq_split_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), ni,
        sym ? nullptr : static_cast<const __nv_bfloat16*>(b), mi,
        static_cast<int>(d), k8, sa, sb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const SqArgs args{an, bn, ni, mi, static_cast<int>(ti),
                    static_cast<int>(tj), sym, tma_store, grid,
                    sq_dynamic_smem(planes), tiles, out};
  e = f32 ? launch_sq<true>(k8, a_map, b_map, out_map, args, s)
          : launch_sq<false>(k8, a_map, b_map, out_map, args, s);
  if (e != cudaSuccess || !sym) return static_cast<int>(e);
  const unsigned diag_blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                     kThreads);
  if (f32)
    sq_diag_kernel<float><<<diag_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), an, ni, static_cast<int>(d), out);
  else
    sq_diag_kernel<__nv_bfloat16><<<diag_blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), an, ni, static_cast<int>(d),
        out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
