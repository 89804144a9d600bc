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
// corr_argmax launches the argmax's row tiles at B = 1 (kernels/corr.py:
// corr_argmax_plan) for the pools they suit.
// Column b of corr_batched equals rt_corr(g, v[b]), and problem b's (index,
// value) equals rt_corr_argmax on its slice, bit for bit: each dot product
// is summed in row_dot's order (csrc/common.cuh), 16-byte or scalar as
// rt_corr would take it for the same tensor.
//
// What bounds them on an H100.  At the main path's (45 000, 65) pool and
// B = 10 the work is 2 n d B = 58.5 MFLOP, 0.87 us of FFMA at 67 TFLOP/s,
// against 11.7 MB of pool (3.5 us at 3.35 TB/s; less when it stays in the
// 50 MB L2 between OMP rounds), and a launch costs ~6 us in the timing of
// chip_smoke.py: bytes and launch latency.  For a large batch, the
// exactness: replaying a warp's lane order costs 65 fmaf and 31 additions
// a (row, problem) pair at d = 65 where a reassociating product takes 65,
// and every vector element must reach every thread that holds a row.  No
// tensor cores: wgmma's f32 sums round in the tensor cores' order, and the
// bit-equality with the single kernels would be lost.
//
// Two routes; the wrapper's launch plan (kernels/corr.py: batched_plan)
// picks one from the shapes and passes its tile, groups, ring and grid.
// This file owns the row tiles' shared-memory layout (RowLayout) and the
// constants it rests on (kRowThreads, kRowMaxD, kMaxSmem, kKeyStride);
// the plan mirrors them only to decide what fits, and a launch whose
// layout does not fit is refused here:
//
// 1. Row tiles (a shared pool with 1 <= d <= 96, the main path's case):
//    one thread a row, or two.  Tiles of 32-128 consecutive rows are one
//    contiguous span of the row-major pool: thread 0 loads each into a
//    shared-memory slot with one cp.async.bulk (its 16-byte-aligned
//    middle, counted on the slot's mbarrier; the < 16-byte head and tail
//    by plain loads), so the tile's bytes cost the threads no
//    instructions.  A block of one tile takes one slot; a persistent wave
//    of blocks walking several tiles takes a ring of two.  Each thread
//    moves its rows into registers and replays the 32 lanes of row_dot
//    for every problem it scores (Replay): no shuffles, no idle lanes at
//    d = 65.  The B problem vectors sit in shared memory in the order the
//    replay reads them, each read a 16-byte broadcast to the warp; those
//    reads set the pace of a large batch, so there a thread holds two
//    rows and each read serves both.  corr_batched stages a tile's (rows,
//    B) outputs in shared memory and stores them as one contiguous span.
//    corr_argmax_batched reads a row's mask bytes first and scores only
//    its live (row, problem) pairs: with per-class selection's one-hot
//    class masks that is one dot product a row, not B.
// 2. Warps (a per-problem (B, n, p) matrix, d > 96, or a batch whose
//    vectors and keys do not fit in shared memory): one warp a row, as
//    rt_corr, each lane one accumulator per problem of a chunk of <= 32,
//    the problems' 32 lane sums folded by a transposed butterfly that
//    pairs every addition as warp_sum does.
//
// The argmax never writes the (n, B) scores: a score packs with its row
// into a 64-bit key (pack_key: the highest score, then the lowest row), a
// block folds its keys per problem in shared memory, and one atomicMax a
// (block, problem) folds the blocks into the key words of a workspace,
// skipped where the word is already higher.  The last block to finish (a
// completion counter behind __threadfence) decodes them into idx / val and
// returns the keys and the counter to 0: one device operation a call,
// where a memset, the kernel and a decode launch were three.  The wrapper
// keeps the workspace per (device, stream) and zeroes it once, when it
// makes it, so a captured CUDA graph of OMP rounds can replay the call as
// it is.
//
// Masked pairs: the single kernel folds pack_key(-inf, i) for every masked
// row i.  Those keys are all at most pack_key(-inf, 0); where row 0 is
// masked that bound is one of them, and where it is live its own key is
// at least the bound.  So the fold over every row equals max(fold over
// the live rows, pack_key(-inf, 0)): the row tiles skip masked pairs and
// the decode takes that max, which also gives an all-masked problem
// (0, -inf) and keeps the lowest row overall on a live score of -inf.
#include <stdint.h>

#include <climits>
#include <type_traits>
#include <utility>

#include "common.cuh"
#include "mbarrier.cuh"

namespace repro_torch {
namespace {

// Problem b's key word in the workspace: one 128-byte line each, so the
// blocks' atomics on different problems do not queue on one line.
constexpr int kKeyStride = 16;

// Fold a block's key for problem b into the workspace: an atomicMax only
// where the word (which only grows) is not already above it, so the
// blocks that finish late mostly skip theirs.
__device__ __forceinline__ void fold_key(unsigned long long* keys, int64_t b,
                                         unsigned long long k) {
  unsigned long long* word = keys + kKeyStride * b;
  if (k > *reinterpret_cast<volatile unsigned long long*>(word))
    atomicMax(word, k);
}

// The block's last act in corr_argmax_batched: count it finished; the last
// block of the grid decodes every problem's folded key into idx / val
// (max'd with pack_key(-inf, 0), above) and returns the key words and the
// counter (the word after them) to 0 for the next call.  The caller's
// atomicMax'es are behind a __threadfence().
__device__ __forceinline__ void finish_argmax(unsigned long long* keys,
                                              int64_t B, int* idx, float* val,
                                              unsigned int* last) {
  unsigned int* done = reinterpret_cast<unsigned int*>(keys + kKeyStride * B);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const unsigned long long floor = pack_key(-INFINITY, 0);
  for (int64_t b = threadIdx.x; b < B; b += blockDim.x) {
    unsigned long long k = atomicExch(keys + kKeyStride * b, 0ull);
    k = k > floor ? k : floor;
    unsigned int u = static_cast<unsigned int>(k >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    idx[b] = static_cast<int>(~static_cast<unsigned int>(k & 0xffffffffull));
    val[b] = __uint_as_float(u);
  }
  if (threadIdx.x == 0) atomicExch(done, 0u);
}

// ---------------------------------------------------------------------------
// The row-tile route: one thread a row.
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 128;  // threads a block
constexpr int kRowMaxD = 96;      // widest row a thread keeps in registers
constexpr int kMaxStages = 4;
constexpr int64_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

__host__ __device__ constexpr int64_t align128(int64_t x) {
  return (x + 127) & ~int64_t{127};
}

// Shared memory of a row-tile block, in bytes from the dynamic base, for
// tiles of `rows` rows (kernels/corr.py: rows_smem mirrors the total for
// the plan's fit decision):
//   [0, 128)  the slots' "full" mbarriers (tile bytes landed), their
//             "empty" ones (every thread has its row) and the last-block
//             flag;
//   v         the B problem vectors, 32 ceil(d / 32) + 12 floats each in
//             the order's layout (Replay);
//   keys      corr_argmax_batched: B x 128 running keys, one per (problem,
//             thread); corr_batched: the tile's (rows, B) outputs at a row
//             stride of B | 1 floats (odd: a warp's stores hit 32 banks);
//   slots     `stages` ring slots of one tile each: rows x d f32 and 16
//             bytes for the tile's offset from a 16-byte boundary.
struct RowLayout {
  int64_t v, keys, slot, slot_bytes, total;
  __host__ __device__ RowLayout(int64_t d, int64_t B, int64_t rows,
                                int64_t stages, bool argmax) {
    const int64_t vs = 32 * ((d + 31) / 32) + 12;
    v = 128;
    keys = align128(v + B * vs * 4);
    slot = align128(keys + (argmax ? B * kRowThreads * 8
                                   : rows * (B | 1) * 4));
    slot_bytes = align128(rows * d * 4 + 16);
    total = slot + stages * slot_bytes;
  }
};

__host__ __device__ constexpr int rev5(int l) {
  return ((l & 1) << 4) | ((l & 2) << 2) | (l & 4) | ((l & 8) >> 2) |
         ((l & 16) >> 4);
}

template <typename F, int... I>
__device__ __forceinline__ void unroll_seq(F& f,
                                           std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// f(integral_constant<0>), ..., f(integral_constant<N - 1>): every index a
// compile-time constant, so register arrays stay in registers.
template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_seq(f, std::make_integer_sequence<int, N>{});
}

// One thread's NR rows dotted with one problem vector, in row_dot's order
// (csrc/common.cuh): the 32 lane sums of the warp that rt_corr gives a
// row, each the same fmaf chain, then warp_sum's butterfly as a serial
// tree.  After the butterfly's step at xor offset `off` lane l holds
// x_l + x_(l^off); for l < off that is the pair F(l, off) = F(l, 2 off) +
// F(l + off, 2 off) below, with F(l, 32) = lane l's sum, and IEEE addition
// is commutative: every addition rounds the same two operands, so the
// result is rt_corr's bit for bit.  The tree walks the lanes in
// bit-reversed order (0, 16, 8, 24, ...), so ~6 partial sums a row are
// live rather than 32.  Each vector element read from shared memory
// serves the thread's NR rows: those reads, more than the arithmetic, set
// the pace.
//
// Rows of d elements, 32 (KC - 1) < d <= 32 (KC - 1) + LAST, LAST 1 (the
// main path's d = 65 = 64 + 1: 65 registers a row, not 96) or 32.  r holds
// the rows, v points at the problem's vector in shared memory:
//   scalar order (VEC false): lane l chains j = l, l + 32, ... < d.  The
//     vector is stored in walk order, lane rev5(p)'s elements of the kCols
//     columns before a one-element last column at slots p kCols ..
//     p kCols + kCols - 1, so four lanes' elements are kCols float4 reads;
//     with LAST = 1 that last element (lane 0's) sits after them;
//   16-byte order (VEC, d % 4 == 0 and the pool 16-byte aligned): lane l
//     chains elements 4l .. 4l + 3 (d <= 96 gives each lane at most one
//     group, and row_dot no tail).  The vector is stored as it is.
template <int KC, int LAST, bool VEC, int NR>
struct Replay {
  static constexpr int kCols = LAST == 1 ? KC - 1 : KC;  // walk columns
  static constexpr int kSlots = 32 * KC;  // a row's registers (some unused)
  struct Sums {
    float x[NR];
  };
  const float (&r)[NR][kSlots];
  const float* v;
  int d;
  float4 buf[KC];

  template <int L>
  __device__ __forceinline__ Sums leaf() {
    Sums acc{};
    if constexpr (VEC) {
      // Lanes below 8 (KC - 1) always hold a group: d > 32 (KC - 1).
      if constexpr (L < 8 * KC) {
        if (L < 8 * (KC - 1) || 4 * L < d) {
          const float4 q = reinterpret_cast<const float4*>(v)[L];
#pragma unroll
          for (int n = 0; n < NR; ++n) {
            acc.x[n] = fmaf(r[n][4 * L + 0], q.x, acc.x[n]);
            acc.x[n] = fmaf(r[n][4 * L + 1], q.y, acc.x[n]);
            acc.x[n] = fmaf(r[n][4 * L + 2], q.z, acc.x[n]);
            acc.x[n] = fmaf(r[n][4 * L + 3], q.w, acc.x[n]);
          }
        }
      }
    } else {
      constexpr int P = rev5(L);
      if constexpr (P % 4 == 0) {
        unroll<kCols>([&](auto c) {
          constexpr int C = decltype(c)::value;
          buf[C] = reinterpret_cast<const float4*>(v)[P / 4 * kCols + C];
        });
      }
      unroll<kCols>([&](auto c) {
        constexpr int C = decltype(c)::value;
        constexpr int s = (P % 4) * kCols + C;
        const float vj = reinterpret_cast<const float*>(&buf[s / 4])[s % 4];
        if (LAST == 1 || C < KC - 1 || L + 32 * C < d) {
#pragma unroll
          for (int n = 0; n < NR; ++n)
            acc.x[n] = fmaf(r[n][L + 32 * C], vj, acc.x[n]);
        }
      });
      if constexpr (LAST == 1 && L == 0) {  // element 32 (KC - 1), last
        const float vj = v[32 * kCols];
#pragma unroll
        for (int n = 0; n < NR; ++n)
          acc.x[n] = fmaf(r[n][32 * (KC - 1)], vj, acc.x[n]);
      }
    }
    return acc;
  }

  template <int L, int OFF>
  __device__ __forceinline__ Sums tree() {
    if constexpr (OFF == 32) {
      return leaf<L>();
    } else {
      const Sums a = tree<L, 2 * OFF>();
      const Sums b = tree<L + OFF, 2 * OFF>();
      Sums s;
#pragma unroll
      for (int n = 0; n < NR; ++n) s.x[n] = a.x[n] + b.x[n];
      return s;
    }
  }

  __device__ __forceinline__ Sums dot() { return tree<0, 1>(); }
};

// The problem vector element held at slot s of the layout above (scalar
// order: walk order; 16-byte order: as it is), or -1 for a slot of zeros.
template <int KC, int LAST, bool VEC>
__device__ __forceinline__ int vec_element(int s) {
  constexpr int kCols = Replay<KC, LAST, VEC, 1>::kCols;
  if constexpr (VEC) return s < 32 * KC ? s : -1;
  if (s < 32 * kCols) return rev5(s / kCols) + 32 * (s % kCols);
  return LAST == 1 && s == 32 * kCols ? 32 * (KC - 1) : -1;
}

// Byte offset of a tile's first element from the 16-byte boundary below
// it; the tile sits that far into its ring slot, so the slot and device
// memory agree modulo 16 and the bulk copy's ends are 16-byte aligned.
__device__ __forceinline__ int tile_phase(const float* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Thread 0 starts loading tile `tile` (rows R tile .. R tile + R - 1 of
// the pool) into ring slot `slot`: the 16-byte-aligned middle by one bulk
// copy, counted on `bar`, and the head before it and the tail after it
// (< 16 bytes each) by plain loads.  (kernels/corr.py: tile_spans.)
__device__ __forceinline__ void start_tile(const float* mat, int64_t n,
                                           int d, int R, int64_t tile,
                                           unsigned char* slot,
                                           uint32_t bar) {
  const int64_t r0 = tile * R;
  const int64_t rows = n - r0 < R ? n - r0 : R;
  const float* src = mat + r0 * d;
  const int phase = tile_phase(src);
  float* dst = reinterpret_cast<float*>(slot + phase);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = a + static_cast<uintptr_t>(rows * d) * 4;
  uintptr_t a16 = (a + 15) & ~uintptr_t{15};
  a16 = a16 < e ? a16 : e;
  uintptr_t e16 = e & ~uintptr_t{15};
  e16 = e16 > a16 ? e16 : a16;
  for (uintptr_t p = a; p < a16; p += 4)
    dst[(p - a) / 4] = *reinterpret_cast<const float*>(p);
  for (uintptr_t p = e16; p < e; p += 4)
    dst[(p - a) / 4] = *reinterpret_cast<const float*>(p);
  const uint32_t bytes = static_cast<uint32_t>(e16 - a16);
  mbar_expect_tx(bar, bytes);
  if (bytes > 0)
    bulk_load(smem_u32(slot + phase + (a16 - a)),
              reinterpret_cast<const void*>(a16), bytes, bar);
}

// A row from its tile slot into registers (0 past d, and for a row past
// the pool's last).
template <int KC, int LAST, bool VEC>
__device__ __forceinline__ void load_row(float (&r)[32 * KC],
                                         const float* row, int d, bool in) {
  constexpr int kLen = 32 * (KC - 1) + LAST;  // the slots a row uses
  if (!in) {
#pragma unroll
    for (int j = 0; j < kLen; ++j) r[j] = 0.f;
    return;
  }
  if constexpr (VEC) {  // the row starts on a 16-byte boundary
#pragma unroll
    for (int q = 0; q < kLen / 4; ++q) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < 8 * (KC - 1) || 4 * q < d)
        x = reinterpret_cast<const float4*>(row)[q];
      r[4 * q] = x.x;
      r[4 * q + 1] = x.y;
      r[4 * q + 2] = x.z;
      r[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLen; ++j)
      r[j] = (LAST == 1 || j < 32 * (KC - 1) || j < d) ? row[j] : 0.f;
  }
}

struct RowArgs {
  const float* mat;          // (n, d) shared pool
  const float* v;            // (B, d) problem vectors
  int64_t n;
  int d, B;
  int rows;                  // rows a tile: 128 NR / groups
  int groups;                // problem groups: threads sharing a row's B
  int stages;
  float* out;                // corr_batched: (n, B)
  const float* base;         // corr_argmax_batched: (n, B)
  const uint8_t* mask;       // corr_argmax_batched: (n, B)
  int absolute;
  unsigned long long* keys;  // corr_argmax_batched: the workspace
  int* idx;
  float* val;
};

// Problem b's mask bit for row i among this thread's problems of a chunk
// of 32 from c0: those with b % G == g.
__device__ __forceinline__ uint32_t live_bits(const uint8_t* mask, int64_t i,
                                              int B, int c0, int G, int g) {
  const int nb = B - c0 < 32 ? B - c0 : 32;
  const uint8_t* mk = mask + i * B + c0;
  uint32_t m = 0;
  for (int q = g; q < nb; q += G) m |= static_cast<uint32_t>(mk[q] != 0) << q;
  return m;
}

// A tile of R = 128 NR / G rows is scored by G groups of 128 / G threads,
// thread t holding rows t % (128 / G) + n 128 / G (n < NR) and the
// problems b % G == t / (128 / G): a warp is 32 rows (or 2 x 32) of one
// group, so the vectors it reads are the same for every thread.  The
// wrapper picks G and NR (kernels/corr.py: row_split).
//
// Argmax: a warp scores a problem for all its rows at once (each vector
// read one broadcast) while the problems some row of the warp is live for
// are at most twice the most any one thread's rows are live for; else each
// thread walks its own live problems (reads of different vectors then
// conflict in the banks, but with per-class selection's one-hot class
// masks a row has one dot product, not B).
template <int KC, int LAST, bool VEC, int NR, bool ARGMAX>
__global__ void __launch_bounds__(kRowThreads, NR == 1 ? 4 : 3)
row_tiles_kernel(const RowArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int T = kRowThreads;
  constexpr int kVs = 32 * KC + 12;  // odd in 16-byte units: spread banks
  using Rp = Replay<KC, LAST, VEC, NR>;
  const int t = threadIdx.x;
  const int d = a.d, B = a.B, R = a.rows, ST = a.stages, G = a.groups;
  const int P = T / G, g = t / P, u = t % P;
  const RowLayout lay(d, B, R, ST, ARGMAX);
  float* vs = reinterpret_cast<float*>(smem + lay.v);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + lay.keys);
  float* staging = reinterpret_cast<float*>(smem + lay.keys);
  unsigned int* last = reinterpret_cast<unsigned int*>(smem + 64);
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 32;
  const int64_t tiles = (a.n + R - 1) / R;
  const int64_t grid = gridDim.x;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / grid + 1 : 0;
  int rowof[NR];  // this thread's rows within a tile
#pragma unroll
  for (int n = 0; n < NR; ++n) rowof[n] = u + n * P;
  // A tile's first chunk of mask bits and first live base value a row,
  // read before the tile's wait (the first tile's before the set-up), so
  // their latency hides under the bulk copy's.
  uint32_t m0[NR];
  float bv0[NR];
  auto prefetch = [&](int64_t r0, int rows) {
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      m0[n] = 0;
      bv0[n] = 0.f;
      if constexpr (ARGMAX) {
        if (rowof[n] < rows) {
          const int64_t i = r0 + rowof[n];
          m0[n] = live_bits(a.mask, i, B, 0, G, g);
          if (m0[n]) bv0[n] = a.base[i * B + __ffs(m0[n]) - 1];
        }
      }
    }
  };
  const auto tile_rows_of = [&](int64_t r0) {
    return static_cast<int>(a.n - r0 < R ? a.n - r0 : R);
  };
  if (mine > 0) prefetch(blockIdx.x * static_cast<int64_t>(R),
                         tile_rows_of(blockIdx.x * static_cast<int64_t>(R)));

  if (t == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, T);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int64_t k = 0; k < mine && k < ST; ++k)
      start_tile(a.mat, a.n, d, R, blockIdx.x + k * grid,
                 smem + lay.slot + k * lay.slot_bytes, full0 + 8 * k);
  }
  // Unrolled, so a thread's loads of the vectors are in flight together.
#pragma unroll 8
  for (int e = t; e < B * kVs; e += T) {
    const int b = e / kVs, j = vec_element<KC, LAST, VEC>(e % kVs);
    vs[e] = j >= 0 && j < d ? __ldg(a.v + static_cast<int64_t>(b) * d + j)
                            : 0.f;
  }
  if constexpr (ARGMAX) {
    for (int e = t; e < B * T; e += T) keys[e] = 0ull;
  }
  __syncthreads();

  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % ST);
    const int64_t tile = blockIdx.x + k * grid;
    const int64_t r0 = tile * R;
    const int rows = tile_rows_of(r0);
    int64_t i[NR];
    bool in[NR];
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      in[n] = rowof[n] < rows;
      i[n] = r0 + rowof[n];
    }
    if (k > 0) prefetch(r0, rows);
    unsigned char* slot = smem + lay.slot + s * lay.slot_bytes;
    const float* tile_rows = reinterpret_cast<const float*>(
        slot + tile_phase(a.mat + r0 * d));
    const uint32_t use = static_cast<uint32_t>((k / ST) & 1);
    mbar_wait(full0 + 8 * s, use);
    float r[NR][Rp::kSlots];
#pragma unroll
    for (int n = 0; n < NR; ++n)
      load_row<KC, LAST, VEC>(r[n], tile_rows + rowof[n] * d, d, in[n]);
    // Every thread holds its rows: once all have said so, thread 0 fills
    // the slot with the tile ST further on.  The proxy fence orders this
    // thread's reads of the slot before the bulk copy's writes (the async
    // proxy), which a barrier alone does not: 16-byte row reads that queue
    // in the banks could still be pending when a refill lands.  Thread 0's
    // plain head and tail stores reach the readers through the full
    // barrier.
    if (k + ST < mine) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(empty0 + 8 * s);
      if (t == 0) {
        mbar_wait(empty0 + 8 * s, use);
        start_tile(a.mat, a.n, d, R, tile + ST * grid, slot, full0 + 8 * s);
      }
    }

    if constexpr (ARGMAX) {
      for (int c0 = 0; c0 < B; c0 += 32) {
        uint32_t m[NR], own = 0;
#pragma unroll
        for (int n = 0; n < NR; ++n) {
          m[n] = c0 == 0 ? m0[n]
                         : (in[n] ? live_bits(a.mask, i[n], B, c0, G, g)
                                  : 0u);
          own |= m[n];
        }
        const uint32_t any = __reduce_or_sync(0xffffffffu, own);
        const uint32_t most = __reduce_max_sync(
            0xffffffffu, static_cast<uint32_t>(__popc(own)));
        uint32_t todo =
            static_cast<uint32_t>(__popc(any)) <= 2 * most ? any : own;
        while (__any_sync(0xffffffffu, todo != 0)) {
          if (todo) {
            const int q = __ffs(todo) - 1;
            todo &= todo - 1;
            const int b = c0 + q;
            float bv[NR];
#pragma unroll
            for (int n = 0; n < NR; ++n) {
              const bool first = c0 == 0 && q == __ffs(m0[n]) - 1;
              bv[n] = first ? bv0[n]
                            : (((m[n] >> q) & 1u) ? a.base[i[n] * B + b]
                                                  : 0.f);
            }
            Rp rp{r, vs + b * kVs, d};
            const typename Rp::Sums dots = rp.dot();
            unsigned long long* held = keys + b * T + t;
#pragma unroll
            for (int n = 0; n < NR; ++n) {
              if ((m[n] >> q) & 1u) {
                float sc = bv[n] - dots.x[n];
                if (a.absolute) sc = fabsf(sc);
                const unsigned long long key = pack_key(sc, i[n]);
                if (key > *held) *held = key;
              }
            }
          }
        }
      }
    } else {
      const int sb = B | 1;
      __syncthreads();  // the last tile's outputs have left the staging
      for (int b = g; b < B; b += G) {
        Rp rp{r, vs + b * kVs, d};
        const typename Rp::Sums dots = rp.dot();
#pragma unroll
        for (int n = 0; n < NR; ++n) staging[rowof[n] * sb + b] = dots.x[n];
      }
      __syncthreads();
      // The tile's rows x B outputs are one contiguous span of out:
      // consecutive threads store consecutive floats.
      float* o = a.out + r0 * B;
      const int64_t span = static_cast<int64_t>(rows) * B;
      int row = t / B, col = t % B;
      const int drow = T / B, dcol = T % B;
      for (int64_t e = t; e < span; e += T) {
        o[e] = staging[row * sb + col];
        row += drow;
        col += dcol;
        if (col >= B) {
          col -= B;
          ++row;
        }
      }
    }
  }

  if constexpr (ARGMAX) {
    __syncthreads();
    const int lane = t & 31;
    for (int b = t >> 5; b < B; b += T / 32) {
      unsigned long long k = 0ull;
      for (int q = lane; q < T; q += 32) {
        const unsigned long long x = keys[b * T + q];
        k = x > k ? x : k;
      }
      k = warp_max_key(k);
      if (lane == 0 && k != 0ull) fold_key(a.keys, b, k);
    }
    __threadfence();
    finish_argmax(a.keys, B, a.idx, a.val, last);
  }
}

// ---------------------------------------------------------------------------
// The warp route: one warp a row.
// ---------------------------------------------------------------------------

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
                           unsigned long long* __restrict__ best,
                           int* __restrict__ idx, float* __restrict__ val) {
  constexpr int SHIFT = 5 - ChunkLog<BC>::value;
  __shared__ unsigned long long warp_keys[kWarpsPerBlock][BC];
  __shared__ unsigned int last;
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
      if (m != 0ull) fold_key(best, b0 + threadIdx.x, m);
    }
    __syncthreads();
  }
  __threadfence();
  finish_argmax(best, B, idx, val, &last);
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

// A row's registers: KC = ceil(d / 32) columns of 32, the last one a
// single element where d = 32 (KC - 1) + 1 (the main path's d = 65 holds
// 65 elements, not 96).  1 <= d <= 96.
template <typename F>
void with_row_shape(int64_t d, F&& f) {
  const int64_t kc = (d + 31) / 32;
  auto last = [&](auto kcc) {
    if (d == 32 * (kc - 1) + 1) f(kcc, std::integral_constant<int, 1>{});
    else f(kcc, std::integral_constant<int, 32>{});
  };
  if (kc == 1) last(std::integral_constant<int, 1>{});
  else if (kc == 2) last(std::integral_constant<int, 2>{});
  else last(std::integral_constant<int, 3>{});
}

template <int KC, int LAST, bool VEC, int NR, bool ARGMAX>
cudaError_t launch_row_tiles(const RowArgs& a, int device, int64_t grid,
                             int64_t smem, cudaStream_t s) {
  // The dynamic shared memory this instantiation may take, per device:
  // raised to the block's most once, on the first launch that needs it.
  static int64_t allowed[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && allowed[device] < kMaxSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_tiles_kernel<KC, LAST, VEC, NR, ARGMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    allowed[device] = kMaxSmem;
  }
  row_tiles_kernel<KC, LAST, VEC, NR, ARGMAX>
      <<<static_cast<unsigned int>(grid), kRowThreads,
         static_cast<size_t>(smem), s>>>(a);
  return cudaGetLastError();
}

// The row-tile route after the plan's checks: the layout must fit in a
// block's shared memory; a ring of one slot only where every block has at
// most one tile.
template <bool ARGMAX>
cudaError_t row_tiles(const RowArgs& a, int device, int vec, int64_t grid,
                      cudaStream_t s) {
  const int g = a.groups;
  const int nr = a.rows * g / kRowThreads;
  if (a.d < 1 || a.d > kRowMaxD || a.B < 1 || (g != 1 && g != 2 && g != 4) ||
      (nr != 1 && nr != 2) || a.rows * g != nr * kRowThreads ||
      a.stages < 1 || a.stages > kMaxStages || grid < 1 || grid > INT_MAX)
    return cudaErrorInvalidValue;
  const int64_t smem = RowLayout(a.d, a.B, a.rows, a.stages, ARGMAX).total;
  if (smem > kMaxSmem ||
      (a.stages == 1 && grid * a.rows < a.n))
    return cudaErrorInvalidValue;
  if (vec && (reinterpret_cast<uintptr_t>(a.mat) % 16 != 0 ||
              a.d % 4 != 0 || nr != 1))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  with_row_shape(a.d, [&](auto kc, auto last) {
    constexpr int KC = decltype(kc)::value;
    constexpr int LAST = decltype(last)::value;
    auto go = [&](auto two) {
      constexpr int NR = decltype(two)::value ? 2 : 1;
      // The 16-byte order (d % 4 == 0, never LAST 1) takes one row a
      // thread.
      if constexpr (LAST == 1 || NR == 2) {
        e = launch_row_tiles<KC, LAST, false, NR, ARGMAX>(a, device, grid,
                                                          smem, s);
      } else {
        e = vec ? launch_row_tiles<KC, LAST, true, NR, ARGMAX>(
                      a, device, grid, smem, s)
                : launch_row_tiles<KC, LAST, false, NR, ARGMAX>(
                      a, device, grid, smem, s);
      }
    };
    if (nr == 2) go(std::true_type{});
    else go(std::false_type{});
  });
  return e;
}

}  // namespace

}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// g (n, d) f32, v (B, d) f32, out (n, B) f32.  vec: 1 when g's rows start
// on 16-byte boundaries and d is a multiple of 4 (as rt_corr's vec).
// route 1: row tiles of `rows` rows, `groups` problem groups (threads
// sharing a row's problems; rows x groups / 128 rows a thread), `stages`
// ring slots; route 0: warps.  grid: the plan's blocks.
int rt_corr_batched(int device, const float* g, const float* v, float* out,
                    int64_t n, int64_t d, int64_t B, int vec, int route,
                    int rows, int groups, int stages, int64_t grid,
                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > INT_MAX || grid < 1 || grid > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    RowArgs a{};
    a.mat = g;
    a.v = v;
    a.n = n;
    a.d = static_cast<int>(d);
    a.B = static_cast<int>(B);
    a.rows = rows;
    a.groups = groups;
    a.stages = stages;
    a.out = out;
    return static_cast<int>(row_tiles<false>(a, device, vec, grid, s));
  }
  with_chunk(B, [&](auto bc) {
    constexpr int BC = decltype(bc)::value;
    const unsigned int blocks = static_cast<unsigned int>(grid);
    if (vec)
      corr_batched_kernel<BC, true><<<blocks, kThreads, 0, s>>>(g, v, out, n,
                                                                d, B);
    else
      corr_batched_kernel<BC, false><<<blocks, kThreads, 0, s>>>(g, v, out,
                                                                 n, d, B);
  });
  return static_cast<int>(cudaGetLastError());
}

// mat (n, p) shared (per_problem 0) or (B, n, p) (per_problem 1), f32;
// w (B, p) f32; base (n, B) f32; mask (n, B) bool.  ws: 16 B + 1 8-byte
// words on the device, zero before the call and zero after it (problem b's
// key at word 16 b, the completion counter at word 16 B); idx (B,) int32,
// val (B,) float32 on the device.
// route, rows, groups, stages, grid as rt_corr_batched's (route 1
// takes a shared pool only).
int rt_corr_argmax_batched(int device, const float* mat, const float* w,
                           const float* base, const uint8_t* mask, int64_t n,
                           int64_t p, int64_t B, int per_problem,
                           int absolute, int vec, int route, int rows,
                           int groups, int stages, int64_t grid,
                           void* ws, int* idx,
                           float* val, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(ws);
  if (B < 1 || B > INT_MAX || grid < 1 || grid > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (per_problem) return static_cast<int>(cudaErrorInvalidValue);
    RowArgs a{};
    a.mat = mat;
    a.v = w;
    a.n = n;
    a.d = static_cast<int>(p);
    a.B = static_cast<int>(B);
    a.rows = rows;
    a.groups = groups;
    a.stages = stages;
    a.base = base;
    a.mask = mask;
    a.absolute = absolute;
    a.keys = keys;
    a.idx = idx;
    a.val = val;
    return static_cast<int>(row_tiles<true>(a, device, vec, grid, s));
  }
  with_chunk(B, [&](auto bc) {
    constexpr int BC = decltype(bc)::value;
    const unsigned int blocks = static_cast<unsigned int>(grid);
    if (per_problem) {
      if (vec)
        corr_argmax_batched_kernel<BC, true, false><<<blocks, kThreads, 0,
                                                      s>>>(
            mat, w, base, mask, n, p, B, absolute, keys, idx, val);
      else
        corr_argmax_batched_kernel<BC, false, false><<<blocks, kThreads, 0,
                                                       s>>>(
            mat, w, base, mask, n, p, B, absolute, keys, idx, val);
    } else {
      if (vec)
        corr_argmax_batched_kernel<BC, true, true><<<blocks, kThreads, 0,
                                                     s>>>(
            mat, w, base, mask, n, p, B, absolute, keys, idx, val);
      else
        corr_argmax_batched_kernel<BC, false, true><<<blocks, kThreads, 0,
                                                      s>>>(
            mat, w, base, mask, n, p, B, absolute, keys, idx, val);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
