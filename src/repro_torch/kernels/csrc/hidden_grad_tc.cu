// The exact head-input gradient of an LM head on Hopper's tensor cores
// (sm_90a):
//   out = (softmax(Z) - onehot(Y)) @ W^T      Z (n, V), W (d_h, V) -> (n, d_h)
// with no (n, V) residual in device memory, for a bf16 head W.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lastlayer_grad.py:
// hidden_grad_fused (its product on the MXU), beside the FFMA kernel of
// hidden_grad.cu, which keeps the shapes this one does not take (an f32
// head, strides TMA cannot address; the wrapper's routing rule).
//
// What bounds it on an H100: W's values are exact in bf16, but the
// residual r = p - onehot needs f32.  It is cut into hi = bf16(r) and
// lo = bf16(r - hi), and two bf16 tensor-core products, hi W + lo W, are
// summed into one f32 accumulator: f32-grade sums (r is kept to 16 bits
// of mantissa) at twice the bf16 work, 2 x 2 n V d_h operations.  On the
// LM path (n = 512, V = 256 000, d_h = 2 048, bf16 Z and a tied bf16 W)
// that is 1.07e12 operations, 1.09 ms at 989 TFLOP/s, against 1.3 GB
// moved, 0.39 ms at 3.35 TB/s: the tensor cores bound it.
//
// Design:
//   1. hidden_grad_stats_kernel (hidden_grad.cuh): (m_i, l_i) per row in
//      one fixed order, one read of Z in 16-byte loads.
//   2. hidden_grad_tc_kernel: one block of three warpgroups per
//      (128-row, 256-column) output tile and slice of V, so each logit's
//      exp is formed d_h / 256 times (8 on the LM path).  Warpgroup 2's
//      first thread is the producer: it keeps a ring of shared-memory
//      stages full with TMA (cp.async.bulk.tensor, 128-byte swizzle), each
//      stage Z's (128 x 64) tile and W's (64 x 256) tile, each stage with
//      a "full" mbarrier (TMA bytes) and an "empty" one (eight consumer
//      warps).  Warpgroups 0 and 1 are the consumers, 64 rows each: a
//      thread reads its Z elements from the stage in wgmma's A-fragment
//      layout, forms r = exp(z - m_i) / l_i - [v == y_i] in f32, splits it
//      into hi and lo bf16 registers and issues, per 16 entries of V, two
//      wgmma.mma_async m64n256k16 with A from those registers and W's tile
//      as B from shared memory: hi W then lo W into one f32 accumulator
//      (128 registers a thread).  A tied head (W = embed^T, embed (V, d_h)
//      contiguous) is B "MN-major" (four 64-column TMA boxes a stage); a
//      contiguous (d_h, V) head is B "K-major" (one box).  While one
//      consumer warpgroup forms its residual, the other's products run.
//   3. Split-K over V: on the LM path there are only 4 x 8 output tiles
//      for 132 SMs (one block an SM: 197 KB of shared memory), so V is cut
//      into `splits` slices of whole 64-entry stages, one block per tile
//      and slice, each writing its own partial tile, and
//      hidden_grad_reduce_kernel adds the partials in slice order.  The
//      cut is a function of the shapes and the SM count (the wrapper's).
//   4. Precision: the tensor cores' f32 sums lose low bits at every step,
//      an error that grows with the steps one accumulator takes: past the
//      1e-4 of max |out| allowed after the 8 000 steps of a 64 000-entry
//      slice at the LM shape (tools/hidden_grad_breakdown.py, variant
//      no_flush).  So every kTcFlush stages (256 steps) a thread adds its
//      accumulator into the block's own partial tile in device memory, in
//      f32 to nearest, and restarts from 0, which cuts that error about
//      tenfold: no atomics, the tile is no other block's.
// Every output element is summed over v in increasing order within a
// slice (the tensor cores' order inside each 16-entry step, hi before lo,
// the flushes in order) and the slices in a fixed order: no float
// atomics, so two calls give the same bits.  Logits past V are loaded as 0
// by TMA and masked to r = 0; W past V or d_h loads as 0; rows past n get
// p = 0 and no label.  TMA coordinates are 32-bit (V, n, d_h < 2^31);
// output offsets are 64-bit.  A stalled barrier wait traps after ~2^34
// cycles rather than hang.
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda

#include "hidden_grad.cuh"
#include "mbarrier.cuh"

namespace repro_torch {
namespace {

constexpr int kTcRows = 128;     // output rows a block: two warpgroups of 64
constexpr int kTcCols = 256;     // output columns a block: one m64n256 wgmma
constexpr int kTcDepth = 64;     // vocabulary entries a stage
constexpr int kTcThreads = 384;  // two consumer warpgroups, one producer
constexpr int kTcConsumerWarps = 8;
constexpr int kSwizzle = 128;    // bytes a swizzled row holds
constexpr int kTcFlush = 32;     // stages summed in the tensor cores alone

template <typename TZ>
struct TcCfg {
  static constexpr int kZBox = kSwizzle / sizeof(TZ);  // entries a Z box row
  static constexpr int kZBoxes = kTcDepth / kZBox;     // 1 (bf16) or 2 (f32)
  static constexpr int kZBoxBytes = kTcRows * kSwizzle;
  static constexpr int kZBytes = kZBoxes * kZBoxBytes;
  static constexpr int kWBytes = kTcDepth * kTcCols * 2;
  static constexpr int kStageBytes = kZBytes + kWBytes;
  static constexpr int kStages = sizeof(TZ) == 2 ? 4 : 3;
  // + the 2 kStages barriers + slack to align the ring to 1 024 bytes
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
};

// One 2-D TMA box into shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

// d (64 x 256 f32, wgmma's accumulator layout) += A (64 x 16 bf16, four
// registers of wgmma's A-fragment layout) x B (16 x 256 bf16 in shared
// memory, `desc`); kTransB 0: B K-major, 1: B MN-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_256(float (&d)[128],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %133, p, 1, 1, %134;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc),
        "n"(kTransB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep a register's value where it is across the asynchronous product:
// the compiler may neither move its use nor reuse it before this point.
__device__ __forceinline__ void hold(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void hold(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Entries k and k + 1 (k even) of row r of a stage's Z tile as TMA stored
// it: 128-byte rows, each row's 16-byte chunk index xor (r mod 8); an f32
// tile is two boxes of 32 entries.  For one warp the 32 reads fall on 32
// banks (eight rows, eight chunks).
template <typename TZ>
__device__ __forceinline__ float2 z_pair(const uint8_t* zt, int r, int k) {
  if constexpr (sizeof(TZ) == 2) {
    const int off = r * kSwizzle + ((((k >> 3) ^ r) & 7) << 4) + ((k & 7) << 1);
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(zt + off));
  } else {
    const int kk = k & 31;
    const int off = (k >> 5) * TcCfg<float>::kZBoxBytes + r * kSwizzle +
                    ((((kk >> 2) ^ r) & 7) << 4) + ((kk & 3) << 2);
    return *reinterpret_cast<const float2*>(zt + off);
  }
}

// (a, b) -> hi = bf16(a, b), lo = bf16((a, b) - hi), a in each register's
// low half and b in its high half, as wgmma's A fragment pairs entries k
// and k + 1.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Accumulator register 4 j + 2 h (+1) holds row r0 + 8 h, columns
// col + 8 j (+1).  Those rows and columns of dst (n, d_h) get the
// accumulator (accumulate false) or the accumulator added to them, in f32
// to nearest; then the accumulator restarts from 0.  The loads go out 16
// pairs at a time, so their latencies overlap.
__device__ __forceinline__ void flush(float (&acc)[128],
                                      float* __restrict__ dst, int n, int dh,
                                      int r0, int col, bool accumulate) {
  const bool pairs = (dh & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    if (i >= n) continue;
    float* orow = dst + static_cast<int64_t>(i) * dh;
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += 16) {
      float2 old[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cj = col + 8 * (j0 + j);
        old[j] = make_float2(0.f, 0.f);
        if (accumulate && cj < dh) {
          if (pairs) {
            old[j] = *reinterpret_cast<const float2*>(orow + cj);
          } else {
            old[j].x = orow[cj];
            if (cj + 1 < dh) old[j].y = orow[cj + 1];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cj = col + 8 * (j0 + j);
        if (cj >= dh) continue;
        const float a = old[j].x + acc[4 * (j0 + j) + 2 * h];
        const float b = old[j].y + acc[4 * (j0 + j) + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(orow + cj) = make_float2(a, b);
        } else {
          orow[cj] = a;
          if (cj + 1 < dh) orow[cj + 1] = b;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;
}

// Block (x, y, z) computes output tile (y, x) over the V slice
// [z slice, (z + 1) slice) into out + z n d_h.
template <typename TZ, bool kTied>
__global__ void __launch_bounds__(kTcThreads, 1)
hidden_grad_tc_kernel(const __grid_constant__ CUtensorMap zmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const void* __restrict__ labels, int label64,
                      const float2* __restrict__ stats, int n, int v_len,
                      int dh, int slice, float* __restrict__ out) {
  using C = TcCfg<TZ>;
  extern __shared__ uint8_t smem_raw[];
  // The ring starts on a 1 024-byte boundary: the 128-byte swizzle's xor
  // pattern repeats every eight rows, and the wgmma descriptors assume it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full0 = ring + C::kStages * C::kStageBytes;
  const uint32_t empty0 = full0 + 8 * C::kStages;
  const int t = threadIdx.x;
  const int row0 = blockIdx.y * kTcRows;
  const int col0 = blockIdx.x * kTcCols;
  const int v_begin = blockIdx.z * slice;
  const int v_stop = min(v_begin + slice, v_len);
  const int chunks = (v_stop - v_begin + kTcDepth - 1) / kTcDepth;

  if (t == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (t >= 256) {
    // Producer warpgroup: its first thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == 256) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&zmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      for (int c = 0; c < chunks; ++c) {
        const int s = c % C::kStages;
        // Round r of stage s waits for the consumers' release of round
        // r - 1 (parity (r - 1) & 1); round 0 passes at once.
        mbar_wait(empty0 + 8 * s, ((c / C::kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t zdst = ring + s * C::kStageBytes;
        const uint32_t wdst = zdst + C::kZBytes;
        const int k0 = v_begin + c * kTcDepth;
        mbar_expect_tx(full, C::kStageBytes);
#pragma unroll
        for (int b = 0; b < C::kZBoxes; ++b)
          tma_load(zdst + b * C::kZBoxBytes, &zmap, full, k0 + b * C::kZBox,
                   row0);
        if constexpr (kTied) {  // (64 entries x 64 columns) boxes of embed
#pragma unroll
          for (int j = 0; j < kTcCols / 64; ++j)
            tma_load(wdst + j * kTcDepth * kSwizzle, &wmap, full,
                     col0 + 64 * j, k0);
        } else {  // one (256 columns x 64 entries) box of W
          tma_load(wdst, &wmap, full, k0, col0);
        }
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: tile rows 64 wg .. 64 wg + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = t >> 7;
    const int lane = t & 31;
    const int tq = lane & 3;
    // This thread's two rows of the A fragment and the accumulator:
    // ra and ra + 8 (ra mod 8 = lane / 4).
    const int ra = wg * 64 + ((t >> 5) & 3) * 16 + (lane >> 2);
    float mrow[2], ilrow[2];
    int yrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + ra + 8 * h;
      mrow[h] = 0.f;   // a row past n: z loads as 0, p = 0, no label
      ilrow[h] = 0.f;
      yrow[h] = -1;
      if (i < n) {
        const float2 st = stats[i];
        mrow[h] = st.x;
        ilrow[h] = 1.f / st.y;
        const int64_t y = label64 ? static_cast<const int64_t*>(labels)[i]
                                  : static_cast<const int32_t*>(labels)[i];
        yrow[h] = (y >= 0 && y < v_len) ? static_cast<int>(y) : -1;
      }
    }
    float acc[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    float* dst = out + static_cast<int64_t>(blockIdx.z) * n * dh;

    // B's descriptor at stage 0's first 16-entry step.  A step moves 32
    // bytes along a K-major row, or 16 rows (2 048 bytes) down an MN-major
    // box; the MN-major boxes of 64 columns lie kTcDepth rows apart (LBO),
    // and eight rows of either span 1 024 bytes (SBO).
    const uint32_t w0 = ring + C::kZBytes;
    const uint64_t desc0 =
        kTied ? sw128_desc(w0, kTcDepth * kSwizzle, 8 * kSwizzle)
              : sw128_desc(w0, 16, 8 * kSwizzle);
    constexpr uint32_t kStepUnits = kTied ? (16 * kSwizzle) >> 4 : 32 >> 4;
    constexpr uint32_t kStageUnits = C::kStageBytes >> 4;

    for (int c = 0; c < chunks; ++c) {
      const int s = c % C::kStages;
      mbar_wait(full0 + 8 * s, (c / C::kStages) & 1);
      const uint8_t* zt = ring_ptr + s * C::kStageBytes;
      const int k0 = v_begin + c * kTcDepth;
      // p = exp(z - m) / l in f32, in wgmma's A-fragment layout: entries
      // pk[ks][q] of step ks, register q are 16 ks + 8 (q / 2) + 2 tq, +1
      // of row ra + 8 (q mod 2).
      float2 pk[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1;
          const float2 zz =
              z_pair<TZ>(zt, ra + 8 * h, 16 * ks + 8 * (q >> 1) + 2 * tq);
          pk[ks][q].x = ex2((zz.x - mrow[h]) * kLog2e) * ilrow[h];
          pk[ks][q].y = ex2((zz.y - mrow[h]) * kLog2e) * ilrow[h];
        }
      // - onehot, where a row's label falls in this stage; 0 past V (TMA
      // loaded those logits as 0).  Both are rare, so they branch.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (static_cast<unsigned>(yrow[h] - k0) < kTcDepth) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              const int v = k0 + 16 * ks + 8 * qq + 2 * tq;
              float2& pp = pk[ks][2 * qq + h];
              if (v == yrow[h]) pp.x -= 1.f;
              if (v + 1 == yrow[h]) pp.y -= 1.f;
            }
        }
      }
      if (k0 + kTcDepth > v_len) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int v = k0 + 16 * ks + 8 * (q >> 1) + 2 * tq;
            if (v >= v_len) pk[ks][q].x = 0.f;
            if (v + 1 >= v_len) pk[ks][q].y = 0.f;
          }
      }
      // r = hi + lo, each bf16
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_bf16(pk[ks][q].x, pk[ks][q].y, hi[ks][q], lo[ks][q]);
#pragma unroll
      for (int j = 0; j < 128; ++j) hold(acc[j]);
      wgmma_fence();
      const uint64_t desc = desc0 + s * kStageUnits;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_256<kTied>(acc, hi[ks], desc + ks * kStepUnits);
        wgmma_256<kTied>(acc, lo[ks], desc + ks * kStepUnits);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hold(hi[ks][q]);
          hold(lo[ks][q]);
        }
#pragma unroll
      for (int j = 0; j < 128; ++j) hold(acc[j]);
      // This warp is done with stage s (its Z reads and its products).
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      // The tensor cores round each 16-entry step's sum toward zero, an
      // error that grows with the steps an accumulator takes; so every
      // kTcFlush stages the accumulator is added (in f32, to nearest) into
      // this block's own partial tile and restarts from 0.
      if ((c + 1) % kTcFlush == 0 || c + 1 == chunks)
        flush(acc, dst, n, dh, row0 + ra, col0 + 2 * tq, c >= kTcFlush);
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query: the library links no -lcuda.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 2-D map of a row-major (outer, inner) matrix whose rows lie `stride`
// elements apart, read in (box_outer, box_inner) boxes with the 128-byte
// swizzle; entries outside the matrix load as 0.
cudaError_t make_map(CUtensorMap* map, const void* ptr, bool bf16,
                     int64_t inner, int64_t outer, int64_t stride,
                     int box_inner, int box_outer) {
  EncodeTiledFn encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(stride) * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct TcArgs {
  const void* z;
  const void* labels;
  int label64;
  const void* w;
  float2* stats;
  int64_t n, v_len, dh, slice;
  int splits;
  float* part;
  float* out;
};

template <typename TZ, bool kTied>
cudaError_t launch_hidden_grad_tc(const TcArgs& a, cudaStream_t s) {
  using C = TcCfg<TZ>;
  CUtensorMap zmap, wmap;
  cudaError_t e = make_map(&zmap, a.z, sizeof(TZ) == 2, a.v_len, a.n,
                           a.v_len, C::kZBox, kTcRows);
  if (e != cudaSuccess) return e;
  e = kTied ? make_map(&wmap, a.w, true, a.dh, a.v_len, a.dh, 64, kTcDepth)
            : make_map(&wmap, a.w, true, a.v_len, a.dh, a.v_len, kTcDepth,
                       kTcCols);
  if (e != cudaSuccess) return e;
  auto* kernel = hidden_grad_tc_kernel<TZ, kTied>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem);
  if (e != cudaSuccess) return e;
  e = launch_hidden_grad_stats<TZ>(a.z, a.n, a.v_len, a.stats, s);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((a.dh + kTcCols - 1) / kTcCols),
                  static_cast<unsigned>((a.n + kTcRows - 1) / kTcRows),
                  static_cast<unsigned>(a.splits));
  kernel<<<grid, kTcThreads, C::kSmem, s>>>(
      zmap, wmap, a.labels, a.label64, a.stats, static_cast<int>(a.n),
      static_cast<int>(a.v_len), static_cast<int>(a.dh),
      static_cast<int>(a.slice), a.splits > 1 ? a.part : a.out);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  return launch_hidden_grad_reduce(a.part, a.splits, a.n * a.dh, a.out, s);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

// z (n, V) row-major, float32 (z_dtype 0) or bfloat16 (1), rows 16-byte
// aligned; labels (n,) int32 (label64 0) or int64 (1); w the bf16 (d_h, V)
// head: tied 1 when it is embed^T (element (h, v) at w[v d_h + h], d_h a
// multiple of 8), tied 0 when contiguous (at w[h V + v], V a multiple of
// 8); stats an (n, 2) f32 scratch; V cut into `splits` slices of `slice`
// entries (a multiple of 64; splits = ceil(V / slice)), part a
// (splits, n, d_h) f32 scratch when splits > 1 (else unused); out (n, d_h)
// f32.  1 <= n, V, d_h < 2^31, all on the device, 16-byte aligned.
// Returns the first error (cudaErrorInvalidValue if the driver refuses a
// tensor map), or cudaGetLastError() after the last launch.
int rt_hidden_grad_tc(int device, const void* z, int z_dtype,
                      const void* labels, int label64, const void* w,
                      int tied, float* stats, int64_t n, int64_t v_len,
                      int64_t dh, int64_t slice, int splits, float* part,
                      float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TcArgs a{z, labels, label64, w, reinterpret_cast<float2*>(stats),
                 n, v_len, dh, slice, splits, part, out};
  if (z_dtype == 1)
    e = tied ? launch_hidden_grad_tc<__nv_bfloat16, true>(a, s)
             : launch_hidden_grad_tc<__nv_bfloat16, false>(a, s);
  else
    e = tied ? launch_hidden_grad_tc<float, true>(a, s)
             : launch_hidden_grad_tc<float, false>(a, s);
  return static_cast<int>(e);
}

}  // extern "C"
