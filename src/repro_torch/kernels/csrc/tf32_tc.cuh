// The pieces of 3xTF32 on Hopper's tensor cores (sm_90a) shared by the
// on-the-fly facility-location scan (fl_gain_tc.cu) and the pairwise
// squared distances (sqdist_tc.cu):
//
// - the TF32 split: hi = tf32_rna(x), lo = tf32_rna(x - hi), written into
//   planes of 32-byte rows (8 floats, one wgmma k step, zeros past d):
//   plane c holds columns 8 c .. 8 c + 7 of every row, so one 3-D TMA box
//   of (8, rows, planes) lands a tile of rows in wgmma's K-major layout
//   for the 32-byte swizzle, one plane a k step;
// - the TMA load of such a box and the map that describes the planes;
// - the wgmma of a 64 x 128 f32 accumulator from two K-major TF32 operands
//   in shared memory, with its fence, commit and wait.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda

#include "common.cuh"
#include "mbarrier.cuh"

namespace repro_torch {
namespace {

constexpr int kRowBytes = 32;  // a row of one plane: 8 tf32, one k step

// x rounded to TF32 (to nearest, ties away from zero), as an f32 whose low
// 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// Column k of row i, x (0 past d), into the plane layout of a buffer of
// `rows` rows: hi at plane k / 8 and, with kLo, lo at plane k8 + k / 8.
// Without kLo, x itself: the caller's x is already TF32 (a widened bf16).
template <bool kLo>
__device__ __forceinline__ void split_put(float x, int64_t i, int k,
                                          int64_t rows, int k8,
                                          float* __restrict__ split) {
  const int64_t plane = rows * 8;
  const int64_t at = (k >> 3) * plane + i * 8 + (k & 7);
  if constexpr (kLo) {
    const float hi = tf32_rna(x);
    split[at] = hi;
    split[at + k8 * plane] = tf32_rna(x - hi);
  } else {
    split[at] = x;
  }
}

// One 3-D TMA box into shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a K-major operand with the 32-byte
// swizzle: start address, leading byte offset 16 (unused: one k step spans
// the swizzled row), stride byte offset 256 (eight 32-byte rows), layout
// B32.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// d (64 x 128 f32, wgmma's accumulator layout) = (scale ? d : 0) +
// A (64 x 8 tf32, `da`) x B (128 x 8 tf32, `db`), both K-major in shared
// memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale));
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
// Keep an accumulator register where it is across the asynchronous
// product: the compiler may neither move its use nor reuse it past here.
__device__ __forceinline__ void hold(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
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

// A 3-D map of a split buffer, (8 floats, n rows, `planes` planes), read in
// boxes of (8, rows, box_planes) with the 32-byte swizzle (box_planes 0: all
// of them); rows past n load as 0.
cudaError_t make_split_map(CUtensorMap* map, const float* split, int n,
                           int planes, int rows, int box_planes = 0) {
  EncodeTiledFn encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {8, static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {
      kRowBytes, static_cast<cuuint64_t>(n) * kRowBytes};
  const cuuint32_t box[3] = {
      8, static_cast<cuuint32_t>(rows),
      static_cast<cuuint32_t>(box_planes > 0 ? box_planes : planes)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(split),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch
