// mbarrier and bulk-copy helpers shared by the port's Hopper kernels
// (sm_90a): barrier set-up, arrivals with a transaction count, a parity
// wait that traps instead of hanging, and the plain (non-tensor) bulk copy
// of contiguous bytes from device memory into shared memory, whole or as a
// span of elements at any alignment (BulkSpan).
#pragma once

#include <stdint.h>

namespace repro_torch {

// A barrier wait that has not completed after ~2^34 cycles (a wrong
// transaction count or parity) traps: "unspecified launch failure" rather
// than a hung card.
constexpr long long kWatchdogCycles = 1ll << 34;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// `bytes` contiguous bytes from `src` (device memory) into shared memory
// at `dst`, counted on `bar`'s transaction count.  Both addresses and the
// size are multiples of 16 bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `count` elements of T from `src` (device memory) placed in shared memory
// at `slot` plus src's offset from a 16-byte boundary, so the two agree
// modulo 16: the 16-byte-aligned middle by one bulk copy (bulk(), counted
// on a barrier that expects bulk_bytes()), the head before it and the tail
// after it (< 16 bytes each) by plain loads (copy_ends()).  One thread
// issues both; the readers find the span at `dst`.
template <typename T>
struct BulkSpan {
  uintptr_t a, a16, e16, e;
  unsigned char* dst;
  __device__ __forceinline__ BulkSpan(const T* src, int64_t count,
                                      unsigned char* slot) {
    a = reinterpret_cast<uintptr_t>(src);
    e = a + static_cast<uintptr_t>(count) * sizeof(T);
    a16 = (a + 15) & ~uintptr_t{15};
    a16 = a16 < e ? a16 : e;
    e16 = e & ~uintptr_t{15};
    e16 = e16 > a16 ? e16 : a16;
    dst = slot + (a & 15);
  }
  __device__ __forceinline__ uint32_t bulk_bytes() const {
    return static_cast<uint32_t>(e16 - a16);
  }
  __device__ __forceinline__ void copy_ends() const {
    T* out = reinterpret_cast<T*>(dst);
    for (uintptr_t p = a; p < a16; p += sizeof(T))
      out[(p - a) / sizeof(T)] = *reinterpret_cast<const T*>(p);
    for (uintptr_t p = e16; p < e; p += sizeof(T))
      out[(p - a) / sizeof(T)] = *reinterpret_cast<const T*>(p);
  }
  __device__ __forceinline__ void bulk(uint32_t bar) const {
    if (e16 > a16)
      bulk_load(smem_u32(dst + (a16 - a)), reinterpret_cast<const void*>(a16),
                bulk_bytes(), bar);
  }
};

}  // namespace repro_torch
