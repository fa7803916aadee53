// Pieces of the single-pass scans (csrc/segscan.cu, csrc/spmm.cu): relaxed
// gpu-scope accesses to the tiles' 64-bit descriptors, and Hopper's bulk
// copies of a tile's inputs into shared memory.
#pragma once

#include <stdint.h>

// A descriptor is one 64-bit word that carries its own value, so nothing
// else needs ordering around it: relaxed gpu-scope accesses suffice, and a
// publish does not wait for the thread's earlier stores as a release would.
__device__ __forceinline__ void st_desc(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint64_t ld_desc(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Hopper's bulk copies: global -> shared, completion counted in bytes on an
// mbarrier.  Addresses and sizes are multiples of 16 bytes.
__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
