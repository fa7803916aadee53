// Pieces of the single-pass scans (csrc/segscan.cu, csrc/spmm.cu): relaxed
// gpu-scope accesses to the tiles' 64-bit descriptors, Hopper's bulk copies
// of a tile's inputs into shared memory, and the per-thread asynchronous
// copies of gathered rows.
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

// The fence between a descriptor's values and its status word, on both
// sides: acquire-release orders them, as message passing needs, without the
// sequentially consistent fence's wait.
__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

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

// Ampere's asynchronous copies (LDGSTS): B = 4, 8 or 16 bytes global ->
// shared, both addresses aligned to B.  No register waits for the data: a
// thread commits its copies as a group and waits for all its groups; a
// barrier then shows them to the block.
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem(dst)), "l"(src), "n"(B) : "memory");
}
// The same, the line marked in L2 by the cache policy pol.
template <int B>
__device__ __forceinline__ void cp_async_keep(void* dst, const void* src, uint64_t pol) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;" ::"r"(smem(dst)), "l"(src), "n"(B), "l"(pol)
               : "memory");
}
// The same past L1 (16 bytes alone): rows read once, which would only
// evict what L1 holds.
template <int B>
__device__ __forceinline__ void cp_async_stream(void* dst, const void* src) {
  static_assert(B == 16, "cp.async.cg copies 16 bytes");
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// every group of the thread landed, or all but its newest
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }
