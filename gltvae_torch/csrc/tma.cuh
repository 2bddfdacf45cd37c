// Hopper (sm_90) shared-memory barriers and 1-D bulk copies (TMA), as PTX.
//
// A 1-D bulk copy moves `bytes` contiguous bytes from global to shared
// memory without using the threads' registers or instructions; the
// hardware reports completion to an mbarrier in shared memory. Both
// addresses and the size must be multiples of 16 bytes.

#pragma once

#include <cstdint>

namespace gltvae {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier that completes each phase on one arrival (plus
// the bytes that arrival announces). Sync the block before other threads
// wait on it.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of `bar` with this parity has completed. A phase
// that never completes (a size that does not match its copy) traps rather
// than hanging the card: the copies waited on take microseconds, so 2^22
// polls are far past any real wait.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

// One thread: announce `bytes` on `bar` (its one arrival for this phase)
// and start the copy global -> shared that delivers them.
__device__ __forceinline__ void bulk_load(void* sdst, const void* gsrc,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(sdst)), "l"(gsrc), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace gltvae
