// Hopper's bulk asynchronous copies (cp.async.bulk, sm_90) between device
// memory and shared memory, with the mbarrier that counts a load's bytes
// in and the bulk group that tracks a store's reads out of shared memory.
// No tensor map: each copy is one contiguous run of bytes, its size and
// both addresses multiples of 16.  One thread issues a copy; the copy
// engine moves the bytes without registers or load instructions.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lpt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A barrier that completes a phase when one thread has arrived and the
// bytes it announced have landed.  Initialise from one thread, then
// `mbar_fence_init` before any copy uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed (the
// first phase has parity 0).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// dst (shared) <- src (device memory), `bytes` of them; `bar` expects them
// and completes its phase when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// dst (device memory) <- src (shared), `bytes` of them, as a bulk group of
// its own.  Shared memory written by threads is first made visible to the
// copy engine: each writing thread runs `fence_async_shared`, then a
// barrier, then one thread stores.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory (the
// stage may then be overwritten or the block leave; their writes to device
// memory complete on their own).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace lpt
