// Hopper's bulk asynchronous copies (the TMA without a tensor map) and the
// shared-memory barriers that report them, as inline PTX for sm_90.
//
// A bulk copy moves a run of bytes between device memory and shared memory
// on the SM's copy engine: one thread issues it, no registers hold the
// data. Both addresses and the size must be multiples of 16 bytes.
//
// * load:  bulk_load(stage, src, bytes, bar) after
//          mbar_arrive_expect_tx(bar, bytes); the barrier's phase completes
//          when the bytes have landed (mbar_wait with the phase's parity);
// * store: bulk_store(dst, stage, bytes), then bulk_commit() closes a
//          group; bulk_wait_read<N>() returns once at most N groups are
//          still reading shared memory (the stage may be refilled), and
//          bulk_wait_all() once every group's writes are done.
//
// Beside them, the per-thread asynchronous copies (cp.async, 4 to 16 bytes
// a thread, tracked by commit groups): stage_copy (stage_copy_or_zero
// fills zeros where a guarded kernel reads nothing), cp_async_commit,
// cp_async_wait<N> (returns once at most N of the thread's groups are
// pending).
//
// Shared-memory addresses are 32-bit (cvta to the shared window); device
// addresses are 64-bit.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One expected arrival (the issuing thread's arrive_expect_tx) a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the copy engine (the async
// proxy) before the first bulk copy signals one of them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void bulk_load(uint32_t stage, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(stage), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t stage,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(stage), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One word (or, with kVec, one 16-byte chunk) from device memory to
// shared memory: cp.async for 4, 8 and 16 bytes (16 bypasses L1), a
// plain load and store below that.
template <int kBytes, typename W>
__device__ __forceinline__ void stage_copy(W* dst, const W* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
  } else if constexpr (kBytes >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes) : "memory");
  } else {
    *dst = *src;
  }
}

// stage_copy, or with !ok zeros into dst and nothing read: cp.async with
// a source size of 0 (src must still be a valid address), a plain store
// below 4 bytes.
template <int kBytes, typename W>
__device__ __forceinline__ void stage_copy_or_zero(W* dst, const W* src,
                                                   bool ok) {
  const uint32_t n = ok ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  } else if constexpr (kBytes >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  } else {
    *dst = ok ? *src : W{};
  }
}
