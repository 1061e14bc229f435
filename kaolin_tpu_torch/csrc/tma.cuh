// Hopper's bulk-copy engine (TMA) and shared-memory barriers (mbarrier), as
// inline PTX for sm_90a.
//
// A bulk copy moves a contiguous run of bytes between device memory and
// shared memory: one thread issues it, the copy engine computes nothing on
// the SM, and a load reports its bytes to an mbarrier in shared memory
// (complete_tx), so the threads that wait on the barrier's phase see the
// data.  A store reads shared memory in a bulk group, committed and waited
// on by the thread that issued it.
//
// Rules the callers keep:
// * sources, destinations and sizes of bulk copies are multiples of 16
//   bytes;
// * one thread initialises the barriers, then runs fence_barrier_init()
//   and the CTA __syncthreads() before any copy is issued;
// * a barrier armed with arrive_expect_tx(bytes) completes its phase when
//   its arrivals and exactly those bytes are in: the byte count must equal
//   the bytes the copies deliver, or the wait never ends;
// * the n-th use of a barrier (from 0) is waited on with parity n & 1;
// * shared memory written by threads (the generic proxy) is read by a bulk
//   store only after those threads ran fence_proxy_async() and a barrier;
// * a slot read by a bulk store is written again (by threads or a bulk
//   load) only after wait_store_read<N>() has left that store's group done,
//   and a CTA does not exit before its stores have read shared memory.
//
// Used by kaolin_tpu_torch/csrc/probes.cu; part of every build key of the
// sources in this directory (kaolin_tpu_torch/_cuda.py).

#pragma once

#include <cstdint>

namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier that completes a phase after ``count`` arrivals (and the bytes
// armed by arrive_expect_tx).  One thread.
__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the copy engine; the thread
// that initialised them runs it before the CTA's __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect ``bytes`` more bytes in
// this phase.
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival (release: this thread's earlier reads and writes of shared
// memory happen before the phase completes).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity ``parity`` has completed (acquire: what
// was written into shared memory before it completed is visible).
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  while (!try_wait(a, parity)) {
  }
}

// Bulk load of ``bytes`` from device memory ``src`` into shared memory
// ``dst``, its bytes reported to ``bar``.
__device__ __forceinline__ void load(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bulk store of ``bytes`` from shared memory ``src`` to device memory
// ``dst``, in the issuing thread's current bulk group.
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// Closes the issuing thread's current bulk group.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of the issuing thread's bulk groups have not yet
// finished reading their shared memory.
template <int N>
__device__ __forceinline__ void wait_store_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of the issuing thread's bulk groups are incomplete
// (their writes done).
template <int N>
__device__ __forceinline__ void wait_store() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before later
// bulk copies (async proxy) of the CTA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace tma
