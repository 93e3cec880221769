// Hopper's asynchronous pieces for the warp-specialised SECAM kernels
// (csrc/secam_encode.cu, csrc/secam_decode.cu): mbarriers with phase
// parity, bulk asynchronous stores (cp.async.bulk, shared -> global, no
// tensor map), named barriers over one group of warps, and setmaxnreg.
//
// A handoff between two groups of warps is a full/empty pair of mbarriers
// on a buffer.  The consumer of use k of a buffer waits on its full
// barrier with parity k & 1; the producer waits on its empty barrier with
// parity (k & 1) ^ 1, which passes at once for k = 0 (the buffer starts
// free).  Every thread of the arriving group arrives (release at CTA
// scope), so no warp-level election orders its writes.
//
// A bulk store is committed to its thread's bulk group, and that thread
// waits for its source to be read (wait_group.read) before the buffer is
// written again.  Threads that wrote the source of a bulk store fence it
// to the async proxy (fence.proxy.async) before the group barrier that
// precedes the store.  It needs 16-byte aligned addresses and a multiple
// of 16 bytes; the kernels keep plain stores, from the same staging rows,
// where a row is not aligned so (n % 4 != 0).  The loads stay on cp.async:
// bulk loads in their place were level with it on an H100
// (scripts/torch_secam_variants.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ap {

__device__ inline unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count)
               : "memory");
}

// After every init, before any thread uses the barriers (then a block sync).
__device__ inline void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar)) : "memory");
}

// Until the phase of parity `parity` of `bar` has completed.
__device__ inline void wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from shared `src` to global `dst`, in this thread's bulk group.
__device__ inline void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem(src)), "r"(bytes)
               : "memory");
}

__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// This thread's bulk stores have read their sources.
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's bulk stores are complete.
__device__ inline void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// This thread's shared-memory writes, visible to the async proxy.
__device__ inline void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over `threads` threads (a group of whole warps) with id 1-15.
__device__ inline void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// setmaxnreg (sm_90a): the calling warpgroup's registers per thread, down
// to kRegs or up to it; all four warps of the warpgroup run it, on a path
// that does not rejoin the other warpgroups' (or ptxas ignores it).
template <int kRegs>
__device__ inline void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ inline void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Floats per row of a plane that ldmatrix reads without bank conflicts:
// the least multiple of 8 plus 4 that holds `cols` (pitch % 8 == 4, so
// the 8 rows of one ldmatrix hit distinct 4-bank groups).
__host__ __device__ inline int pitch8(int cols) { return (cols + 7) / 8 * 8 + 4; }

}  // namespace ap
