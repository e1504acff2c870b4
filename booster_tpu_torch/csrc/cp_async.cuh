// cp.async copies from global to shared memory, shared by the tensor-core
// kernels' rings (attn_mma.cuh, qmm_ring.cuh): 16 or 4 bytes a thread, zeros
// and no read where the source is not live; a group is committed after a
// stage's copies and waited for before the stage is used.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cpasync {

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(src)), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(src)), "r"(live ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace cpasync
