// Asynchronous copies from device memory to shared memory (cp.async),
// shared by K1-K3t (megakernel.cu, megakernel_clustered.cu), K4-K5
// (intersect.cu) and K11 (dense_hit.cu).
#pragma once

#include <cuda_runtime.h>

namespace frt {

// Copies 16 bytes (both addresses 16-byte aligned) without a register.
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Copies 4 bytes (both addresses 4-byte aligned) without a register.
__device__ __forceinline__ void copy4_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace frt
