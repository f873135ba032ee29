// Asynchronous global -> shared copies (cp.async) for the kernels
// redesigned for Hopper: the MLP forward (fused_mlp.cu), the vanilla-RNN and
// GRU forwards (fused_rnn.cu), the vanilla-RNN backward (fused_bwd.cu) and,
// through cluster_dense.cuh, its cluster kernels.  The other kernels keep
// their plain loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sqair {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies min(4, avail) floats from `src` to `dst` (dst 16-byte aligned):
// one 16-byte copy where all four are there and `src` is 16-byte aligned,
// else one 4-byte copy per float.  Nothing for avail <= 0.
__device__ __forceinline__ void copy4_async(float* dst, const float* src, int avail) {
  if (avail >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
  } else {
    for (int e = 0; e < min(avail, 4); ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst + e)),
                   "l"(src + e));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
// The copies themselves carry no "memory" clobber (so that the compiler
// keeps what it holds in registers across them); the wait does, and a
// barrier follows it before any thread reads what landed.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace sqair
