// Shared pieces of the hand-written kernels (through bwd_common.cuh,
// glimpse_common.cuh and tile_sums.cuh all of them): the block size, the
// activations, the 32-product blocks in which every dot product is summed,
// and shared-memory layout helpers.  The kernels' products are tile_sums.cuh's
// (the MLP and cell forwards) and cluster_dense.cuh's (the kernels that hold
// a tile's state in every block of a thread block cluster); all arithmetic
// is f32 with f32 accumulation.
#pragma once

#include <cuda_runtime.h>

namespace sqair {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 1024;  // widest layer a kernel takes

enum Act { kId = 0, kElu = 1, kSigmoid = 2, kTanh = 3 };

// The same formulas as the JAX package's `_apply_act` (ops/fused.py):
// elu as where(z > 0, z, exp(min(z, 0)) - 1), sigmoid as 1 / (1 + exp(-z)).
__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case kElu: return z > 0.f ? z : expf(fminf(z, 0.f)) - 1.f;
    case kSigmoid: return 1.f / (1.f + expf(-z));
    case kTanh: return tanhf(z);
    default: return z;
  }
}

// Products are summed kBlockK at a time into a partial sum, and the partial
// sums are added to the output in K order: the rounding error of a K-term
// sum grows with K / kBlockK + kBlockK instead of with K (a sequential
// chain over the 2500 inputs of the input encoder lay twice as far from a
// float64 referee as the plain version's blocked sums).
constexpr int kBlockK = 32;

// The offset of the next n floats of a layout being built at `off`.
__host__ __device__ inline int take(int& off, int n) {
  const int o = off;
  off += n;
  return o;
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace sqair
