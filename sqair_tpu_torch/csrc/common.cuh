// Shared pieces of the hand-written kernels (through bwd_common.cuh,
// glimpse_common.cuh and tile_sums.cuh all of them).
//
// Every kernel but those that tile_sums.cuh serves (the MLP and cell
// forwards and the cluster kernels of cluster_dense.cuh, whose rounds split
// K over the warps) has the same shape: one
// block of kThreads threads owns kRows rows of the batch, and each thread
// owns up to kMaxCols output columns (column j = threadIdx.x + c *
// kThreads).  A thread keeps
// kMaxCols x kRows float accumulators in registers.  Weights are read from
// device memory (coalesced: neighbouring threads read neighbouring
// columns of a row-major [K, D] matrix); the block's rows of the left
// operand are read from shared memory, where every thread of a warp reads
// the same word (a broadcast, no bank conflict).  All arithmetic is f32
// with f32 accumulation, summed over k in increasing order, kBlockK
// products at a time (acc_smem).
#pragma once

#include <cuda_runtime.h>

namespace sqair {

constexpr int kThreads = 256;
constexpr int kRows = 8;                            // batch rows per block
constexpr int kMaxCols = 4;                         // output columns per thread
constexpr int kMaxWidth = kThreads * kMaxCols;      // widest layer: 1024
constexpr int kChunk = 128;                         // staged columns of a global operand

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

// kMaxCols x NR accumulators: column c of the thread, row r of the block
template <int NR>
using AccN = float[kMaxCols][NR];
using Acc = AccN<kRows>;

template <int NR>
__device__ __forceinline__ void zero(float (&acc)[kMaxCols][NR]) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[c][r] = 0.f;
}

// Products are summed kBlockK at a time into a partial sum, which is then
// added to the accumulator: the rounding error of a K-term sum grows with
// K / kBlockK + kBlockK instead of with K (a sequential chain over the
// 2500 inputs of the input encoder lay twice as far from a float64
// referee as the plain version's blocked sums).
constexpr int kBlockK = 32;

// acc[c][r] += sum_{k < K} a[r * lda + k] * w[k * ldw + j_c], with `a` in
// shared memory and j_c = threadIdx.x + c * kThreads < n_cols.
template <int NR>
__device__ __forceinline__ void acc_smem(float (&acc)[kMaxCols][NR], const float* a, int lda,
                                         int K, const float* __restrict__ w, int ldw,
                                         int n_cols) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = threadIdx.x + c * kThreads;
    if (j < n_cols) {
      const float* wj = w + j;
      for (int k0 = 0; k0 < K; k0 += kBlockK) {
        const int k1 = min(k0 + kBlockK, K);
        float part[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) part[r] = 0.f;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) {
          const float wk = __ldg(wj + (size_t)k * ldw);
#pragma unroll
          for (int r = 0; r < NR; ++r) part[r] = fmaf(a[r * lda + k], wk, part[r]);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[c][r] += part[r];
      }
    }
  }
}

// The same product with the left operand in device memory: rows
// [0, n_rows) of the row-major matrix `a` (row stride lda), columns
// [0, K).  Columns are staged through `stage` (kRows * kChunk floats of
// shared memory) kChunk at a time; rows past n_rows read as zero.  Every
// thread of the block must call this (it synchronises).
__device__ __forceinline__ void acc_global(Acc& acc, const float* __restrict__ a, int lda,
                                           int n_rows, int K, const float* __restrict__ w,
                                           int ldw, int n_cols, float* stage) {
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int i = threadIdx.x; i < kRows * kc; i += kThreads) {
      const int r = i / kc, k = i - r * kc;
      stage[r * kChunk + k] = r < n_rows ? a[(size_t)r * lda + k0 + k] : 0.f;
    }
    __syncthreads();
    acc_smem(acc, stage, kChunk, kc, w + (size_t)k0 * ldw, ldw, n_cols);
  }
}

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
