// Shared pieces of the hand-written backward kernels (fused_bwd.cu,
// fused_glimpse.cu): elu' and the other activations' derivatives read off
// the output, the products with a transposed weight, and the launch of
// phase B, the column-parallel weight-gradient reduction in fixed order.
#pragma once

#include "common.cuh"

namespace sqair {

constexpr int kOuterThreads = 128;  // dW columns of a phase-B tile
constexpr int kOuterK = 8;          // dW rows of a phase-B tile
constexpr int kOuterN = 32;         // batch rows staged at a time
constexpr int kMaxJobs = 5;         // dW matrices per phase-B launch

// d act(z) / dz written with the post-activation a, exactly as the JAX
// package's `_act_grad_from_output` (elu: 1 for a > 0, else a + 1).
__device__ __forceinline__ float act_grad_from_output(float a, int act) {
  switch (act) {
    case kElu: return a > 0.f ? 1.f : a + 1.f;
    case kSigmoid: return a * (1.f - a);
    case kTanh: return 1.f - a * a;
    default: return 1.f;
  }
}

// acc[c][r] += sum_{j < J} a[r * lda + j] * w[col * ldw + j], for the
// columns col = col0 + threadIdx.x + c * kThreads < n_cols: a product with
// the TRANSPOSE of the row-major w [n_cols, ldw].  `a` is in shared memory.
__device__ __forceinline__ void acc_smem_t(Acc& acc, const float* a, int lda, int J,
                                           const float* __restrict__ w, int ldw, int col0,
                                           int n_cols) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = col0 + threadIdx.x + c * kThreads;
    if (col < n_cols) {
      const float* wc = w + (size_t)col * ldw;
#pragma unroll 4
      for (int j = 0; j < J; ++j) {
        const float wv = __ldg(wc + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] = fmaf(a[r * lda + j], wv, acc[c][r]);
      }
    }
  }
}

// out[(row0 + r) * ld + col] = acc[c][r] for the block's valid rows.
__device__ __forceinline__ void store_rows(const Acc& acc, float* __restrict__ out, int ld,
                                           int row0, int rows, int col0, int n_cols) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = col0 + threadIdx.x + c * kThreads;
    if (col < n_cols) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) out[(size_t)(row0 + r) * ld + col] = acc[c][r];
    }
  }
}

// --------------------------------------------------------------- phase B
struct OuterJob {
  const float* a;   // [N, K], row stride lda
  const float* dz;  // [N, J], row stride J
  float* dw;        // [K, J]
  float* db;        // [J] or null
  int lda, K, J;
  int tiles_j;      // column tiles of this job
  int tile0;        // first block index of this job
};

struct OuterArgs {
  OuterJob job[kMaxJobs];
  int n_jobs;
  int n;
};

// dw = a^T dz and db = sum over the rows of dz for every job, in fixed row
// order (outer_reduce_kernel, defined once in fused_bwd.cu).
cudaError_t launch_outer(OuterArgs& p, cudaStream_t stream);

}  // namespace sqair
