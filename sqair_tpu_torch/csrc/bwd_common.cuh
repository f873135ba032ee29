// Shared pieces of the hand-written backward kernels (fused_bwd.cu,
// fused_glimpse.cu, fused_prop.cu, fused_disc.cu): elu' and the other
// activations' derivatives read off the output, the products with a
// transposed weight, and the launch of phase B, the weight-gradient
// reduction in fixed row order that every one of them ends with.
#pragma once

#include "common.cuh"

namespace sqair {

constexpr int kOuterN = 32;   // batch rows of a phase-B chunk
constexpr int kMaxJobs = 24;  // dW matrices per phase-B launch

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
// Summed kBlockK products at a time, as acc_smem.
template <int NR>
__device__ __forceinline__ void acc_smem_t(float (&acc)[kMaxCols][NR], const float* a,
                                           int lda, int J, const float* __restrict__ w,
                                           int ldw, int col0, int n_cols) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = col0 + threadIdx.x + c * kThreads;
    if (col < n_cols) {
      const float* wc = w + (size_t)col * ldw;
      for (int j0 = 0; j0 < J; j0 += kBlockK) {
        const int j1 = min(j0 + kBlockK, J);
        float part[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) part[r] = 0.f;
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
          const float wv = __ldg(wc + j);
#pragma unroll
          for (int r = 0; r < NR; ++r) part[r] = fmaf(a[r * lda + j], wv, part[r]);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[c][r] += part[r];
      }
    }
  }
}

// out[(row0 + r) * ld + col] = acc[c][r] for the block's valid rows.
template <int NR>
__device__ __forceinline__ void store_rows(const float (&acc)[kMaxCols][NR],
                                           float* __restrict__ out, int ld, int row0,
                                           int rows, int col0, int n_cols) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = col0 + threadIdx.x + c * kThreads;
    if (col < n_cols) {
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < rows) out[(size_t)(row0 + r) * ld + col] = acc[c][r];
    }
  }
}

// --------------------------------------------------------------- phase B
struct OuterJob {
  const float* a;   // [N, K], row stride lda
  const float* dz;  // [N, J], row stride ldz
  float* dw;        // [K, J]
  float* db;        // [J] or null
  int lda, ldz, K, J;
  // an optional second segment of N rows with the same strides, summed
  // after the first (a layer applied twice per row, e.g. to two glimpses)
  const float* a2;
  const float* dz2;
  int tiles_j, tile0;  // set by launch_tiles
};

struct OuterArgs {
  OuterJob job[kMaxJobs];
  int n_jobs;
  int n;
};

// dw = a^T dz and db = sum over the rows of dz for every job, in fixed row
// order, the second segment's rows after the first's (tile_reduce_kernel,
// defined once in fused_bwd.cu).
cudaError_t launch_tiles(OuterArgs& p, cudaStream_t stream);

}  // namespace sqair
