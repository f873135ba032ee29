// Shared pieces of the hand-written backward kernels (fused_bwd.cu,
// fused_glimpse.cu, fused_prop.cu, fused_disc.cu): elu' and the other
// activations' derivatives read off the output, and the launch of phase B,
// the weight-gradient reduction in fixed row order that every one of them
// ends with.
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
