// fused_vanilla_rnn and fused_gru forward: one recurrent cell step per launch.
//
// Replaces: sqair_tpu/ops/fused.py, `_fused_vrnn` (Pallas kernel
// `_vrnn_fwd_kernel`) and `_fused_gru_call` (Pallas kernel
// `_gru_fwd_kernel`).
//
//   vanilla RNN: h' = tanh(x W + h U + b)
//   GRU:         zr = sigmoid(x Wg + h Ug + bg), z, r = split(zr)
//                c  = tanh(x Wc + (r * h) Uc + bc),  h' = (1 - z) h + z c
//
// What bounds them on an H100 at the release model's shapes (f32, U = 256;
// N = 160 rows, or 480 for the propagation prior's GRU; d_x from 4 to 567):
// a step reads 0.4-0.8 MB of weights (vanilla RNN: (d_x + 256) x 256;
// GRU: (d_x + 256) x 768) and does 0.1-0.4 GFLOP of f32 FMA, i.e.
// 0.1-0.4 us at 3.35 TB/s and 2-6 us on the CUDA cores at 67 TFLOP/s.  Each
// step is one link of the sequential T x 2S cell chain, so launch latency,
// not either rate, is what the chain pays.
// What the design does about it: one launch per step and no intermediate
// in device memory.  The GRU runs its two dependent products in one block
// per kRows rows, in two phases: the gates go to shared memory, the block
// synchronises, forms r * h in shared memory and then runs the candidate
// product and the update.  Weights are streamed once per block through L2.
// Batching the chain's launches (CUDA graphs over T x 2S) is later work.
//
// The GRU's optional zr [N, 2U] and c [N, U] outputs are what its backward
// pass needs (training slice); the eval path passes null.

#include "common.cuh"

namespace sqair {

__global__ void __launch_bounds__(kThreads)
fused_vrnn_kernel(const float* __restrict__ x, const float* __restrict__ h,
                  const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ b, float* __restrict__ hn, int n, int dx,
                  int units) {
  extern __shared__ float stage[];  // kRows * kChunk
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  Acc acc;
  zero(acc);
  acc_global(acc, x + (size_t)row0 * dx, dx, rows, dx, w, units, units, stage);
  acc_global(acc, h + (size_t)row0 * units, units, rows, units, u, units, units, stage);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = threadIdx.x + c * kThreads;
    if (j < units) {
      const float bj = b[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) hn[(size_t)(row0 + r) * units + j] = tanhf(acc[c][r] + bj);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_gru_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ wg, const float* __restrict__ ug,
                 const float* __restrict__ bg, const float* __restrict__ wc,
                 const float* __restrict__ uc, const float* __restrict__ bc,
                 float* __restrict__ hn, float* __restrict__ zr_out,
                 float* __restrict__ c_out, int n, int dx, int units) {
  extern __shared__ float smem[];
  float* stage = smem;                         // kRows * kChunk
  float* zr = stage + kRows * kChunk;          // kRows * 2U
  float* rh = zr + kRows * 2 * units;          // kRows * U
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int u2 = 2 * units;

  // phase 1: gates
  Acc acc;
  zero(acc);
  acc_global(acc, x + (size_t)row0 * dx, dx, rows, dx, wg, u2, u2, stage);
  acc_global(acc, h + (size_t)row0 * units, units, rows, units, ug, u2, u2, stage);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = threadIdx.x + c * kThreads;
    if (j < u2) {
      const float bj = bg[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = 1.f / (1.f + expf(-(acc[c][r] + bj)));
        zr[r * u2 + j] = v;
        if (zr_out != nullptr && r < rows) zr_out[(size_t)(row0 + r) * u2 + j] = v;
      }
    }
  }
  __syncthreads();

  // r * h for the block's rows (rows past n read h as zero)
  for (int i = threadIdx.x; i < kRows * units; i += kThreads) {
    const int r = i / units, j = i - r * units;
    const float hv = r < rows ? h[(size_t)(row0 + r) * units + j] : 0.f;
    rh[i] = zr[r * u2 + units + j] * hv;
  }

  // phase 2: candidate and update (acc_global synchronises before reading)
  zero(acc);
  acc_global(acc, x + (size_t)row0 * dx, dx, rows, dx, wc, units, units, stage);
  __syncthreads();  // rh complete even when dx == 0
  acc_smem(acc, rh, units, units, uc, units, units);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = threadIdx.x + c * kThreads;
    if (j < units) {
      const float bj = bc[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const size_t o = (size_t)(row0 + r) * units + j;
          const float cv = tanhf(acc[c][r] + bj);
          const float z = zr[r * u2 + j];
          hn[o] = (1.f - z) * h[o] + z * cv;
          if (c_out != nullptr) c_out[o] = cv;
        }
      }
    }
  }
}

}  // namespace sqair

// x [n, dx], h [n, units], w [dx, units], u [units, units], b [units] ->
// hn [n, units]; all f32, contiguous and on the device.  Launches on
// `stream`, does not synchronise, allocates nothing, and returns the CUDA
// error code of the launch (0 on success).
extern "C" int sqair_fused_vanilla_rnn(const void* x, const void* h, const void* w,
                                       const void* u, const void* b, void* hn, int n,
                                       int dx, int units, void* stream) {
  using namespace sqair;
  if (n <= 0 || dx < 0 || units < 1 || units > kMaxWidth) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * kChunk;
  const int blocks = (n + kRows - 1) / kRows;
  fused_vrnn_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(b), static_cast<float*>(hn), n, dx, units);
  return (int)cudaGetLastError();
}

// x [n, dx], h [n, units], wg [dx, 2 units], ug [units, 2 units],
// bg [2 units], wc [dx, units], uc [units, units], bc [units] ->
// hn [n, units], and optionally zr [n, 2 units] and c [n, units] (null to
// skip).  Same contract as above.
extern "C" int sqair_fused_gru(const void* x, const void* h, const void* wg,
                               const void* ug, const void* bg, const void* wc,
                               const void* uc, const void* bc, void* hn, void* zr,
                               void* c, int n, int dx, int units, void* stream) {
  using namespace sqair;
  if (n <= 0 || dx < 0 || units < 1 || 2 * units > kMaxWidth) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kRows * (kChunk + 3 * units);
  cudaError_t err = allow_smem(fused_gru_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  fused_gru_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(wg), static_cast<const float*>(ug),
      static_cast<const float*>(bg), static_cast<const float*>(wc),
      static_cast<const float*>(uc), static_cast<const float*>(bc),
      static_cast<float*>(hn), static_cast<float*>(zr), static_cast<float*>(c), n, dx,
      units);
  return (int)cudaGetLastError();
}
