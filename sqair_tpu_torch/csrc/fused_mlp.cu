// fused_mlp forward: act_n(... act_1(x W_1 + b_1) ... W_n + b_n) in one launch.
//
// Replaces: sqair_tpu/ops/fused.py, `_pallas_forward` (the `_fwd_kernel`
// Pallas TPU kernel behind `fused_mlp`).  Like it, the whole stack runs in
// one launch and the activations between layers never leave the chip.
//
// What bounds it on an H100 at the release model's shapes (f32, N = 160 or
// 480 rows, d_in <= 2500, layers 128-400 wide): the work is small.  The
// largest stack, the input encoder (160 x 2500 -> 256 -> 256), moves
// 4.4 MB (2.8 MB of weights, 1.6 MB of input) = 1.3 us at 3.35 TB/s and
// does 0.23 GFLOP of f32 FMA = 3.4 us on the CUDA cores at 67 TFLOP/s; the
// other stacks read 0.01-0.8 MB of weights and take well under a
// microsecond at either rate, so a launch costs more than its arithmetic.
// What the design does about it: one launch per stack, each block keeps
// its kRows rows' activations in shared memory between layers, and the
// weights are streamed once per block, coalesced, through L2.  It does not
// use the tensor cores (f32 has none without TF32, which the port keeps
// off), and with N / kRows blocks (20 or 60) most of the 132 SMs idle:
// splitting K or the columns over more blocks is later work.
//
// The optional `saved` pointers receive each layer's post-activation (the
// backward pass of the training slice needs them); the eval path passes
// null for all of them.

#include "common.cuh"

namespace sqair {

constexpr int kMaxLayers = 4;

struct MlpArgs {
  const float* x;
  float* y;
  int n;
  int n_layers;
  int max_hidden;  // widest layer output that stays in shared memory
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float* saved[kMaxLayers];
};

__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(MlpArgs p) {
  extern __shared__ float smem[];
  float* stage = smem;                            // kRows * kChunk
  float* buf[2] = {stage + kRows * kChunk,        // kRows * max_hidden each
                   stage + kRows * kChunk + kRows * p.max_hidden};
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.n - row0);

  for (int l = 0; l < p.n_layers; ++l) {
    const int K = p.dims[l], D = p.dims[l + 1];
    const bool last = l == p.n_layers - 1;
    Acc acc;
    zero(acc);
    if (l == 0) {
      acc_global(acc, p.x + (size_t)row0 * K, K, rows, K, p.w[0], D, D, stage);
    } else {
      // layer l - 1 wrote buf[(l - 1) & 1] and synchronised below
      acc_smem(acc, buf[(l - 1) & 1], K, K, p.w[l], D, D);
    }
    float* out = buf[l & 1];
    float* saved = p.saved[l];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j < D) {
        const float bj = p.b[l][j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float v = apply_act(acc[c][r] + bj, p.acts[l]);
          if (!last) out[r * D + j] = v;
          if (r < rows) {
            if (last) p.y[(size_t)(row0 + r) * D + j] = v;
            if (saved != nullptr) saved[(size_t)(row0 + r) * D + j] = v;
          }
        }
      }
    }
    // the buffer just written is read by the next layer; the one written
    // before it (read by this layer) is overwritten by the next layer
    __syncthreads();
  }
}

}  // namespace sqair

// x [n, dims[0]] -> y [n, dims[n_layers]], weights w[l] [dims[l], dims[l+1]]
// and biases b[l] [dims[l+1]], all f32, contiguous and on the device.
// `dims`, `acts`, `w`, `b` and `saved` are host arrays of n_layers (+1 for
// dims) entries; `saved` may be null, and so may any entry of it.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns the CUDA error code of the launch (0 on success).
extern "C" int sqair_fused_mlp(const void* x, void* y, int n, int n_layers,
                               const int* dims, const int* acts,
                               const void* const* w, const void* const* b,
                               void* const* saved, void* stream) {
  using namespace sqair;
  if (n <= 0 || n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  MlpArgs p{};
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.n = n;
  p.n_layers = n_layers;
  p.max_hidden = 1;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || (l > 0 && dims[l] > kMaxWidth)) return (int)cudaErrorInvalidValue;
    p.dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < kId || acts[l] > kTanh) return (int)cudaErrorInvalidValue;
    p.acts[l] = acts[l];
    p.w[l] = static_cast<const float*>(w[l]);
    p.b[l] = static_cast<const float*>(b[l]);
    p.saved[l] = saved == nullptr ? nullptr : static_cast<float*>(saved[l]);
    if (l < n_layers - 1 && dims[l + 1] > p.max_hidden) p.max_hidden = dims[l + 1];
  }
  const size_t smem = sizeof(float) * (size_t)kRows * (kChunk + 2 * p.max_hidden);
  cudaError_t err = allow_smem(fused_mlp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  fused_mlp_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
