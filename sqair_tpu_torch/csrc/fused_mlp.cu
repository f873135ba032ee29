// fused_mlp forward: act_n(... act_1(x W_1 + b_1) ... W_n + b_n) in one launch.
//
// Replaces: sqair_tpu/ops/fused.py, `_pallas_forward` (the `_fwd_kernel`
// Pallas TPU kernel behind `fused_mlp`).  Like it, the whole stack runs in
// one launch and the activations between layers never leave the chip.
//
// What bounds it on an H100 at the release model's shapes (f32; 340 of a
// train step's 352 calls have N = 160 rows, d_in <= 2500, layers 1-400
// wide): not the card's rates.  The largest stack, the input encoder
// (160 x 2500 -> 256 -> 256), moves 4.4 MB = 1.3 us at 3.35 TB/s and does
// 0.23 GFLOP = 3.4 us at 67 TFLOP/s; the others take well under a
// microsecond at either rate.  What a call pays is latency: each output is
// one dependent chain of K multiply-adds, and a block per 8 rows fills 20
// of the 132 SMs at 160 rows.
//
// The design:
// - A thread block cluster of C blocks (1-8, picked on the host by
//   `ops/fused.py:mlp_fwd_geometry` so that row tiles x C >= 132 where n
//   allows it: C = 8 at 160 rows, 1 at 1600 and 4800) shares one tile of
//   kTileRows rows.  Every layer's output columns are split among the C
//   blocks in chunks of 32.  A block computes its columns for the tile's
//   rows and writes them into every block's activation buffer through
//   distributed shared memory (`map_shared_rank`); after `cluster.sync()`
//   the next layer reads the whole row from its own shared memory.
// - Inside a block, each of the 8 warps owns a unit of work: one 32-row
//   block of K (kBlockK) for one 32-column chunk, 2 rows x 4 columns a
//   lane.  The warps of a round take up to 8 K-blocks of the same chunks
//   at once (`wk` a layer, from the host) and write their partial sums to
//   shared memory; each output's owner then adds them in K order.  So
//   every output is the same chain acc = ((p_0 + p_1) + p_2) + ... of
//   32-product partial sums as a single thread walking K would form: the
//   kernel gives the bits of the one-block-per-8-rows kernel it replaced.
// - Each round's weights (and the first layer's x) are staged by cp.async
//   (16 bytes where aligned) into a double-buffered ring while the round
//   before computes; the next layer's first round is fetched across the
//   layer boundary.  A lane reads 4 K-steps of its 2 rows of x and of its
//   4 weight columns as float4s and does 32 FMAs with them; the staged x
//   and activation rows are padded to 4 floats past a multiple of 32, so
//   that the 4 rows a warp reads at once fall in other banks.
//
// What is still left: a round costs several times its FMAs; timing its
// phases with clock64 (in a scratch copy) showed the copies landing before
// the wait and the time spread over issuing the copies, the units'
// shared-memory reads and the ordered combine.  The 160-row tiles re-read each
// weight from L2 once per row tile (20 times at 160 rows); a cluster that
// shared weight columns across row tiles would read them once.  At 4800
// rows (C = 1, 600 blocks of 23 rounds) the kernel is slower than one
// block per 8 rows was.  No tensor cores: f32 has none without TF32, which
// the port keeps off.
//
// The optional `saved` pointers receive each layer's post-activation (the
// backward pass of the training slice needs them); the eval path passes
// null for all of them.

#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "tile_sums.cuh"

namespace cg = cooperative_groups;

namespace sqair {

constexpr int kMaxLayers = 4;
constexpr int kXLd = kBlockK + 4;                     // row stride of staged x
constexpr int kStageX = kWarps * kTileRows * kXLd;    // a round's x (first layer)
constexpr int kStage = kStageW + kStageX;

struct MlpArgs {
  const float* x;
  float* y;
  int n;
  int n_layers;
  int cluster;  // blocks of a cluster, splitting each layer's columns
  int act_ld;   // row stride of the activation buffers (0 with one layer)
  int out_ld;   // row stride of y and the saved layers (0: each its own width)
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
  int wk[kMaxLayers];  // K-blocks a round of layer l takes at once (1, 2, 4, 8)
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float* saved[kMaxLayers];
};

// A block's share of layer l: chunks [chunk0, chunk0 + J) of its 32-column
// chunks, in P passes of WJ = 2^wj_log chunks, each of Q rounds of WK
// K-blocks.  Worked out once a launch, so that a round divides nothing.
struct LayerPlan {
  int K, D, nkb, J, col0, WK, WJ, wj_log, P, Q;
};

__device__ inline LayerPlan plan_layer(const MlpArgs& p, int l, int rank) {
  LayerPlan L;
  L.K = p.dims[l];
  L.D = p.dims[l + 1];
  L.nkb = cdiv(L.K, kBlockK);
  const int chunks = cdiv(L.D, kChunk32);
  const int per_block = cdiv(chunks, p.cluster);
  const int chunk0 = rank * per_block;
  L.J = max(0, min(per_block, chunks - chunk0));
  L.col0 = chunk0 * kChunk32;
  L.WK = p.wk[l];
  L.WJ = kWarps / L.WK;
  L.wj_log = L.WJ == 8 ? 3 : L.WJ == 4 ? 2 : L.WJ == 2 ? 1 : 0;
  L.P = cdiv(L.J, L.WJ);
  L.Q = cdiv(L.nkb, L.WK);
  return L;
}

// Stages round (pass, q) of layer l: unit u = wk * WJ + wc takes K-block
// q * WK + wk of chunk pass * WJ + wc; the first layer also stages those
// K-blocks of x for the tile's rows.  Thread t copies row t / 8 and float4
// t % 8 of every unit's [32 k][32 cols] weights.
__device__ __forceinline__ void issue_round(const MlpArgs& p, const LayerPlan L, int l,
                                            int pass, int q, float* stage, int row0, int rows) {
  const int kr = threadIdx.x >> 3, f4 = (threadIdx.x & 7) * 4;
  const float* w = p.w[l] + (size_t)kr * L.D + L.col0 + f4;
  float* dst = stage + kr * kChunk32 + f4;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int wk = u >> L.wj_log, wc = u & (L.WJ - 1);
    const int kb = q * L.WK + wk, chunk = pass * L.WJ + wc;
    const int c = chunk * kChunk32;
    if (chunk < L.J && kb * kBlockK + kr < L.K)
      copy4_async(dst + u * kUnitW, w + (size_t)kb * kBlockK * L.D + c, L.D - L.col0 - f4 - c);
  }
  if (l == 0) {
    float* sx = stage + kStageW;
    for (int i = threadIdx.x; i < L.WK * kTileRows * 8; i += kThreads) {
      const int wk = i >> 6, r = (i >> 3) & 7, f = (i & 7) * 4;
      const int k = (q * L.WK + wk) * kBlockK + f;
      if (r < rows && k < L.K)
        copy4_async(sx + (wk * kTileRows + r) * kXLd + f, p.x + (size_t)(row0 + r) * L.K + k,
                    L.K - k);
    }
  }
}

// Steps (l, pass, q) to the block's next round: rounds run layer by layer,
// pass by pass; l == n_layers past the last one.
__device__ inline void next_round(const LayerPlan* plans, int n_layers, int& l, int& pass,
                                 int& q) {
  if (++q < plans[l].Q) return;
  q = 0;
  if (++pass < plans[l].P) return;
  pass = 0;
  do {
    ++l;
  } while (l < n_layers && plans[l].P == 0);
}

__global__ void __launch_bounds__(kThreads, 2) fused_mlp_kernel(MlpArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                   // 2 x kStage
  float* parts = smem + 2 * kStage;       // kParts
  float* act = parts + kParts;            // 2 x kTileRows x act_ld
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / p.cluster) * kTileRows;
  const int rows = min(kTileRows, p.n - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  __shared__ LayerPlan plans[kMaxLayers];
  if (threadIdx.x < p.n_layers) plans[threadIdx.x] = plan_layer(p, threadIdx.x, rank);
  __syncthreads();
  // the round to fetch next: the block's first, then one ahead of the one
  // that computes
  int fl = 0, fpass = 0, fq = 0;
  while (fl < p.n_layers && plans[fl].P == 0) ++fl;
  if (fl < p.n_layers) issue_round(p, plans[fl], fl, fpass, fq, stages, row0, rows);
  copy_commit();
  if (fl < p.n_layers) next_round(plans, p.n_layers, fl, fpass, fq);
  // every block of the cluster runs before any writes into its shared memory
  cluster.sync();

  int t = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const LayerPlan L = plans[l];
    const bool last = l == p.n_layers - 1;
    const float* act_in = act + ((l - 1) & 1) * kTileRows * p.act_ld;
    float* act_out = act + (l & 1) * kTileRows * p.act_ld;
    for (int pass = 0; pass < L.P; ++pass) {
      float acc[kWarps];
#pragma unroll
      for (int i = 0; i < kWarps; ++i) acc[i] = 0.f;
      for (int q = 0; q < L.Q; ++q, ++t) {
        if (fl < p.n_layers) {
          issue_round(p, plans[fl], fl, fpass, fq, stages + ((t + 1) & 1) * kStage, row0, rows);
          next_round(plans, p.n_layers, fl, fpass, fq);
        }
        copy_commit();
        copy_wait<1>();
        __syncthreads();  // round t's stage has landed for every thread
        const float* stage = stages + (t & 1) * kStage;
        const int wk = warp >> L.wj_log, wc = warp & (L.WJ - 1);
        const int kb = q * L.WK + wk;
        if (kb < L.nkb && pass * L.WJ + wc < L.J) {
          const float* a;
          int lda;
          if (l == 0) {
            a = stage + kStageW + wk * kTileRows * kXLd;
            lda = kXLd;
          } else {
            a = act_in + kb * kBlockK;
            lda = p.act_ld;
          }
          unit_sums(parts + warp * kTileRows * kChunk32, a, lda, stage + warp * kUnitW,
                    min(kBlockK, L.K - kb * kBlockK));
        }
        __syncthreads();  // every unit's partial sums are in `parts`
        // thread (warp, lane) owns row `warp`, column `lane` of each chunk
        // i of the pass, and adds the round's K-blocks in order
        add_round(acc, parts, L.wj_log, min(L.WJ, L.J - pass * L.WJ),
                  min(L.WK, L.nkb - q * L.WK));
      }
      // the pass's outputs: row `warp`, column `lane` of each chunk
      const int r = warp;
      const size_t out_ld = p.out_ld > 0 ? p.out_ld : L.D;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int chunk = pass * L.WJ + i;
        const int col = L.col0 + chunk * kChunk32 + lane;
        if (i < L.WJ && chunk < L.J && col < L.D) {
          const float v = apply_act(acc[i] + p.b[l][col], p.acts[l]);
          if (r < rows) {
            if (last) p.y[(row0 + r) * out_ld + col] = v;
            if (p.saved[l] != nullptr) p.saved[l][(row0 + r) * out_ld + col] = v;
          }
          if (!last) {
            for (int peer = 0; peer < p.cluster; ++peer)
              cluster.map_shared_rank(act_out, peer)[r * p.act_ld + col] = v;
          }
        }
      }
    }
    // the layer's activations are in every block's buffer; the buffer this
    // layer read is written by the layer after next, past this barrier
    if (!last) cluster.sync();
  }
}

cudaError_t launch_mlp_fwd(const float* x, float* y, int n, int n_layers, const int* dims,
                           const int* acts, const float* const* w, const float* const* b,
                           float* const* saved, int out_ld, const int* geom,
                           cudaStream_t stream) {
  if (n <= 0 || n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  MlpArgs p{};
  p.x = x;
  p.y = y;
  p.n = n;
  p.n_layers = n_layers;
  p.cluster = geom[1];
  p.out_ld = out_ld;
  int max_hidden = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || (l > 0 && dims[l] > kMaxWidth)) return cudaErrorInvalidValue;
    if (l > 0 && out_ld != 0 && out_ld < dims[l]) return cudaErrorInvalidValue;
    p.dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < kId || acts[l] > kTanh) return cudaErrorInvalidValue;
    const int wk = geom[4 + l];
    if (wk != 1 && wk != 2 && wk != 4 && wk != 8) return cudaErrorInvalidValue;
    p.acts[l] = acts[l];
    p.wk[l] = wk;
    p.w[l] = w[l];
    p.b[l] = b[l];
    p.saved[l] = saved == nullptr ? nullptr : saved[l];
    if (l < n_layers - 1 && dims[l + 1] > max_hidden) max_hidden = dims[l + 1];
  }
  // a multiple of 4 floats (float4 reads) that is 4 past a multiple of 32:
  // the 4 rows a warp's float4 reads touch at once fall in other banks
  p.act_ld = max_hidden > 0 ? (max_hidden + 31) / 32 * 32 + 4 : 0;
  const int tiles = cdiv(n, kTileRows);
  const size_t smem = sizeof(float) * (2 * (size_t)kStage + kParts + 2 * kTileRows * p.act_ld);
  if (geom[0] != kTileRows || p.cluster < 1 || p.cluster > kMaxCluster ||
      geom[2] != tiles * p.cluster || (size_t)geom[3] != smem)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fused_mlp_kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_mlp_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sqair

// x [n, dims[0]] -> y [n, dims[n_layers]], weights w[l] [dims[l], dims[l+1]]
// and biases b[l] [dims[l+1]], all f32, contiguous and on the device.
// `dims`, `acts`, `w`, `b` and `saved` are host arrays of n_layers (+1 for
// dims) entries; `saved` may be null, and so may any entry of it.  `geom`
// is the host's launch geometry (ops/fused.py mlp_fwd_geometry): tile rows,
// cluster size, blocks, dynamic shared memory bytes, then each layer's
// K-blocks a round; the launch is refused unless it matches this file's.
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns the CUDA error code of the launch (0 on success).
extern "C" int sqair_fused_mlp(const void* x, void* y, int n, int n_layers,
                               const int* dims, const int* acts,
                               const void* const* w, const void* const* b,
                               void* const* saved, const int* geom, void* stream) {
  using namespace sqair;
  return (int)launch_mlp_fwd(static_cast<const float*>(x), static_cast<float*>(y), n, n_layers,
                             dims, acts, reinterpret_cast<const float* const*>(w),
                             reinterpret_cast<const float* const*>(b),
                             reinterpret_cast<float* const*>(saved), 0, geom,
                             static_cast<cudaStream_t>(stream));
}
