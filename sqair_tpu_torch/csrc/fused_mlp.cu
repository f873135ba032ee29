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
// weight from L2 once per row tile (20 times at 160 rows); one layer of long
// K (the conv encoders) goes to the long-K kernel at the end of this file
// instead (ops/fused.py is_long_k), whose staged weights serve 32 rows.  At 4800
// rows (C = 1, 600 blocks of 23 rounds) the kernel is slower than one
// block per 8 rows was.  No tensor cores: f32 has none without TF32, which
// the port keeps off.
//
// The optional `saved` pointers receive each layer's post-activation (the
// backward pass of the training slice needs them); the eval path passes
// null for all of them.

#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "cluster_dense.cuh"
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

// ------------------------------------------------- one long-K layer
// The conv model's encoders end in one linear layer of long K at 160 rows
// (10816 -> 256 and 1600 -> 256).  The kernel above walks all of K in every
// block for 8 rows, re-reading W from L2 once per 8 rows (20 times at 160
// rows), and its unit (2 rows x 4 columns a lane) reads shared memory 3x
// faster than its FMAs can use it: a round takes ~3x its FMA time in
// shared-memory wavefronts (clock64 in a marked copy).
// Here a tile of kLongRows rows by kLongCols columns belongs to a cluster of
// KS blocks that split its K-blocks of 32 round-robin (rank s takes s, s +
// KS, s + 2 KS, ...), so every staged weight serves 32 rows.  A block's
// round takes 4 of its K-blocks ([2][32 k][32 cols] of W and [32 rows][36]
// of x each, a double-buffered ring of rounds).  Its 8 compute warps take
// them in pairs, 16 rows each, 4 rows x 8 columns a lane (`wide_part`: 12
// float4 reads a lane for 128 FMAs a warp, against 24), and a lane stores
// its partial sums p_j straight into the shared memory of the block that
// owns those outputs (`per` consecutive outputs of the tile a rank), round
// r's into buffer r % 3.  4 helper warps stage the rounds (cp.async; named
// barriers kFull / kEmpty with the compute warps) and own the outputs: past
// cluster barrier r (every block's round-r sums stored) they add round r's
// p_j in K order while the compute warps go on.  Each owner's sum is acc =
// ((p_0 + p_1) + p_2) + ... of the same p_j, so every output keeps the bits
// of the kernel above; the bias and the activation follow, as there.  A
// compute warp stores round r's sums past barrier r - 1, which every owner
// passes only after adding round r - 2's, so no buffer is written while
// it is read.
constexpr int kLongRows = 32;                          // rows of a tile
constexpr int kLongChunks = 2;                         // 32-column chunks of a tile
constexpr int kLongCols = kLongChunks * kChunk32;      // columns of a tile
constexpr int kLongTile = kLongRows * kLongCols;       // outputs of a tile
constexpr int kLongSlots = kWarps / 2;                 // K-blocks of a round
constexpr int kLongSlot = kLongChunks * kUnitW + kLongRows * kXLd;  // a K-block's stage
constexpr int kLongStage = kLongSlots * kLongSlot;     // a round's stage
constexpr int kLongBufs = 3;                           // the owners' buffers
constexpr int kHelpers = 128;                          // threads of the helper warps
constexpr int kLongThreads = kThreads + kHelpers;
constexpr int kLongOwn = kLongTile / (4 * kHelpers);   // float4s of outputs an owner adds
constexpr int kFull = 1, kEmpty = 3;                   // named barriers, one a ring stage

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

struct LongKArgs {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  int n, K, D, act;
  int cluster;     // KS: blocks of a cluster, splitting K
  int col_tiles;   // column tiles of a row tile
  int per;         // outputs of the tile a block owns (a multiple of 4)
};

// part[i][4 c + j] += a_i[k + m] w_c[k + m][j] for m < 4, in order: the
// lane's 4 rows of x (a0, row stride kXLd) and its float4 of columns of
// each of the two staged chunks (w0, [2][32 k][32]).
__device__ __forceinline__ void wide_step4(float (&part)[4][8], const float* a0, const float* w0,
                                           int k) {
  float xs[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(a0 + i * kXLd + k);
    xs[i][0] = v.x;
    xs[i][1] = v.y;
    xs[i][2] = v.z;
    xs[i][3] = v.w;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 u = *reinterpret_cast<const float4*>(w0 + (k + m) * kChunk32);
    const float4 v = *reinterpret_cast<const float4*>(w0 + kUnitW + (k + m) * kChunk32);
    const float ws[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = fmaf(xs[i][m], ws[j], part[i][j]);
  }
}

// A lane's partial sums over kn <= 32 K-steps: rows 4 rg .. 4 rg + 3 of the
// staged x `a` (row stride kXLd) and columns 4 cg .. 4 cg + 3 of each of
// the two staged chunks `w` ([2][32 k][32]); part[i][4 c + j] is row
// 4 rg + i, column 32 c + 4 cg + j.  Each is summed in K order from zero,
// as unit_sums sums it.
__device__ __forceinline__ void wide_part(float (&part)[4][8], const float* a, const float* w,
                                          int rg, int cg, int kn) {
  const float* a0 = a + 4 * rg * kXLd;
  const float* w0 = w + 4 * cg;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
  int k = 0;
  if (kn == kBlockK) {  // a whole K-block, unrolled so that loads run ahead
#pragma unroll
    for (int k4 = 0; k4 < kBlockK; k4 += 4) wide_step4(part, a0, w0, k4);
    k = kBlockK;
  }
  for (; k + 4 <= kn; k += 4) wide_step4(part, a0, w0, k);
  for (; k < kn; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[i][j] = fmaf(a0[i * kXLd + k], w0[(j >> 2) * kUnitW + k * kChunk32 + (j & 3)],
                          part[i][j]);
  }
}

// A helper thread's share (t of kHelpers) of this block's K-blocks 4 r ..
// 4 r + 3 (of rank, rank + KS, ...) into `stage`: each K-block's weights
// [2][32 k][32 cols] and x [32 rows][32 k], a float4 a copy.
__device__ __forceinline__ void stage_long_k_round(const LongKArgs& p, int r, int rank, int mine,
                                                   int row0, int col0, int rows, int t,
                                                   float* stage) {
  constexpr int kW4 = kLongChunks * kBlockK * 8, kX4 = kLongRows * 8;  // float4s of a K-block
#pragma unroll 1
  for (int s = 0; s < kLongSlots; ++s) {
    const int i = r * kLongSlots + s;
    if (i >= mine) break;
    const int k0 = (rank + p.cluster * i) * kBlockK;
    float* slot = stage + s * kLongSlot;
    for (int c4 = t; c4 < kW4 + kX4; c4 += kHelpers) {
      const int f4 = (c4 & 7) * 4;
      if (c4 < kW4) {
        const int c = c4 >> 8, kr = (c4 >> 3) & 31;
        const int col = col0 + c * kChunk32 + f4;
        if (k0 + kr < p.K && col < p.D)
          copy4_async(slot + c * kUnitW + kr * kChunk32 + f4,
                      p.w + (size_t)(k0 + kr) * p.D + col, p.D - col);
      } else {
        const int r = (c4 - kW4) >> 3;
        if (r < rows && k0 + f4 < p.K)
          copy4_async(slot + kLongChunks * kUnitW + r * kXLd + f4,
                      p.x + (size_t)(row0 + r) * p.K + k0 + f4, p.K - k0 - f4);
      }
    }
  }
}

__global__ void __launch_bounds__(kLongThreads, 1) fused_mlp_long_k_kernel(LongKArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // 2 x kLongStage
  float* sums = ring + 2 * kLongStage;      // kLongBufs x [kLongSlots KS K-blocks][per]
  cg::cluster_group cluster = cg::this_cluster();
  const int KS = p.cluster, rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / KS;
  const int rt = tile / p.col_tiles;
  const int row0 = rt * kLongRows, col0 = (tile - rt * p.col_tiles) * kLongCols;
  const int rows = min(kLongRows, p.n - row0);
  const int nkb = cdiv(p.K, kBlockK);
  const int mine = rank < nkb ? cdiv(nkb - rank, KS) : 0;  // K-blocks of this block
  const int rounds = cdiv(cdiv(nkb, KS), kLongSlots);      // the same in every block
  const int span = kLongSlots * KS;                         // K-blocks of a round
  const int buf_floats = span * p.per;

  cluster_arrive_relaxed();
  if (threadIdx.x >= kThreads) {
    // helpers: the ring's copies and the owners' sums
    const int t = threadIdx.x - kThreads;
    const int lo = rank * p.per, hi = min(kLongTile, lo + p.per);
    if (rounds > 0) stage_long_k_round(p, 0, rank, mine, row0, col0, rows, t, ring);
    copy_commit();
    copy_wait<0>();
    named_arrive(kFull, kLongThreads);
    cluster_wait();  // every block of the cluster runs before any writes into its shared memory
    float4 acc[kLongOwn];
#pragma unroll
    for (int e = 0; e < kLongOwn; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < rounds; ++r) {
      const bool next = r + 1 < rounds;
      if (next) {
        if (r >= 1) named_sync(kEmpty + ((r + 1) & 1), kLongThreads);  // round r - 1 is read
        stage_long_k_round(p, r + 1, rank, mine, row0, col0, rows, t,
                           ring + ((r + 1) & 1) * kLongStage);
      }
      copy_commit();
      if (next) {
        copy_wait<0>();
        named_arrive(kFull + ((r + 1) & 1), kLongThreads);  // round r + 1 has landed
      }
      cluster_arrive_relaxed();
      cluster_wait();  // every block's sums of round r are stored
      const float* buf = sums + (r % kLongBufs) * buf_floats;
      const int nj = min(span, nkb - r * span);
#pragma unroll
      for (int e = 0; e < kLongOwn; ++e) {
        const int o = lo + 4 * (t + e * kHelpers);
        if (o < hi) {
          float4 s4 = acc[e];
#pragma unroll 4
          for (int jj = 0; jj < nj; ++jj) {
            const float4 v = *reinterpret_cast<const float4*>(buf + jj * p.per + (o - lo));
            s4.x += v.x;
            s4.y += v.y;
            s4.z += v.z;
            s4.w += v.w;
          }
          acc[e] = s4;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kLongOwn; ++e) {
      const int o = lo + 4 * (t + e * kHelpers);
      if (o < hi) {
        const float v[4] = {acc[e].x, acc[e].y, acc[e].z, acc[e].w};
        const int r = o / kLongCols, col = col0 + o % kLongCols;
        if (r < rows) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (col + u < p.D)
              p.y[(size_t)(row0 + r) * p.D + col + u] = apply_act(v[u] + p.b[col + u], p.act);
        }
      }
    }
    return;
  }

  // the compute warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp >> 1, h = warp & 1, rg = lane >> 3, cg = lane & 7;
  cluster_wait();
  for (int r = 0; r < rounds; ++r) {
    named_sync(kFull + (r & 1), kLongThreads);  // round r has landed
    const int i = r * kLongSlots + q;
    float part[4][8];
    const int kb = rank + KS * i;
    if (i < mine)
      wide_part(part, ring + (r & 1) * kLongStage + q * kLongSlot + kLongChunks * kUnitW +
                          h * 16 * kXLd,
                ring + (r & 1) * kLongStage + q * kLongSlot, rg, cg,
                min(kBlockK, p.K - kb * kBlockK));
    if (r + 2 < rounds) named_arrive(kEmpty + (r & 1), kLongThreads);  // its stage is read
    if (r > 0) cluster_wait();  // past barrier r - 1: round r - 2's sums are added
    if (i < mine) {
      // to the owners' slot of K-block kb: rows 16 h + 4 rg + ii, a float4
      // of columns 4 cg .. 4 cg + 3 of each chunk
      float* slot = sums + (r % kLongBufs) * buf_floats + (kb - r * span) * p.per;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int c = 0; c < kLongChunks; ++c) {
          const int o = (h * 16 + 4 * rg + ii) * kLongCols + c * kChunk32 + 4 * cg;
          const int owner = o / p.per;
          *reinterpret_cast<float4*>(cluster.map_shared_rank(slot + o - owner * p.per, owner)) =
              make_float4(part[ii][4 * c], part[ii][4 * c + 1], part[ii][4 * c + 2],
                          part[ii][4 * c + 3]);
        }
    }
    cluster_arrive();  // this warp's sums of round r are stored
  }
  if (rounds > 0) cluster_wait();
}

cudaError_t launch_mlp_long_k(const LongKArgs& p, const int* geom, cudaStream_t stream) {
  if (p.n <= 0 || p.K < 1 || p.D < 1 || p.D > kMaxWidth || p.act < kId || p.act > kTanh)
    return cudaErrorInvalidValue;
  const int KS = geom[1], nkb = cdiv(p.K, kBlockK);
  const int tiles = cdiv(p.n, kLongRows) * p.col_tiles;
  const size_t smem =
      sizeof(float) * (2 * (size_t)kLongStage + (size_t)kLongBufs * kLongSlots * KS * p.per);
  if (geom[0] != kLongRows || KS < 1 || KS > kMaxCluster || KS > nkb ||
      p.col_tiles != cdiv(p.D, kLongCols) || p.per % 4 != 0 || p.per * KS < kLongTile ||
      p.per * (KS - 1) >= kLongTile || geom[2] != tiles * KS || (size_t)geom[3] != smem)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fused_mlp_long_k_kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * KS);
  cfg.blockDim = dim3(kLongThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_mlp_long_k_kernel, p);
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

// One layer of long K: x [n, K] -> y [n, D] = act(x w + b), w [K, D], with
// the long-K kernel above.  `geom` is the host's launch geometry (ops/fused.py
// mlp_long_k_geometry): tile rows, cluster size, blocks, dynamic shared
// memory bytes, column tiles and the outputs a block owns; the launch is
// refused unless it matches this file's.  Same contract as
// sqair_fused_mlp; its outputs carry that entry's bits.
extern "C" int sqair_fused_mlp_long_k(const void* x, void* y, int n, int K, int D, int act,
                                      const void* w, const void* b, const int* geom,
                                      void* stream) {
  using namespace sqair;
  LongKArgs p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.y = static_cast<float*>(y);
  p.n = n;
  p.K = K;
  p.D = D;
  p.act = act;
  p.cluster = geom[1];
  p.col_tiles = geom[4];
  p.per = geom[5];
  return (int)launch_mlp_long_k(p, geom, static_cast<cudaStream_t>(stream));
}
