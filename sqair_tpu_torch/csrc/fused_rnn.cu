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
// What bounds them on an H100 at the release model's train-step shapes
// (f32, U = 256; N = 160 rows, 480 for the propagation prior's GRU; d_x 54
// to 567; the discovery where prior's 4 -> 4 cell at 160 and 1600 rows): a
// step reads 0.4-2 MB of weights and does 0.1-0.4 GFLOP of f32 FMA, i.e.
// 0.1-0.6 us at 3.35 TB/s and 2-6 us on the CUDA cores at 67 TFLOP/s.  Each
// step is one link of the sequential T x 2S cell chain, so what a call pays
// is latency.
//
// What held the one-block-per-8-rows kernels back (the first port; 0.04410
// ms a vanilla-RNN call and 0.09929 ms a GRU call over the train step's
// shapes, NVIDIA H100 80GB HBM3, 700.00 W, tools/time_fused_kernels.py):
// 20 blocks on 132 SMs at 160 rows, and each thread walking K = d_x + 256
// as one chain of dependent `__ldg` weight loads from L2, with 8 warps an
// SM to hide them; the GRU ran its candidate's x Wc after the gates'
// barrier.
//
// The design (the MLP forward's, csrc/fused_mlp.cu, through tile_sums.cuh):
// - `split` blocks (1, 2, 4 or 8, picked on the host by `ops/fused.py`
//   `vrnn_fwd_geometry` / `gru_fwd_geometry` so that row tiles x split >=
//   132 where the rows allow it: 8 at 160 rows, 4 at 480, 1 at 1600) share
//   one tile of 8 rows and split the outputs' 32-column chunks.  A block
//   stages its tile's rows of [x | h] once, a warp a row (cp.async, 4-byte
//   copies where a row of x is off a 16-byte boundary, as at d_x 567 and
//   54).  split and the K-blocks a round are powers of 2, so a block works
//   out its share with shifts: the where prior's one-round blocks are
//   mostly this start-up.
// - The block's 8 warps take one 32-row K-block of one chunk each a round,
//   with the weights staged by cp.async into a double-buffered ring one
//   round ahead, and each output's owner adds the partial sums in K order:
//   the x-blocks from 0 (the last one short), then the h-blocks from 0, as
//   the one-block-per-8-rows kernels summed them (one chain over x, then
//   over h).  So the kernels give those kernels' bits.
// - The GRU's blocks form a thread block cluster and run three stages: the
//   gates over [x | h], then the candidate's x Wc over the same staged x,
//   whose sums each block holds in shared memory, then, after one
//   `cluster.sync()`, the candidate's (r h) Uc.  Each block owns the same
//   chunks of z, r and c; it writes its r h columns into every cluster
//   block's buffer through distributed shared memory (`map_shared_rank`),
//   so only the 8 K-blocks of (r h) Uc wait for the barrier.
// Measured the same way: 0.01426 ms a vanilla-RNN call (0.52x its
// torch.addmm chain) and 0.03625 ms a GRU call saving zr and c (0.55x).
//
// What is still left: a round costs ~3 us (the d_x 567 and 416 calls, 4
// and 3 rounds, differ by 3.0 us), in which 160 blocks pull 5 MB of
// weights from L2; the ring runs one round ahead, and a deeper one does not
// fit beside the tile at two blocks an SM.  The 160-row tiles re-read each
// weight once per row tile (20 times: 17-38 MB a call); a cluster that
// shared weight columns across row tiles (TMA multicast) would read them
// once.  The where prior's 4 -> 4 cell at 1600 rows (one round, 200
// blocks) takes 0.00412 ms against the first port's 0.00401.  No tensor
// cores: f32 has none without TF32, which the port keeps off.
//
// The GRU's optional zr [N, 2U] and c [N, U] outputs are what its backward
// pass needs (the train step); the eval path passes null.

#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "tile_sums.cuh"

namespace cg = cooperative_groups;

namespace sqair {

constexpr int kMaxStages = 3;  // the GRU's: gates, candidate over x, candidate over r h

struct CellArgs {
  const float* x;
  const float* h;
  const float* w[kMaxStages][2];  // each stage's weights of its two K segments
  const float* b[2];              // vanilla RNN: b; GRU: bg, bc
  float* hn;
  float* zr;  // GRU, optional
  float* c;   // GRU, optional
  int n, dx, units;
  int split;  // blocks that split a tile's columns (the GRU: a cluster): 1, 2, 4 or 8
  int split_log;
  int lda;    // row stride of the staged tile [x | h]
  int xpad;   // where h starts in a row of the tile
  int rh_ld;  // GRU: row stride of r h
  int zld;    // GRU: row stride of the block's z and candidate sums over x
  int wk[kMaxStages];  // K-blocks a round of stage s takes at once (1, 2, 4, 8)
};

// A block's share of stage s: its left operand `a` in shared memory (row
// stride lda) holds K segment 1 (k1 columns, weights w1) from column 0 and
// segment 2 (k2 columns, weights w2; none where k2 == 0: the gates' h) from
// column xpad.
// The output columns come in `groups` of `units` (the GRU's gates: z, then
// r); the block takes chunks [chunk0, chunk0 + J) of each, nch in all, in
// P passes of WJ = 2^wj_log chunks, each of Q rounds of WK K-blocks.
struct CellPlan {
  const float* w1;
  const float* w2;
  const float* a;
  int lda, ldw, k1, k2, nkb1, nkb, J, chunk0, nch, WK, WJ, wj_log, P, Q;
};

__device__ inline CellPlan plan_stage(const CellArgs& p, int s, int rank, bool gru,
                                      const float* tile, const float* rh) {
  CellPlan L;
  const bool gates = s == 0, cand_rh = gru && s == 2;
  L.w1 = p.w[s][0];
  L.w2 = p.w[s][1];
  L.a = cand_rh ? rh : tile;
  L.lda = cand_rh ? p.rh_ld : p.lda;
  L.ldw = gru && gates ? 2 * p.units : p.units;
  L.k1 = cand_rh ? p.units : p.dx;
  L.k2 = gates ? p.units : 0;
  L.nkb1 = cdiv(L.k1, kBlockK);
  L.nkb = L.nkb1 + cdiv(L.k2, kBlockK);
  // split and WK are powers of 2: no division
  const int chunks = cdiv(p.units, kChunk32);
  const int per_block = (chunks + p.split - 1) >> p.split_log;
  L.chunk0 = rank * per_block;
  L.J = max(0, min(per_block, chunks - L.chunk0));
  L.nch = (gru && gates ? 2 : 1) * L.J;
  L.WK = p.wk[s];
  const int wk_log = __ffs(L.WK) - 1;
  L.WJ = kWarps >> wk_log;
  L.wj_log = 3 - wk_log;
  L.P = (L.nch + L.WJ - 1) >> L.wj_log;
  L.Q = (L.nkb + L.WK - 1) >> wk_log;
  return L;
}

// Stages round (pass, q) of a stage's weights: unit u = (wk << wj_log) + wc
// takes K-block q * WK + wk of the pass's chunk wc.  Thread t copies row
// t / 8 and float4 t % 8 of every unit's [32 k][32 cols].
__device__ __forceinline__ void issue_cell_round(const CellPlan& L, int units, int pass, int q,
                                                 float* stage) {
  const int kr = threadIdx.x >> 3, f4 = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int kb = q * L.WK + (u >> L.wj_log), i = pass * L.WJ + (u & (L.WJ - 1));
    if (kb < L.nkb && i < L.nch) {
      const bool s2 = kb >= L.nkb1;
      const int k = (s2 ? kb - L.nkb1 : kb) * kBlockK + kr;
      const int g = i >= L.J;  // the chunk's group
      const int col = (L.chunk0 + i - g * L.J) * kChunk32 + f4;
      if (k < (s2 ? L.k2 : L.k1))
        copy4_async(stage + u * kUnitW + kr * kChunk32 + f4,
                    (s2 ? L.w2 : L.w1) + (size_t)k * L.ldw + g * units + col, units - col);
    }
  }
}

// Steps (s, pass, q) to the block's next round: rounds run stage by stage,
// pass by pass; s == n_stages past the last one.
__device__ inline void next_cell_round(const CellPlan* plans, int n_stages, int& s, int& pass,
                                       int& q) {
  if (++q < plans[s].Q) return;
  q = 0;
  if (++pass < plans[s].P) return;
  pass = 0;
  do {
    ++s;
  } while (s < n_stages && plans[s].P * plans[s].Q == 0);
}

// Stages rows [0, rows) of the row-major src (row stride K) into dst (row
// stride ld, 16-byte aligned rows): warp r copies row r.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, int K,
                                           int rows) {
  const int r = threadIdx.x >> 5;
  if (r < rows)
    for (int k = (threadIdx.x & 31) * 4; k < K; k += 128)
      copy4_async(dst + r * ld + k, src + (size_t)r * K + k, K - k);
}

template <bool kGru>
__device__ __forceinline__ void cell_body(const CellArgs& p) {
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                  // 2 x kStageW: the weights' ring
  float* parts = stages + 2 * kStageW;   // kParts
  float* tile = parts + kParts;          // kTileRows x lda: the tile's [x | h]
  float* rh = tile + kTileRows * p.lda;  // GRU: kTileRows x rh_ld, the cluster's r h
  float* zs = rh + kTileRows * p.rh_ld;  // GRU: kTileRows x zld, the block's z
  float* cs = zs + kTileRows * p.zld;    // GRU: the block's candidate sums over x
  const int n_stages = kGru ? 3 : 1;
  const int U = p.units;
  const int rank = (int)(blockIdx.x & (p.split - 1));  // a 1-D cluster's block rank
  const int row0 = (int)(blockIdx.x >> p.split_log) * kTileRows;
  const int rows = min(kTileRows, p.n - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  __shared__ CellPlan plans[kMaxStages];
  if (threadIdx.x < n_stages) plans[threadIdx.x] = plan_stage(p, threadIdx.x, rank, kGru, tile, rh);
  stage_rows(tile, p.lda, p.x + (size_t)row0 * p.dx, p.dx, rows);
  stage_rows(tile + p.xpad, p.lda, p.h + (size_t)row0 * U, U, rows);
  __syncthreads();
  // the round to fetch next: the block's first (in one group with the
  // tile), then one ahead of the one that computes
  int fs = 0, fpass = 0, fq = 0;
  while (fs < n_stages && plans[fs].P * plans[fs].Q == 0) ++fs;
  if (fs < n_stages) issue_cell_round(plans[fs], U, fpass, fq, stages);
  copy_commit();
  if (fs < n_stages) next_cell_round(plans, n_stages, fs, fpass, fq);
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster runs before any writes into its shared memory
  if (kGru) cluster.sync();

  int t = 0;
  for (int s = 0; s < n_stages; ++s) {
    const CellPlan L = plans[s];
    if (kGru && s == 2) cluster.sync();  // the cluster's r h is in every block's `rh`
    for (int pass = 0; pass < L.P; ++pass) {
      const int jn = min(L.WJ, L.nch - pass * L.WJ);
      // (r h) Uc continues the candidate's sums over x
      float acc[kWarps];
#pragma unroll
      for (int i = 0; i < kWarps; ++i)
        acc[i] = kGru && s == 2 && i < jn ? cs[warp * p.zld + (pass * L.WJ + i) * kChunk32 + lane]
                                          : 0.f;
      for (int q = 0; q < L.Q; ++q, ++t) {
        if (fs < n_stages) {
          issue_cell_round(plans[fs], U, fpass, fq, stages + ((t + 1) & 1) * kStageW);
          next_cell_round(plans, n_stages, fs, fpass, fq);
        }
        copy_commit();
        copy_wait<1>();
        __syncthreads();  // round t's weights (and the tile) have landed for every thread
        const int kb = q * L.WK + (warp >> L.wj_log);
        if (kb < L.nkb && pass * L.WJ + (warp & (L.WJ - 1)) < L.nch) {
          const bool s2 = kb >= L.nkb1;
          const int k0 = (s2 ? kb - L.nkb1 : kb) * kBlockK;
          unit_sums(parts + warp * kTileRows * kChunk32, L.a + (s2 ? p.xpad : 0) + k0, L.lda,
                    stages + (t & 1) * kStageW + warp * kUnitW,
                    min(kBlockK, (s2 ? L.k2 : L.k1) - k0));
        }
        __syncthreads();  // every unit's partial sums are in `parts`
        add_round(acc, parts, L.wj_log, jn, min(L.WK, L.nkb - q * L.WK));
      }
      // the pass's outputs: row `warp`, column `lane` of each chunk
      const int r = warp;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const int ic = pass * L.WJ + i;
        const int g = ic >= L.J, jj = ic - g * L.J;
        const int col = (L.chunk0 + jj) * kChunk32 + lane;
        if (i < jn && col < U) {
          const size_t o = (size_t)(row0 + r) * U + col;
          if (!kGru) {
            if (r < rows) p.hn[o] = tanhf(acc[i] + p.b[0][col]);
          } else if (s == 0) {
            const float v = 1.f / (1.f + expf(-(acc[i] + p.b[0][g * U + col])));
            if (r < rows && p.zr != nullptr) p.zr[(size_t)(row0 + r) * 2 * U + g * U + col] = v;
            if (g == 0) {
              zs[r * p.zld + jj * kChunk32 + lane] = v;
            } else {
              const float rv = v * tile[r * p.lda + p.xpad + col];
              for (int peer = 0; peer < p.split; ++peer)
                cluster.map_shared_rank(rh, peer)[r * p.rh_ld + col] = rv;
            }
          } else if (s == 1) {
            cs[r * p.zld + jj * kChunk32 + lane] = acc[i];
          } else {
            const float cv = tanhf(acc[i] + p.b[1][col]);
            const float z = zs[r * p.zld + jj * kChunk32 + lane];
            if (r < rows) {
              p.hn[o] = (1.f - z) * tile[r * p.lda + p.xpad + col] + z * cv;
              if (p.c != nullptr) p.c[o] = cv;
            }
          }
        }
      }
    }
  }
  copy_wait<0>();  // nothing lands in shared memory after the block exits
}

__global__ void __launch_bounds__(kThreads, 2) fused_vrnn_kernel(CellArgs p) {
  cell_body<false>(p);
}

__global__ void __launch_bounds__(kThreads, 2) fused_gru_kernel(CellArgs p) {
  cell_body<true>(p);
}

// Checks the host's geometry (`geom`: tile rows, split, blocks, dynamic
// shared memory bytes, then each stage's K-blocks a round) against this
// file's and launches; the GRU's blocks of a tile as one cluster.
template <bool kGru>
int launch_cell(CellArgs& p, const int* geom, void* stream) {
  const int chunks = cdiv(p.units, kChunk32);
  p.split = geom[1];
  if (p.split < 1 || p.split > kMaxCluster || p.split > chunks || (p.split & (p.split - 1)))
    return (int)cudaErrorInvalidValue;
  p.split_log = __builtin_ctz(p.split);
  // row strides a multiple of 4 floats (float4 reads) and 4 past a multiple
  // of 32: the 4 rows a warp's float4 reads touch at once fall in other banks
  p.xpad = cdiv(p.dx, kBlockK) * kBlockK;
  p.lda = p.xpad + cdiv(p.units, kBlockK) * kBlockK + 4;
  p.rh_ld = kGru ? cdiv(p.units, kBlockK) * kBlockK + 4 : 0;
  p.zld = kGru ? cdiv(chunks, p.split) * kChunk32 : 0;
  for (int s = 0; s < (kGru ? 3 : 1); ++s) {
    const int wk = geom[4 + s];
    if (wk != 1 && wk != 2 && wk != 4 && wk != 8) return (int)cudaErrorInvalidValue;
    p.wk[s] = wk;
  }
  const int tiles = cdiv(p.n, kTileRows);
  const size_t smem = sizeof(float) * (2 * (size_t)kStageW + kParts +
                                       kTileRows * (size_t)(p.lda + p.rh_ld + 2 * p.zld));
  if (geom[0] != kTileRows || geom[2] != tiles * p.split || (size_t)geom[3] != smem)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(CellArgs) = kGru ? fused_gru_kernel : fused_vrnn_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kGru ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sqair

// x [n, dx], h [n, units], w [dx, units], u [units, units], b [units] ->
// hn [n, units]; all f32, contiguous and on the device.  `geom` is the
// host's launch geometry (ops/fused.py vrnn_fwd_geometry): tile rows,
// split, blocks, dynamic shared memory bytes, the K-blocks a round; the
// launch is refused unless it matches this file's.  Launches on `stream`,
// does not synchronise, allocates nothing, and returns the CUDA error code
// of the launch (0 on success).
extern "C" int sqair_fused_vanilla_rnn(const void* x, const void* h, const void* w,
                                       const void* u, const void* b, void* hn, int n,
                                       int dx, int units, const int* geom, void* stream) {
  using namespace sqair;
  if (n <= 0 || dx < 0 || units < 1 || units > kMaxWidth) return (int)cudaErrorInvalidValue;
  CellArgs p{};
  p.x = static_cast<const float*>(x);
  p.h = static_cast<const float*>(h);
  p.w[0][0] = static_cast<const float*>(w);
  p.w[0][1] = static_cast<const float*>(u);
  p.b[0] = static_cast<const float*>(b);
  p.hn = static_cast<float*>(hn);
  p.n = n;
  p.dx = dx;
  p.units = units;
  return launch_cell<false>(p, geom, stream);
}

// x [n, dx], h [n, units], wg [dx, 2 units], ug [units, 2 units],
// bg [2 units], wc [dx, units], uc [units, units], bc [units] ->
// hn [n, units], and optionally zr [n, 2 units] and c [n, units] (null to
// skip).  `geom` as above (ops/fused.py gru_fwd_geometry), with the
// K-blocks a round of the three stages.  Same contract as above.
extern "C" int sqair_fused_gru(const void* x, const void* h, const void* wg,
                               const void* ug, const void* bg, const void* wc,
                               const void* uc, const void* bc, void* hn, void* zr,
                               void* c, int n, int dx, int units, const int* geom,
                               void* stream) {
  using namespace sqair;
  if (n <= 0 || dx < 0 || units < 1 || 2 * units > kMaxWidth) return (int)cudaErrorInvalidValue;
  CellArgs p{};
  p.x = static_cast<const float*>(x);
  p.h = static_cast<const float*>(h);
  p.w[0][0] = static_cast<const float*>(wg);
  p.w[0][1] = static_cast<const float*>(ug);
  p.w[1][0] = static_cast<const float*>(wc);
  p.w[2][0] = static_cast<const float*>(uc);
  p.b[0] = static_cast<const float*>(bg);
  p.b[1] = static_cast<const float*>(bc);
  p.hn = static_cast<float*>(hn);
  p.zr = static_cast<float*>(zr);
  p.c = static_cast<float*>(c);
  p.n = n;
  p.dx = dx;
  p.units = units;
  return launch_cell<true>(p, geom, stream);
}
