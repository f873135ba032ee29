// Backward kernels of fused_mlp, fused_vanilla_rnn and fused_gru.
//
// Replaces: sqair_tpu/ops/fused.py, `_pallas_backward` (Pallas kernel
// `_bwd_kernel`), `_fused_vrnn_bwd` (`_vrnn_bwd_kernel`) and
// `_fused_gru_bwd` (`_gru_bwd_kernel`).  The formulas are those kernels':
//
//   MLP:  dz_i = g_i * act'(a_i) (act' read off the saved output a_i),
//         dW_i = a_{i-1}^T dz_i, db_i = sum_rows dz_i, g_{i-1} = dz_i W_i^T
//   RNN:  dz = g (1 - h'^2); dx, dh = dz [W; U]^T; dW, dU = [x, h]^T dz;
//         db = sum_rows dz
//   GRU:  dc_in = (g z)(1 - c^2); drh = dc_in Uc^T;
//         da = [g (c - h), drh h] zr (1 - zr);
//         dx = dc_in Wc^T + da Wg^T; dh = g (1 - z) + drh r + da Ug^T;
//         dWc, dUc = [x, r h]^T dc_in; dWg, dUg = [x, h]^T da; db = sums
//
// One TPU kernel saw every row, so it chained the layers and reduced the
// weight gradients over the rows in one body.  On the card the MLP and the
// GRU backward are two phases, two launches per call:
//   A. row-parallel (`*_bwd_rows_kernel`): one block of kThreads threads
//      owns kRows rows, as in the forward kernels.  It walks the layers in
//      reverse with the rows' gradients in shared memory, writes each
//      layer's dz (and, for the GRU, dc_in, da and r h) to scratch that the
//      wrapper allocates, and writes dx (and dh).
//   B. column-parallel (`outer_reduce_kernel`): each block owns a tile of
//      kOuterK rows x kOuterThreads columns of one dW (and, in its first
//      row of tiles, the same columns of db) and loops over ALL N rows in
//      increasing order, kOuterN rows at a time into a partial sum.  No
//      atomics: two runs give the same bits.
// The vanilla RNN's backward is one launch (`vrnn_bwd_kernel`, its own
// note below): its dz is elementwise, so each block forms what it needs.
//
// What bounds them on an H100 at the release model's train-step shapes
// (f32; N = 160 or 480 rows in the time loop, 1600 and 4800 rows in the
// deferred pass; weights up to 2500 x 256): not the card's rates, at most
// ~3.5 GFLOP for the glimpse decoder at 4800 rows (~52 us at 67 TFLOP/s)
// and well under a microsecond for most calls, but latency.  The MLP and
// GRU phases are right and simple first: phase B runs few blocks when a dW
// is small and N is large (the decoder's first layer: 14 blocks over 4800
// rows), and phase A reads each weight row per thread through L1.
// Splitting N in phase B and tiling the weights in phase A, as the vanilla
// RNN's kernel now does, are later work.
//
// The vanilla RNN's backward at the release shapes (N = 160, d_x 567 or 416
// -> 256 units, 60 of its 63 calls a train step; the where prior's 4 -> 4
// at 160 and 1600 rows) moves ~1.5 MB and does ~0.1 GFLOP: 0.5-1.7 us at
// either rate.  It pays latency instead: one launch of 388-468 blocks at
// 160 rows, two a SM (96 KB of shared memory each), so about two waves of
// short blocks.  What is still left: each weight-gradient tile re-forms dz
// for its columns from g and h' (L2 reads, ~8 MB at 160 rows), the
// input-gradient tiles re-read [W; U] once per row tile (20 times at 160
// rows), and the where prior's single 4 x 4 weight-gradient block walks
// its 1600 rows in 7 rounds.

#include "async_copy.cuh"
#include "bwd_common.cuh"

namespace sqair {

// --------------------------------------------------------------- phase B
// Shared with fused_glimpse.cu through bwd_common.cuh's launch_outer.
// dw = a^T dz and db = sum over the rows of dz, for every job; one block
// per (kOuterK x kOuterThreads) tile of one dw, summing the N rows in order.
__global__ void __launch_bounds__(kOuterThreads) outer_reduce_kernel(OuterArgs p) {
  __shared__ float as[kOuterN * kOuterK];
  int q = 0;
  while (q + 1 < p.n_jobs && (int)blockIdx.x >= p.job[q + 1].tile0) ++q;
  const OuterJob jb = p.job[q];
  const int local = blockIdx.x - jb.tile0;
  const int k0 = (local / jb.tiles_j) * kOuterK;
  const int j = (local % jb.tiles_j) * kOuterThreads + threadIdx.x;
  const bool with_db = jb.db != nullptr && k0 == 0;
  const int ldz = jb.ldz > 0 ? jb.ldz : jb.J;
  float acc[kOuterK];
#pragma unroll
  for (int kk = 0; kk < kOuterK; ++kk) acc[kk] = 0.f;
  float accb = 0.f;

  for (int seg = 0; seg < 2; ++seg) {
    const float* a = seg == 0 ? jb.a : jb.a2;
    const float* dz = seg == 0 ? jb.dz : jb.dz2;
    if (a == nullptr) break;
    for (int n0 = 0; n0 < p.n; n0 += kOuterN) {
      const int nc = min(kOuterN, p.n - n0);
      __syncthreads();  // the previous chunk has been read by every thread
      for (int i = threadIdx.x; i < kOuterN * kOuterK; i += kOuterThreads) {
        const int r = i / kOuterK, kk = i - r * kOuterK;
        as[i] = (r < nc && k0 + kk < jb.K) ? a[(size_t)(n0 + r) * jb.lda + k0 + kk] : 0.f;
      }
      __syncthreads();
      if (j < jb.J) {
        float d[kOuterN];
#pragma unroll
        for (int r = 0; r < kOuterN; ++r) d[r] = r < nc ? dz[(size_t)(n0 + r) * ldz + j] : 0.f;
        // the chunk's kOuterN rows into partial sums, then added: the
        // rounding error grows with N / kOuterN + kOuterN, not with N
        float part[kOuterK], partb = 0.f;
#pragma unroll
        for (int kk = 0; kk < kOuterK; ++kk) part[kk] = 0.f;
#pragma unroll
        for (int r = 0; r < kOuterN; ++r) {
#pragma unroll
          for (int kk = 0; kk < kOuterK; ++kk)
            part[kk] = fmaf(as[r * kOuterK + kk], d[r], part[kk]);
          if (with_db) partb += d[r];
        }
#pragma unroll
        for (int kk = 0; kk < kOuterK; ++kk) acc[kk] += part[kk];
        accb += partb;
      }
    }
  }
  if (j < jb.J) {
#pragma unroll
    for (int kk = 0; kk < kOuterK; ++kk)
      if (k0 + kk < jb.K) jb.dw[(size_t)(k0 + kk) * jb.J + j] = acc[kk];
    if (with_db) jb.db[j] = accb;
  }
}

cudaError_t launch_outer(OuterArgs& p, cudaStream_t stream) {
  int tiles = 0;
  for (int q = 0; q < p.n_jobs; ++q) {
    OuterJob& jb = p.job[q];
    jb.tiles_j = (jb.J + kOuterThreads - 1) / kOuterThreads;
    jb.tile0 = tiles;
    tiles += ((jb.K + kOuterK - 1) / kOuterK) * jb.tiles_j;
  }
  if (tiles == 0) return cudaSuccess;
  outer_reduce_kernel<<<tiles, kOuterThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------- phase A: MLP
constexpr int kMaxLayers = 4;  // as fused_mlp.cu
constexpr int kWarps8 = kThreads / 32;

struct MlpBwdArgs {
  const float* g;  // [N, dims[n_layers]]
  float* dx;       // [N, dims[0]] or null
  int n, n_layers;
  int max_width;   // widest layer output
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
  const float* w[kMaxLayers];
  const float* a[kMaxLayers];  // saved post-activations [N, dims[l + 1]]
  float* dz[kMaxLayers];       // scratch [N, dims[l + 1]]
};

__global__ void __launch_bounds__(kThreads) mlp_bwd_rows_kernel(MlpBwdArgs p) {
  extern __shared__ float smem[];
  float* gbuf = smem;                       // kRows x (width of the current layer)
  float* dzbuf = smem + kRows * p.max_width;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, p.n - row0);

  const int dn = p.dims[p.n_layers];
  for (int i = threadIdx.x; i < kRows * dn; i += kThreads) {
    const int r = i / dn, j = i - r * dn;
    gbuf[i] = r < rows ? p.g[(size_t)(row0 + r) * dn + j] : 0.f;
  }
  __syncthreads();

  for (int l = p.n_layers - 1; l >= 0; --l) {
    const int K = p.dims[l], D = p.dims[l + 1];
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int r = i / D, j = i - r * D;
      float v = 0.f;
      if (r < rows) {
        const size_t o = (size_t)(row0 + r) * D + j;
        v = gbuf[i] * act_grad_from_output(p.a[l][o], p.acts[l]);
        p.dz[l][o] = v;
      }
      dzbuf[i] = v;
    }
    __syncthreads();
    if (l > 0) {  // the next layer's gradient, g_{l-1} = dz_l W_l^T, into gbuf
      Acc acc;
      zero(acc);
      acc_smem_t(acc, dzbuf, D, D, p.w[l], D, 0, K);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = threadIdx.x + c * kThreads;
        if (col < K) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) gbuf[r * K + col] = acc[c][r];
        }
      }
    } else if (p.dx != nullptr) {
      for (int col0 = 0; col0 < K; col0 += kMaxWidth) {
        Acc acc;
        zero(acc);
        acc_smem_t(acc, dzbuf, D, D, p.w[0], D, col0, K);
        store_rows(acc, p.dx, K, row0, rows, col0, K);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------- vanilla RNN, one launch
// The vanilla RNN's backward is one launch with two kinds of blocks, each
// of which forms the dz = g (1 - h'^2) it needs from g and h' itself (dz
// is elementwise, so no block waits for another; no dz scratch):
//
// - weight-gradient blocks (first in the grid): a tile of kVTileK rows x
//   kVTileJ columns of [dW; dU] = [x, h]^T dz (and, in the first row of
//   tiles, those columns of db).  The N rows go in 32-row blocks: warp w of
//   a round sums row block 8 q + w of every output of the tile into a
//   partial sum (a lane owns one column, 32 outputs), and the owner of each
//   output then adds the round's partial sums in row-block order.  So each
//   output is the chain ((p_0 + p_1) + p_2) + ... of 32-row partial sums
//   that `outer_reduce_kernel` forms, with the rows split over the warps
//   (the where prior's 4 x 4 over 1600 rows: 50 row blocks, 7 rounds, not
//   one thread's walk).
// - input-gradient blocks: a tile of `rows` batch rows x kVTileCols columns
//   of [dx | dh] = dz [W; U]^T.  Warp w of a round takes K-block 8 q + w of
//   the units: it stages those 32 columns of the tile's rows of [W; U]
//   into its own shared memory with cp.async (16-byte copies where
//   aligned; the rows padded to kVLd floats, so that a warp's float4 reads
//   of 32 rows hit every bank once), forms the rows' dz for them, and sums
//   the 32 products of each output (a lane owns 2 columns x 8 rows).  The
//   owners add the round's partial sums in K order, as acc_smem_t does.
constexpr int kVTileCols = 64;                  // [dx | dh] columns of a block
constexpr int kVLd = kBlockK + 4;               // row stride of a staged [W; U] slice
constexpr int kVWarpM = kVTileCols * kVLd;      // a warp's staged slice
constexpr int kVRowsMax = 8;                    // batch rows of an input tile
constexpr int kVRoundJ = kWarps8 * kBlockK;     // units of a round (256)
constexpr int kVTileK = 32;                     // [dW; dU] rows of a block
constexpr int kVTileJ = 32;                     // [dW; dU] columns of a block
constexpr int kVRowBlock = kOuterN;             // batch rows a warp sums at a time
constexpr int kVInFloats = kWarps8 * kVWarpM + kVRowsMax * kVRoundJ
                           + kWarps8 * kVRowsMax * kVTileCols;
constexpr int kVWgFloats = kWarps8 * kVRowBlock * kVTileK + kWarps8 * kVTileK * kVTileJ
                           + kWarps8 * kVTileJ;
constexpr int kVSmemFloats = kVInFloats > kVWgFloats ? kVInFloats : kVWgFloats;

struct VrnnBwdArgs {
  const float *x, *h, *w, *u, *hn, *g;
  float *dx, *dh, *dw, *du, *db;
  int n, d_x, units;
  int rows;       // batch rows of an input-gradient tile (1, 2, 4 or 8)
  int c_lo, c_n;  // the [dx | dh] columns the input-gradient blocks write
  int col_tiles;  // input-gradient column tiles
  int wg_blocks;  // weight-gradient blocks, first in the grid
  int j_tiles;    // their column tiles
};

__device__ __forceinline__ float vrnn_dz(const VrnnBwdArgs& p, int row, int j) {
  const size_t o = (size_t)row * p.units + j;
  const float hv = p.hn[o];
  return p.g[o] * (1.f - hv * hv);
}

__device__ void vrnn_bwd_weights(const VrnnBwdArgs& p, int tile, float* smem) {
  float* as = smem;                                         // [warp][32 rows][32 k]
  float* parts = as + kWarps8 * kVRowBlock * kVTileK;       // [warp][32 k][32 j]
  float* parts_b = parts + kWarps8 * kVTileK * kVTileJ;     // [warp][32 j]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kt = tile / p.j_tiles, jt = tile - kt * p.j_tiles;
  const int k0 = kt * kVTileK, j0 = jt * kVTileJ;
  const int kk_max = p.d_x + p.units;
  const bool with_db = kt == 0;
  const int row_blocks = (p.n + kVRowBlock - 1) / kVRowBlock;
  float acc[kVTileK * kVTileJ / kThreads];
#pragma unroll
  for (int i = 0; i < kVTileK * kVTileJ / kThreads; ++i) acc[i] = 0.f;
  float acc_b = 0.f;

  for (int rb0 = 0; rb0 < row_blocks; rb0 += kWarps8) {
    const int rb = rb0 + warp;
    if (rb < row_blocks) {
      const int n0 = rb * kVRowBlock;
      float* aw = as + warp * kVRowBlock * kVTileK;
      // column k of [x, h] for the block's rows (all 32 loads in flight)
      const int k = k0 + lane;
      const float* src = k < p.d_x ? p.x + k : k < kk_max ? p.h + (k - p.d_x) : nullptr;
      const int ld = k < p.d_x ? p.d_x : p.units;
      const int nrows = min(kVRowBlock, p.n - n0);
      float a[kVRowBlock];
#pragma unroll
      for (int r = 0; r < kVRowBlock; ++r)
        a[r] = (src != nullptr && r < nrows) ? src[(size_t)(n0 + r) * ld] : 0.f;
#pragma unroll
      for (int r = 0; r < kVRowBlock; ++r) aw[r * kVTileK + lane] = a[r];
      const int j = j0 + lane;
      float d[kVRowBlock];
#pragma unroll
      for (int r = 0; r < kVRowBlock; ++r)
        d[r] = (r < nrows && j < p.units) ? vrnn_dz(p, n0 + r, j) : 0.f;
      __syncwarp();
      // as outer_reduce_kernel: the block's 32 rows in order into partial sums
      float part[kVTileK], part_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < kVTileK; ++kk) part[kk] = 0.f;
      const int kv = min(kVTileK, kk_max - k0);  // the tile's rows of [dW; dU]
#pragma unroll
      for (int r = 0; r < kVRowBlock; ++r) {
#pragma unroll
        for (int kk = 0; kk < kVTileK; kk += 4) {
          if (kk >= kv) break;
          const float4 a4 = *reinterpret_cast<const float4*>(aw + r * kVTileK + kk);
          part[kk + 0] = fmaf(a4.x, d[r], part[kk + 0]);
          part[kk + 1] = fmaf(a4.y, d[r], part[kk + 1]);
          part[kk + 2] = fmaf(a4.z, d[r], part[kk + 2]);
          part[kk + 3] = fmaf(a4.w, d[r], part[kk + 3]);
        }
        if (with_db) part_b += d[r];
      }
#pragma unroll
      for (int kk = 0; kk < kVTileK; ++kk)
        parts[(warp * kVTileK + kk) * kVTileJ + lane] = part[kk];
      parts_b[warp * kVTileJ + lane] = part_b;
    }
    __syncthreads();  // the round's partial sums are in shared memory
    const int nw = min(kWarps8, row_blocks - rb0);
#pragma unroll
    for (int i = 0; i < kVTileK * kVTileJ / kThreads; ++i) {
      const int o = threadIdx.x + i * kThreads;
#pragma unroll
      for (int ww = 0; ww < kWarps8; ++ww)
        if (ww < nw) acc[i] += parts[ww * kVTileK * kVTileJ + o];
    }
    if (with_db && threadIdx.x < kVTileJ) {
#pragma unroll
      for (int ww = 0; ww < kWarps8; ++ww)
        if (ww < nw) acc_b += parts_b[ww * kVTileJ + threadIdx.x];
    }
    __syncthreads();  // before the next round overwrites them
  }
#pragma unroll
  for (int i = 0; i < kVTileK * kVTileJ / kThreads; ++i) {
    const int o = threadIdx.x + i * kThreads;
    const int k = k0 + o / kVTileJ, j = j0 + o % kVTileJ;
    if (k < kk_max && j < p.units) {
      if (k < p.d_x) p.dw[(size_t)k * p.units + j] = acc[i];
      else p.du[(size_t)(k - p.d_x) * p.units + j] = acc[i];
    }
  }
  if (with_db && threadIdx.x < kVTileJ && j0 + threadIdx.x < p.units)
    p.db[j0 + threadIdx.x] = acc_b;
}

// part[c][r] += dz[r][j + i] * M[c][j + i] for i < 4, in order, for the
// lane's two staged rows m0, m1 of [W; U] and the 8 rows' dz (broadcasts).
__device__ __forceinline__ void vrnn_step4(float (&part)[2][kVRowsMax], const float* m0,
                                           const float* m1, const float* dzw, int j) {
  const float4 a = *reinterpret_cast<const float4*>(m0 + j);
  const float4 b = *reinterpret_cast<const float4*>(m1 + j);
#pragma unroll
  for (int r = 0; r < kVRowsMax; ++r) {
    const float4 d = *reinterpret_cast<const float4*>(dzw + r * kVRoundJ + j);
    part[0][r] = fmaf(d.x, a.x, part[0][r]);
    part[0][r] = fmaf(d.y, a.y, part[0][r]);
    part[0][r] = fmaf(d.z, a.z, part[0][r]);
    part[0][r] = fmaf(d.w, a.w, part[0][r]);
    part[1][r] = fmaf(d.x, b.x, part[1][r]);
    part[1][r] = fmaf(d.y, b.y, part[1][r]);
    part[1][r] = fmaf(d.z, b.z, part[1][r]);
    part[1][r] = fmaf(d.w, b.w, part[1][r]);
  }
}

__device__ void vrnn_bwd_inputs(const VrnnBwdArgs& p, int tile, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mw = smem + warp * kVWarpM;                        // [64 cols][kVLd]
  float* dzs = smem + kWarps8 * kVWarpM;                    // [8 rows][256]
  float* parts = dzs + kVRowsMax * kVRoundJ;                // [warp][8 rows][64 cols]
  const int rt = tile / p.col_tiles, ct = tile - rt * p.col_tiles;
  const int row0 = rt * p.rows;
  const int nr = min(p.rows, p.n - row0);
  const int cbase = p.c_lo + ct * kVTileCols;
  const int cn = min(kVTileCols, p.c_lo + p.c_n - cbase);
  const int U = p.units;
  const int jblocks = (U + kBlockK - 1) / kBlockK;
  float acc[2] = {0.f, 0.f};

  for (int jb0 = 0; jb0 < jblocks; jb0 += kWarps8) {
    const int jb = jb0 + warp;
    if (jb < jblocks) {
      const int j0 = jb * kBlockK, jn = min(kBlockK, U - j0);
      // this warp's K-block of the tile's rows of [W; U]: lane copies
      // float4 lane % 8 of rows lane / 8 + 4 m
      const int jj = (lane & 7) * 4;
      if (jj < jn) {
#pragma unroll
        for (int m = 0; m < kVTileCols / 4; ++m) {
          const int c = (lane >> 3) + 4 * m, col = cbase + c;
          if (c < cn) {
            const float* src =
                col < p.d_x ? p.w + (size_t)col * U : p.u + (size_t)(col - p.d_x) * U;
            copy4_async(mw + c * kVLd + jj, src + j0 + jj, jn - jj);
          }
        }
      }
      copy_commit();
      float* dzw = dzs + warp * kBlockK;
#pragma unroll
      for (int r = 0; r < kVRowsMax; ++r)
        dzw[r * kVRoundJ + lane] = (r < nr && lane < jn) ? vrnn_dz(p, row0 + r, j0 + lane) : 0.f;
      copy_wait<0>();
      __syncwarp();
      // as acc_smem_t: the K-block's products in order into partial sums
      float part[2][kVRowsMax];
#pragma unroll
      for (int r = 0; r < kVRowsMax; ++r) part[0][r] = part[1][r] = 0.f;
      const float* m0 = mw + lane * kVLd;
      const float* m1 = mw + (lane + 32) * kVLd;
      int j = 0;
      if (jn == kBlockK) {  // a whole K-block, unrolled so that loads run ahead
#pragma unroll
        for (int j4 = 0; j4 < kBlockK; j4 += 4) vrnn_step4(part, m0, m1, dzw, j4);
        j = kBlockK;
      }
      for (; j + 4 <= jn; j += 4) vrnn_step4(part, m0, m1, dzw, j);
      for (; j < jn; ++j) {
#pragma unroll
        for (int r = 0; r < kVRowsMax; ++r) {
          const float d = dzw[r * kVRoundJ + j];
          part[0][r] = fmaf(d, m0[j], part[0][r]);
          part[1][r] = fmaf(d, m1[j], part[1][r]);
        }
      }
      float* pw = parts + warp * kVRowsMax * kVTileCols;
#pragma unroll
      for (int r = 0; r < kVRowsMax; ++r) {
        pw[r * kVTileCols + lane] = part[0][r];
        pw[r * kVTileCols + lane + 32] = part[1][r];
      }
    }
    __syncthreads();  // the round's partial sums are in shared memory
    const int nw = min(kWarps8, jblocks - jb0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = threadIdx.x + i * kThreads;  // row o / 64, column o % 64
#pragma unroll
      for (int ww = 0; ww < kWarps8; ++ww)
        if (ww < nw) acc[i] += parts[ww * kVRowsMax * kVTileCols + o];
    }
    __syncthreads();  // before the next round overwrites the slices and sums
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = threadIdx.x + i * kThreads;
    const int r = o / kVTileCols, c = o % kVTileCols;
    if (r < nr && c < cn) {
      const int col = cbase + c;
      const size_t row = (size_t)(row0 + r);
      if (col < p.d_x) p.dx[row * p.d_x + col] = acc[i];
      else p.dh[row * U + col - p.d_x] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads) vrnn_bwd_kernel(VrnnBwdArgs p) {
  extern __shared__ __align__(16) float vsmem[];
  if ((int)blockIdx.x < p.wg_blocks) vrnn_bwd_weights(p, blockIdx.x, vsmem);
  else vrnn_bwd_inputs(p, blockIdx.x - p.wg_blocks, vsmem);
}

// -------------------------------------------------------- phase A: GRU
__global__ void __launch_bounds__(kThreads)
gru_bwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ wg,
                    const float* __restrict__ ug, const float* __restrict__ wc,
                    const float* __restrict__ uc, const float* __restrict__ zr,
                    const float* __restrict__ c, const float* __restrict__ g,
                    float* __restrict__ dc_in, float* __restrict__ da,
                    float* __restrict__ rh, float* __restrict__ dx,
                    float* __restrict__ dh, int n, int d_x, int units) {
  extern __shared__ float smem[];
  const int u2 = 2 * units;
  float* dcs = smem;                  // kRows * units: dc_in
  float* drh = dcs + kRows * units;   // kRows * units: dc_in Uc^T
  float* das = drh + kRows * units;   // kRows * 2 units: da
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);

  for (int i = threadIdx.x; i < kRows * units; i += kThreads) {
    const int r = i / units, j = i - r * units;
    float v = 0.f;
    if (r < rows) {
      const size_t o = (size_t)(row0 + r) * units + j;
      const float z = zr[(size_t)(row0 + r) * u2 + j], cv = c[o];
      v = (g[o] * z) * (1.f - cv * cv);
      dc_in[o] = v;
    }
    dcs[i] = v;
  }
  __syncthreads();
  {
    Acc acc;
    zero(acc);
    acc_smem_t(acc, dcs, units, units, uc, units, 0, units);
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int col = threadIdx.x + cc * kThreads;
      if (col < units) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) drh[r * units + col] = acc[cc][r];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * u2; i += kThreads) {
    const int r = i / u2, j = i - r * u2;
    float v = 0.f;
    if (r < rows) {
      const size_t row = (size_t)(row0 + r);
      const float s = zr[row * u2 + j];
      float d;
      if (j < units) {  // update gate: g (c - h)
        const size_t o = row * units + j;
        d = g[o] * (c[o] - h[o]);
      } else {          // reset gate: (dc_in Uc^T) h; also r h for phase B
        const int jj = j - units;
        const float hv = h[row * units + jj];
        d = drh[r * units + jj] * hv;
        rh[row * units + jj] = s * hv;
      }
      v = d * s * (1.f - s);
      da[row * u2 + j] = v;
    }
    das[i] = v;
  }
  __syncthreads();
  if (dx != nullptr) {
    for (int col0 = 0; col0 < d_x; col0 += kMaxWidth) {
      Acc acc;
      zero(acc);
      acc_smem_t(acc, dcs, units, units, wc, units, col0, d_x);
      acc_smem_t(acc, das, u2, u2, wg, u2, col0, d_x);
      store_rows(acc, dx, d_x, row0, rows, col0, d_x);
    }
  }
  if (dh != nullptr) {
    Acc acc;
    zero(acc);
    acc_smem_t(acc, das, u2, u2, ug, u2, 0, units);
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) {
      const int col = threadIdx.x + cc * kThreads;
      if (col < units) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            const size_t row = (size_t)(row0 + r);
            const size_t o = row * units + col;
            const float z = zr[row * u2 + col], rg = zr[row * u2 + units + col];
            dh[o] = g[o] * (1.f - z) + drh[r * units + col] * rg + acc[cc][r];
          }
        }
      }
    }
  }
}

}  // namespace sqair

// fused_mlp backward.  x [n, dims[0]], g [n, dims[n_layers]] (gradient of
// the output), saved post-activations a[l] [n, dims[l + 1]] (a[n_layers - 1]
// is the output), weights w[l] [dims[l], dims[l + 1]] -> dx [n, dims[0]]
// (null to skip), dw[l] like w[l], db[l] [dims[l + 1]].  dz[l]
// [n, dims[l + 1]] is scratch.  `dims`, `acts`, `w`, `a`, `dz`, `dw` and
// `db` are host arrays.  All f32, contiguous and on the device.  Launches
// phase A and phase B on `stream`, does not synchronise, allocates
// nothing, and returns the CUDA error code of the launches (0 on success).
extern "C" int sqair_fused_mlp_bwd(const void* x, const void* g, void* dx, int n,
                                   int n_layers, const int* dims, const int* acts,
                                   const void* const* w, const void* const* a,
                                   void* const* dz, void* const* dw, void* const* db,
                                   void* stream) {
  using namespace sqair;
  if (n <= 0 || n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpBwdArgs p{};
  p.g = static_cast<const float*>(g);
  p.dx = static_cast<float*>(dx);
  p.n = n;
  p.n_layers = n_layers;
  p.max_width = 1;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || (l > 0 && dims[l] > kMaxWidth)) return (int)cudaErrorInvalidValue;
    p.dims[l] = dims[l];
    if (l > 0 && dims[l] > p.max_width) p.max_width = dims[l];
  }
  OuterArgs q{};
  q.n = n;
  q.n_jobs = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < kId || acts[l] > kTanh) return (int)cudaErrorInvalidValue;
    p.acts[l] = acts[l];
    p.w[l] = static_cast<const float*>(w[l]);
    p.a[l] = static_cast<const float*>(a[l]);
    p.dz[l] = static_cast<float*>(dz[l]);
    OuterJob& jb = q.job[l];
    jb.a = l == 0 ? static_cast<const float*>(x) : p.a[l - 1];
    jb.lda = dims[l];
    jb.dz = p.dz[l];
    jb.dw = static_cast<float*>(dw[l]);
    jb.db = static_cast<float*>(db[l]);
    jb.K = dims[l];
    jb.J = dims[l + 1];
  }
  const size_t smem = sizeof(float) * 2 * (size_t)kRows * p.max_width;
  cudaError_t err = allow_smem(mlp_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  mlp_bwd_rows_kernel<<<blocks, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_outer(q, s);
}

// fused_vanilla_rnn backward.  x [n, d_x], h [n, units], w [d_x, units],
// u [units, units], the saved output hn [n, units] and its gradient g ->
// dx [n, d_x] and dh [n, units] (either null to skip), dw, du, db.  `geom`
// is the host's launch geometry (ops/fused.py vrnn_bwd_geometry): batch
// rows of an input-gradient tile, blocks, dynamic shared memory bytes; the
// launch is refused unless it matches this file's.  One launch, no scratch.
// Same contract as above.
extern "C" int sqair_fused_vanilla_rnn_bwd(const void* x, const void* h, const void* w,
                                           const void* u, const void* hn, const void* g,
                                           void* dx, void* dh, void* dw, void* du, void* db,
                                           int n, int d_x, int units, const int* geom,
                                           void* stream) {
  using namespace sqair;
  if (n <= 0 || d_x < 1 || units < 1 || units > kMaxWidth) return (int)cudaErrorInvalidValue;
  VrnnBwdArgs p{};
  p.x = static_cast<const float*>(x);
  p.h = static_cast<const float*>(h);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.hn = static_cast<const float*>(hn);
  p.g = static_cast<const float*>(g);
  p.dx = static_cast<float*>(dx);
  p.dh = static_cast<float*>(dh);
  p.dw = static_cast<float*>(dw);
  p.du = static_cast<float*>(du);
  p.db = static_cast<float*>(db);
  p.n = n;
  p.d_x = d_x;
  p.units = units;
  p.rows = geom[0];
  p.c_lo = dx != nullptr ? 0 : d_x;
  p.c_n = (dx != nullptr ? d_x : 0) + (dh != nullptr ? units : 0);
  p.col_tiles = (p.c_n + kVTileCols - 1) / kVTileCols;
  p.j_tiles = (units + kVTileJ - 1) / kVTileJ;
  p.wg_blocks = ((d_x + units + kVTileK - 1) / kVTileK) * p.j_tiles;
  const int in_blocks = ((n + p.rows - 1) / p.rows) * p.col_tiles;
  const size_t smem = sizeof(float) * (size_t)kVSmemFloats;
  if ((p.rows != 1 && p.rows != 2 && p.rows != 4 && p.rows != kVRowsMax) ||
      geom[1] != p.wg_blocks + in_blocks || (size_t)geom[2] != smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(vrnn_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  vrnn_bwd_kernel<<<p.wg_blocks + in_blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// fused_gru backward.  x [n, d_x], h [n, units], wg [d_x, 2 units],
// ug [units, 2 units], wc [d_x, units], uc [units, units], the saved gates
// zr [n, 2 units] and candidate c [n, units], and the output's gradient
// g [n, units] -> dx [n, d_x] and dh [n, units] (either null to skip),
// dwg, dug, dbg [2 units], dwc, duc, dbc [units].  dc_in [n, units],
// da [n, 2 units] and rh [n, units] are scratch.  Same contract as above.
extern "C" int sqair_fused_gru_bwd(const void* x, const void* h, const void* wg,
                                   const void* ug, const void* wc, const void* uc,
                                   const void* zr, const void* c, const void* g, void* dc_in,
                                   void* da, void* rh, void* dx, void* dh, void* dwg,
                                   void* dug, void* dbg, void* dwc, void* duc, void* dbc,
                                   int n, int d_x, int units, void* stream) {
  using namespace sqair;
  if (n <= 0 || d_x < 1 || units < 1 || 2 * units > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)kRows * 4 * units;
  cudaError_t err = allow_smem(gru_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  gru_bwd_rows_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(wg),
      static_cast<const float*>(ug), static_cast<const float*>(wc),
      static_cast<const float*>(uc), static_cast<const float*>(zr),
      static_cast<const float*>(c), static_cast<const float*>(g),
      static_cast<float*>(dc_in), static_cast<float*>(da), static_cast<float*>(rh),
      static_cast<float*>(dx), static_cast<float*>(dh), n, d_x, units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* xp = static_cast<const float*>(x);
  const float* hp = static_cast<const float*>(h);
  const float* dcp = static_cast<const float*>(dc_in);
  const float* dap = static_cast<const float*>(da);
  OuterArgs q{};
  q.n = n;
  q.n_jobs = 4;
  q.job[0] = OuterJob{xp, dcp, static_cast<float*>(dwc), static_cast<float*>(dbc), d_x, d_x,
                      units};
  q.job[1] = OuterJob{static_cast<const float*>(rh), dcp, static_cast<float*>(duc), nullptr,
                      units, units, units};
  q.job[2] = OuterJob{xp, dap, static_cast<float*>(dwg), static_cast<float*>(dbg), d_x, d_x,
                      2 * units};
  q.job[3] = OuterJob{hp, dap, static_cast<float*>(dug), nullptr, units, units, 2 * units};
  return (int)launch_outer(q, s);
}
