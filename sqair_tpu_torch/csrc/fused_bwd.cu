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
//   A. row-parallel, redesigned for Hopper: a thread block cluster shares
//      a tile of 8 rows and splits each transposed product over its blocks
//      (cluster_dense.cuh).  The MLP's (`mlp_bwd_kernel`) writes each
//      layer's dz to scratch and dx (one layer of long K, the conv
//      encoders: `mlp_bwd_long_k_kernel`, 32-row tiles); the GRU's
//      (`gru_bwd_kernel`) writes dc_in, da and r h to scratch that the
//      wrapper allocates, and dx and dh.
//   B. column-parallel, summing the rows in fixed order
//      (`tile_reduce_kernel`, which the glimpse, discovery and propagation
//      backwards launch too): each block owns a 32 x 32 tile of one dW (and,
//      in its first row of tiles, the same columns of db); its warps take
//      the 32-row chunks of N at once and the owner of each output adds
//      their partial sums in chunk order.  No atomics: two runs give the
//      same bits.
// The vanilla RNN's backward is one launch (`vrnn_bwd_kernel`, its own
// note below): its dz is elementwise, so each block forms what it needs.
//
// What bounds them on an H100 at the release model's train-step shapes
// (f32; N = 160 or 480 rows in the time loop, 1600 and 4800 rows in the
// deferred pass; weights up to 2500 x 256): not the card's rates, at most
// ~3.5 GFLOP for the glimpse decoder at 4800 rows (~52 us at 67 TFLOP/s)
// and well under a microsecond for most calls, but latency.  The first MLP
// and GRU backwards lost their time in phase A, where each thread walked
// its own row of W through L1 (a warp load touching 32 cache lines) in 20
// blocks at 160 rows (the GRU's took 0.286 ms a call on an H100, 0.057
// now); the cluster kernels stage W's rows in coalesced tiles, split each
// product's j over the warps and its columns over 8 blocks (160 at 160
// rows), and keep the first design's bits.
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

#include "cluster_dense.cuh"

namespace sqair {

// --------------------------------------------------------------- phase B
// dW = a^T dz and db = sum_rows dz for every job (bwd_common.cuh's
// OuterArgs), one block per 32 x 32 tile of one dW.  The N rows go in
// 32-row chunks (the second segment's after the first's): warp w of a
// round takes chunk 8 q + w and sums its 32 rows in order into a partial
// sum of each of the tile's outputs (a lane owns one column, 32 rows of
// dW); the owner of each output then adds the round's partial sums in
// chunk order.  So each output
// is the chain ((p_0 + p_1) + p_2) + ... of 32-row partial sums, each
// summed from zero with zeros past the last row, that one thread walking
// the N rows in order forms: its bits, with the chunks spread over the
// warps (the decoder's 4800 rows: 150 chunks, 19 rounds).
constexpr int kRTile = 32;  // dW rows and columns of a reducer block
constexpr int kRSmemFloats = 2 * kWarps * kOuterN * kRTile + kWarps * kRTile;

__global__ void __launch_bounds__(kThreads, 3) tile_reduce_kernel(OuterArgs p) {
  extern __shared__ __align__(16) float rsmem[];
  float* as = rsmem;                                  // [warp][32 rows][32 k], then
                                                      // the warp's partial sums [32 k][32 j]
  float* ds = as + kWarps * kOuterN * kRTile;         // [warp][32 rows][32 j]
  float* parts_b = ds + kWarps * kOuterN * kRTile;    // [warp][32 j]
  int q = 0;
  while (q + 1 < p.n_jobs && (int)blockIdx.x >= p.job[q + 1].tile0) ++q;
  const OuterJob jb = p.job[q];
  const int local = blockIdx.x - jb.tile0;
  const int kt = local / jb.tiles_j, jt = local - kt * jb.tiles_j;
  const int k0 = kt * kRTile, j0 = jt * kRTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool with_db = jb.db != nullptr && kt == 0;
  const int nch0 = cdiv(p.n, kOuterN);
  const int nch = jb.a2 != nullptr ? 2 * nch0 : nch0;
  constexpr int kOwn = kRTile * kRTile / kThreads;  // outputs a thread owns
  float acc[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = 0.f;
  float acc_b = 0.f;

  for (int c0 = 0; c0 < nch; c0 += kWarps) {
    const int c = c0 + warp;
    float* aw = as + warp * kOuterN * kRTile;
    if (c < nch) {
      const bool second = c >= nch0;
      const float* a = second ? jb.a2 : jb.a;
      const float* dz = second ? jb.dz2 : jb.dz;
      const int n0 = (second ? c - nch0 : c) * kOuterN;
      const int nrows = min(kOuterN, p.n - n0);
      float* dw = ds + warp * kOuterN * kRTile;
      const int k = k0 + lane, j = j0 + lane;
      // column k of a and column j of dz for the chunk's rows
#pragma unroll 8
      for (int r = 0; r < kOuterN; ++r) {
        aw[r * kRTile + lane] =
            (r < nrows && k < jb.K) ? __ldg(a + (size_t)(n0 + r) * jb.lda + k) : 0.f;
        dw[r * kRTile + lane] =
            (r < nrows && j < jb.J) ? __ldg(dz + (size_t)(n0 + r) * jb.ldz + j) : 0.f;
      }
      __syncwarp();
      // the chunk's 32 rows in order into partial sums
      float part[kRTile], part_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < kRTile; ++kk) part[kk] = 0.f;
#pragma unroll 4
      for (int r = 0; r < kOuterN; ++r) {
        const float d = dw[r * kRTile + lane];
#pragma unroll
        for (int kk = 0; kk < kRTile; kk += 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(aw + r * kRTile + kk);
          part[kk + 0] = fmaf(a4.x, d, part[kk + 0]);
          part[kk + 1] = fmaf(a4.y, d, part[kk + 1]);
          part[kk + 2] = fmaf(a4.z, d, part[kk + 2]);
          part[kk + 3] = fmaf(a4.w, d, part[kk + 3]);
        }
        if (with_db) part_b += d;
      }
      __syncwarp();  // every lane has read the warp's rows of a
#pragma unroll
      for (int kk = 0; kk < kRTile; ++kk) aw[kk * kRTile + lane] = part[kk];
      parts_b[warp * kRTile + lane] = part_b;
    }
    __syncthreads();  // the round's partial sums are in shared memory
    const int nw = min(kWarps, nch - c0);
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int o = threadIdx.x + i * kThreads;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww)
        if (ww < nw) acc[i] += as[ww * kOuterN * kRTile + o];
    }
    if (with_db && threadIdx.x < kRTile) {
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww)
        if (ww < nw) acc_b += parts_b[ww * kRTile + threadIdx.x];
    }
    __syncthreads();  // before the next round overwrites them
  }
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int o = threadIdx.x + i * kThreads;
    const int k = k0 + o / kRTile, j = j0 + o % kRTile;
    if (k < jb.K && j < jb.J) jb.dw[(size_t)k * jb.J + j] = acc[i];
  }
  if (with_db && threadIdx.x < kRTile && j0 + threadIdx.x < jb.J) jb.db[j0 + threadIdx.x] = acc_b;
}

cudaError_t launch_tiles(OuterArgs& p, cudaStream_t stream) {
  int tiles = 0;
  for (int q = 0; q < p.n_jobs; ++q) {
    OuterJob& jb = p.job[q];
    jb.tiles_j = cdiv(jb.J, kRTile);
    jb.tile0 = tiles;
    tiles += cdiv(jb.K, kRTile) * jb.tiles_j;
  }
  if (tiles == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (size_t)kRSmemFloats;
  cudaError_t err = allow_smem(tile_reduce_kernel, smem);
  if (err != cudaSuccess) return err;
  tile_reduce_kernel<<<tiles, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------- phase A: MLP
// A cluster of C blocks (ops/fused.py mlp_bwd_geometry: C = 8 at 160 rows,
// 4 at 480, 1 at 1600 and 4800) shares a tile of kTileRows rows.  Every
// block forms the top layer's dz = g act'(a) for the tile from g and the
// saved output; then layer by layer, g_{l-1} = dz_l W_l^T is a
// cluster_dense_t over the cluster (each block its 32-column chunks of
// W_l's rows), whose epilogue forms dz_{l-1} = g_{l-1} act'(a_{l-1}),
// writes it to the scratch that phase B reads and into every block's
// buffer for the next layer; the last product writes dx.
constexpr int kMaxLayers = 4;  // as fused_mlp.cu
constexpr int kWarps8 = kThreads / 32;

struct MlpBwdArgs {
  const float* g;  // [N, dims[n_layers]]
  float* dx;       // [N, dims[0]] or null
  int n, n_layers;
  int cluster;     // blocks of a cluster, splitting each product's columns
  int ld;          // row stride of the two gradient buffers
  int dims[kMaxLayers + 1];
  int acts[kMaxLayers];
  const float* w[kMaxLayers];
  const float* a[kMaxLayers];  // saved post-activations [N, dims[l + 1]]
  float* dz[kMaxLayers];       // scratch [N, dims[l + 1]]
};

__global__ void __launch_bounds__(kThreads, 2) mlp_bwd_kernel(MlpBwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                // kRingT
  float* parts = ring + kRingT;      // kParts
  float* buf = parts + kParts;       // 2 x kTileRows x ld
  const Peers pe;
  const int row0 = (blockIdx.x / p.cluster) * kTileRows;
  const int rows = min(kTileRows, p.n - row0);
  const int L = p.n_layers;

  // the first product's first round flies while the top layer's dz for the
  // tile's rows is formed, in every block (rank 0 writes it)
  const bool any = L > 1 || p.dx != nullptr;
  const TTerm t_top[1] = {{buf, p.ld, p.dims[L], p.w[L - 1]}};
  ProductPlan plan{};
  if (any) plan = stage_product(t_top, p.dims[L - 1], pe, ring);
  const int dn = p.dims[L];
  for (int i = threadIdx.x; i < kTileRows * dn; i += kThreads) {
    const int r = i / dn, j = i - r * dn;
    float v = 0.f;
    if (r < rows) {
      const size_t o = (size_t)(row0 + r) * dn + j;
      v = __ldg(p.g + o) * act_grad_from_output(__ldg(p.a[L - 1] + o), p.acts[L - 1]);
      if (pe.rank == 0) p.dz[L - 1][o] = v;
    }
    buf[r * p.ld + j] = v;
  }
  // every block of the cluster runs before any writes into its shared memory
  cluster_sync_all();

  for (int l = L - 1; l >= 0; --l) {
    if (l == 0 && p.dx == nullptr) break;
    const int K = p.dims[l], D = p.dims[l + 1];
    const TTerm t[1] = {{buf + ((L - 1 - l) & 1) * kTileRows * p.ld, p.ld, D, p.w[l]}};
    if (l < L - 1) plan = stage_product(t, K, pe, ring);
    if (l > 0) {  // g_{l-1} = dz_l W_l^T, then dz_{l-1} into the other buffer
      float* out = buf + ((L - l) & 1) * kTileRows * p.ld;
      const float* a = p.a[l - 1];
      float* dz = p.dz[l - 1];
      const int act = p.acts[l - 1];
      cluster_dense_t(t, plan, pe, ring, parts, [&](int r, int k, float v, float) {
        float d = 0.f;
        if (r < rows) {
          const size_t o = (size_t)(row0 + r) * K + k;
          d = v * act_grad_from_output(__ldg(a + o), act);
          dz[o] = d;
        }
        pe.put(out + r * p.ld + k, d);
      });
    } else {
      cluster_dense_t(t, plan, pe, ring, parts, [&](int r, int k, float v, float) {
        if (r < rows) p.dx[(size_t)(row0 + r) * K + k] = v;
      });
    }
  }
}

// ------------------------------------------ phase A: one long-K layer
// The conv model's one-layer encoders of long K (10816 or 1600 -> 256, 160
// rows): dx = dz W^T has 10816 or 1600 output columns and a short j (256).
// mlp_bwd_kernel's clusters split those columns over blocks of 8 rows, so
// they re-read W from L2 once per 8 rows, and its unit (2 rows x 4 columns
// a lane) is bound by shared-memory reads, ~3x its FMA time.  Here a block
// takes a tile of kLongRows rows: it forms the tile's dz = g act'(a) once in
// its shared memory (the first block of a row tile also writes it to phase
// B's scratch), then walks its run of 64-column steps of dx.  A round takes
// 4 blocks of 32 j of one step: it stages W's rows of the step's columns
// for them ([2][32 cols][kWLd] each, as cluster_dense.cuh stages them), and
// warps 2 q and 2 q + 1 form the partial sums p_j of the round's j-block q,
// 16 rows each, 4 rows x 8 columns a lane (`wide_part_t`), into shared
// memory; so each staged tile serves 32 rows.  Thread t then adds the
// round's p_j in j order to its outputs t + 256 e of the step, acc = ((p_0
// + p_1) + p_2) + ..., the chain mlp_bwd_kernel forms: its bits.
constexpr int kLongRows = 32;                        // rows of a tile
constexpr int kLongChunks = 2;                       // 32-column chunks of a step
constexpr int kLongCols = kLongChunks * kChunk32;    // columns of a step
constexpr int kLongPairs = kWarps8 / 2;              // blocks of j of a round
constexpr int kLongSlotT = kLongChunks * kUnitT;     // a block of j's W tiles
constexpr int kLongStageT = kLongPairs * kLongSlotT; // a round's
constexpr int kLongPld = kLongCols + 2;              // row stride of the partial sums
constexpr int kLongParts = kLongPairs * kLongRows * kLongPld;
constexpr int kLongOwnT = kLongRows * kLongCols / kThreads;  // outputs a thread adds

struct MlpBwdLongKArgs {
  const float* g;  // [n, D]
  const float* a;  // the saved output [n, D]
  const float* w;  // [K, D]
  float* dz;       // scratch [n, D]
  float* dx;       // [n, K] or null
  int n, K, D, act;
  int col_blocks;  // blocks of a row tile
  int steps;       // 64-column steps of dx a block takes
  int ldd;         // row stride of the tile's dz in shared memory
};

__host__ __device__ inline int bwd_long_k_smem_floats(int ldd) {
  return 2 * kLongStageT + kLongParts + kLongRows * ldd;
}

// Round u (step step0 + u / ngroups, blocks of j 4 (u % ngroups) + s) of
// W's tiles into `stage`: thread t copies row t / 8 and float4 t % 8 of
// each chunk's [32 cols][32 j] of each block of j.
__device__ __forceinline__ void stage_bwd_long_k(const MlpBwdLongKArgs& p, int step0, int ngroups,
                                                 int u, float* stage) {
  const int st = u / ngroups, gi = u - st * ngroups;
  const int kr = threadIdx.x >> 3, f4 = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int s = 0; s < kLongPairs; ++s) {
    const int j = (gi * kLongPairs + s) * kBlockK + f4;
    if (j >= p.D) break;
#pragma unroll
    for (int c = 0; c < kLongChunks; ++c) {
      const int col = (step0 + st) * kLongCols + c * kChunk32 + kr;
      if (col < p.K)
        copy4_async(stage + s * kLongSlotT + c * kUnitT + kr * kWLd + f4,
                    p.w + (size_t)col * p.D + j, p.D - j);
    }
  }
}

// part[i][c] += a_i[j + m] w_c[j + m] for m < 4, in order, for the lane's 4
// rows (a0, row stride lda) and its 8 staged columns (w0: column cg of the
// first chunk; c >> 2 picks the chunk, c & 3 the column cg + 8 (c & 3)).
__device__ __forceinline__ void wide_step4_t(float (&part)[4][8], const float* a0, int lda,
                                             const float* w0, int j) {
  float4 xs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xs[i] = *reinterpret_cast<const float4*>(a0 + i * lda + j);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 wv =
        *reinterpret_cast<const float4*>(w0 + (c >> 2) * kUnitT + (c & 3) * 8 * kWLd + j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      part[i][c] = fmaf(xs[i].x, wv.x, part[i][c]);
      part[i][c] = fmaf(xs[i].y, wv.y, part[i][c]);
      part[i][c] = fmaf(xs[i].z, wv.z, part[i][c]);
      part[i][c] = fmaf(xs[i].w, wv.w, part[i][c]);
    }
  }
}

// A lane's partial sums over kn <= 32 steps of j: rows 4 rg .. 4 rg + 3 of
// `a` (row stride lda) and columns cg + 8 v of each of the two staged
// chunks `w` ([2][32 cols][kWLd]); part[i][4 c + v] is row 4 rg + i, column
// 32 c + cg + 8 v.  Each is summed in j order from zero, as unit_sums_t
// sums it.
__device__ __forceinline__ void wide_part_t(float (&part)[4][8], const float* a, int lda,
                                            const float* w, int rg, int cg, int kn) {
  const float* a0 = a + 4 * rg * lda;
  const float* w0 = w + cg * kWLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) part[i][c] = 0.f;
  int j = 0;
  if (kn == kBlockK) {  // a whole block of j, unrolled so that loads run ahead
#pragma unroll
    for (int j4 = 0; j4 < kBlockK; j4 += 4) wide_step4_t(part, a0, lda, w0, j4);
    j = kBlockK;
  }
  for (; j + 4 <= kn; j += 4) wide_step4_t(part, a0, lda, w0, j);
  for (; j < kn; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        part[i][c] = fmaf(a0[i * lda + j], w0[(c >> 2) * kUnitT + (c & 3) * 8 * kWLd + j],
                          part[i][c]);
  }
}

__global__ void __launch_bounds__(kThreads, 1) mlp_bwd_long_k_kernel(MlpBwdLongKArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                 // 2 x kLongStageT
  float* parts = ring + 2 * kLongStageT;              // [kLongPairs][kLongRows][kLongPld]
  float* dzs = parts + kLongParts;                    // [kLongRows][ldd]
  const int rt = blockIdx.x / p.col_blocks, cb = blockIdx.x - rt * p.col_blocks;
  const int row0 = rt * kLongRows, rows = min(kLongRows, p.n - row0);
  const int step0 = cb * p.steps;
  const int nsteps = p.dx == nullptr ? 0 : min(p.steps, cdiv(p.K, kLongCols) - step0);
  const int njb = cdiv(p.D, kBlockK), ngroups = cdiv(njb, kLongPairs);
  const int rounds = nsteps * ngroups;  // (step, 4 blocks of j), j fastest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp >> 1, h = warp & 1, rg = lane >> 3, cg = lane & 7;

  if (rounds > 0) stage_bwd_long_k(p, step0, ngroups, 0, ring);
  copy_commit();
  // the tile's dz while the first tiles fly (thread t takes columns t +
  // i kThreads of the tile's rows, each column's loads issued at once)
  for (int j = threadIdx.x; j < p.D; j += kThreads) {
    float gv[kLongRows], av[kLongRows];
#pragma unroll
    for (int r = 0; r < kLongRows; ++r) {
      if (r < rows) {
        const size_t o = (size_t)(row0 + r) * p.D + j;
        gv[r] = __ldg(p.g + o);
        av[r] = __ldg(p.a + o);
      }
    }
#pragma unroll
    for (int r = 0; r < kLongRows; ++r) {
      float v = 0.f;
      if (r < rows) {
        v = gv[r] * act_grad_from_output(av[r], p.act);
        if (cb == 0) p.dz[(size_t)(row0 + r) * p.D + j] = v;
      }
      dzs[r * p.ldd + j] = v;
    }
  }

  float acc[kLongOwnT];
  for (int u = 0; u < rounds; ++u) {
    copy_wait<0>();
    __syncthreads();  // round u has landed (and dz); round u - 1's stage and sums are read
    if (u + 1 < rounds)
      stage_bwd_long_k(p, step0, ngroups, u + 1, ring + ((u + 1) & 1) * kLongStageT);
    copy_commit();
    const int st = u / ngroups, gi = u - st * ngroups;
    const int jb = gi * kLongPairs + q;
    const int nj = min(kLongPairs, njb - gi * kLongPairs);
    if (jb < njb) {
      float part[4][8];
      wide_part_t(part, dzs + h * 16 * p.ldd + jb * kBlockK, p.ldd,
                  ring + (u & 1) * kLongStageT + q * kLongSlotT, rg, cg,
                  min(kBlockK, p.D - jb * kBlockK));
      float* pq = parts + q * kLongRows * kLongPld;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          pq[(h * 16 + 4 * rg + i) * kLongPld + (c >> 2) * kChunk32 + cg + 8 * (c & 3)] =
              part[i][c];
    }
    __syncthreads();  // the round's partial sums are in `parts`
    // outputs t + 256 e of the step: row o / 64, column o % 64
#pragma unroll
    for (int e = 0; e < kLongOwnT; ++e) {
      const int o = threadIdx.x + e * kThreads;
      const float* src = parts + (o / kLongCols) * kLongPld + o % kLongCols;
      float v[kLongPairs];
#pragma unroll
      for (int s = 0; s < kLongPairs; ++s) v[s] = s < nj ? src[s * kLongRows * kLongPld] : 0.f;
      float sum = gi == 0 ? 0.f : acc[e];
#pragma unroll
      for (int s = 0; s < kLongPairs; ++s)
        if (s < nj) sum += v[s];
      acc[e] = sum;
    }
    if (gi == ngroups - 1) {
      const int col0 = (step0 + st) * kLongCols;
#pragma unroll
      for (int e = 0; e < kLongOwnT; ++e) {
        const int o = threadIdx.x + e * kThreads;
        const int r = o / kLongCols, k = col0 + o % kLongCols;
        if (r < rows && k < p.K) p.dx[(size_t)(row0 + r) * p.K + k] = acc[e];
      }
    }
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
//   that `tile_reduce_kernel` forms, with the rows split over the warps
//   (the where prior's 4 x 4 over 1600 rows: 50 row blocks, 7 rounds, not
//   one thread's walk).
// - input-gradient blocks: a tile of `rows` batch rows x kVTileCols columns
//   of [dx | dh] = dz [W; U]^T.  Warp w of a round takes K-block 8 q + w of
//   the units: it stages those 32 columns of the tile's rows of [W; U]
//   into its own shared memory with cp.async (16-byte copies where
//   aligned; the rows padded to kVLd floats, so that a warp's float4 reads
//   of 32 rows hit every bank once), forms the rows' dz for them, and sums
//   the 32 products of each output (a lane owns 2 columns x 8 rows).  The
//   owners add the round's partial sums in K order, as one thread walking
//   K would.
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
      // as tile_reduce_kernel: the block's 32 rows in order into partial sums
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
      // the K-block's products in order into partial sums
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
// A cluster of C blocks (ops/fused.py gru_bwd_geometry: C = 8 at 160 rows,
// 4 at 480) shares a tile of kTileRows rows.  Every block forms the tile's
// dc_in = (g z)(1 - c^2); drh = dc_in Uc^T is a cluster_dense_t whose
// owners put it into every block; every block then forms da = [g (c - h),
// drh h] zr (1 - zr) for the tile, and the two input gradients are
// cluster_dense_t's: dx = dc_in Wc^T + da Wg^T, both terms in one chain (as
// the first design summed them into one accumulator), and dh = g (1 - z) +
// drh r + da Ug^T.  Row r's scratch for phase B (dc_in, da, r h) is written
// by block r mod C; dx and dh by the owner of each column.
struct GruBwdArgs {
  const float *h, *wg, *ug, *wc, *uc, *zr, *c, *g;
  float *dc_in, *da, *rh, *dx, *dh;  // dx, dh null to skip
  int n, d_x, units;
  int ldu, ldu2;  // row strides of the tile's [8][units] and [8][2 units] buffers
};

__host__ __device__ inline int gru_bwd_smem_floats(int units) {
  return kRingT + kParts + kTileRows * (2 * round4(units) + round4(2 * units));
}

__global__ void __launch_bounds__(kThreads, 2) gru_bwd_kernel(GruBwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                       // kRingT
  float* parts = ring + kRingT;             // kParts
  float* dcs = parts + kParts;              // [8][ldu]: dc_in
  float* drh = dcs + kTileRows * p.ldu;     // [8][ldu]: dc_in Uc^T
  float* das = drh + kTileRows * p.ldu;     // [8][ldu2]: da
  const Peers pe;
  const int U = p.units, u2 = 2 * U, C = pe.n, rank = pe.rank;
  const int row0 = (blockIdx.x / C) * kTileRows;
  const int rows = min(kTileRows, p.n - row0);

  // drh's first round flies while dc_in is formed (thread t takes columns
  // t + i kThreads of the tile's 8 rows, each column's loads issued at once)
  const TTerm t_drh[1] = {{dcs, p.ldu, U, p.uc}};
  ProductPlan plan = stage_product(t_drh, U, pe, ring);
  for (int j = threadIdx.x; j < U; j += kThreads) {
    float z[kTileRows], cv[kTileRows], gv[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      if (r < rows) {
        const size_t row = (size_t)(row0 + r);
        z[r] = p.zr[row * u2 + j];
        cv[r] = p.c[row * U + j];
        gv[r] = p.g[row * U + j];
      }
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      float v = 0.f;
      if (r < rows) {
        v = (gv[r] * z[r]) * (1.f - cv[r] * cv[r]);
        if (r % C == rank) p.dc_in[(size_t)(row0 + r) * U + j] = v;
      }
      dcs[r * p.ldu + j] = v;
    }
  }
  cluster_dense_t(t_drh, plan, pe, ring, parts,
                  [&](int r, int k, float v, float) { pe.put(drh + r * p.ldu + k, v); });

  // the first input gradient's first round flies while da is formed: its
  // update-gate half g (c - h) z (1 - z) and its reset-gate half
  // (dc_in Uc^T) h r (1 - r), column j of each; also r h for phase B
  const TTerm t_dx[2] = {{dcs, p.ldu, U, p.wc}, {das, p.ldu2, u2, p.wg}};
  const TTerm t_dh[1] = {{das, p.ldu2, u2, p.ug}};
  if (p.dx != nullptr) plan = stage_product(t_dx, p.d_x, pe, ring, true);
  else if (p.dh != nullptr) plan = stage_product(t_dh, U, pe, ring);
  constexpr int kHalf = kTileRows / 2;  // rows whose loads fly at once (no spills)
  for (int i = threadIdx.x; i < 2 * U; i += kThreads) {
    const int r0 = i < U ? 0 : kHalf, j = i < U ? i : i - U;
    float z[kHalf], rg[kHalf], cv[kHalf], gv[kHalf], hv[kHalf];
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      if (r0 + q < rows) {
        const size_t row = (size_t)(row0 + r0 + q);
        z[q] = p.zr[row * u2 + j];
        rg[q] = p.zr[row * u2 + U + j];
        cv[q] = p.c[row * U + j];
        gv[q] = p.g[row * U + j];
        hv[q] = p.h[row * U + j];
      }
    }
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const int r = r0 + q;
      float vz = 0.f, vr = 0.f;
      if (r < rows) {
        const size_t row = (size_t)(row0 + r);
        const float dz = gv[q] * (cv[q] - hv[q]);
        vz = dz * z[q] * (1.f - z[q]);
        const float dr = drh[r * p.ldu + j] * hv[q];
        vr = dr * rg[q] * (1.f - rg[q]);
        if (r % C == rank) {
          p.da[row * u2 + j] = vz;
          p.da[row * u2 + U + j] = vr;
          p.rh[row * U + j] = rg[q] * hv[q];
        }
      }
      das[r * p.ldu2 + j] = vz;
      das[r * p.ldu2 + U + j] = vr;
    }
  }
  if (p.dx != nullptr) {
    cluster_dense_t(t_dx, plan, pe, ring, parts, [&](int r, int k, float v, float) {
      if (r < rows) p.dx[(size_t)(row0 + r) * p.d_x + k] = v;
    });
    if (p.dh != nullptr) plan = stage_product(t_dh, U, pe, ring);
  }
  if (p.dh != nullptr) {
    cluster_dense_t(t_dh, plan, pe, ring, parts, [&](int r, int k, float v, float) {
      if (r < rows) {
        const size_t row = (size_t)(row0 + r);
        const size_t o = row * U + k;
        const float z = p.zr[row * u2 + k], rg = p.zr[row * u2 + U + k];
        p.dh[o] = p.g[o] * (1.f - z) + drh[r * p.ldu + k] * rg + v;
      }
    });
  }
}

}  // namespace sqair

// fused_mlp backward.  x [n, dims[0]], g [n, dims[n_layers]] (gradient of
// the output), saved post-activations a[l] [n, dims[l + 1]] (a[n_layers - 1]
// is the output), weights w[l] [dims[l], dims[l + 1]] -> dx [n, dims[0]]
// (null to skip), dw[l] like w[l], db[l] [dims[l + 1]].  dz[l]
// [n, dims[l + 1]] is scratch.  `dims`, `acts`, `w`, `a`, `dz`, `dw` and
// `db` are host arrays.  All f32, contiguous and on the device.  `geom` is
// the host's launch geometry (ops/fused.py mlp_bwd_geometry): tile rows,
// cluster size, phase A's blocks and dynamic shared memory bytes; the
// launch is refused unless it matches this file's.  Launches phase A and
// phase B on `stream`, does not synchronise, allocates nothing, and
// returns the CUDA error code of the launches (0 on success).
extern "C" int sqair_fused_mlp_bwd(const void* x, const void* g, void* dx, int n,
                                   int n_layers, const int* dims, const int* acts,
                                   const void* const* w, const void* const* a,
                                   void* const* dz, void* const* dw, void* const* db,
                                   const int* geom, void* stream) {
  using namespace sqair;
  if (n <= 0 || n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpBwdArgs p{};
  p.g = static_cast<const float*>(g);
  p.dx = static_cast<float*>(dx);
  p.n = n;
  p.n_layers = n_layers;
  p.cluster = geom[1];
  int widest = 1;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || (l > 0 && dims[l] > kMaxWidth)) return (int)cudaErrorInvalidValue;
    p.dims[l] = dims[l];
    if (l > 0 && dims[l] > widest) widest = dims[l];
  }
  p.ld = round4(widest);
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
    jb.ldz = dims[l + 1];
    jb.dw = static_cast<float*>(dw[l]);
    jb.db = static_cast<float*>(db[l]);
    jb.K = dims[l];
    jb.J = dims[l + 1];
  }
  const int tiles = cdiv(n, kTileRows);
  const size_t smem = sizeof(float) * ((size_t)kRingT + kParts + 2 * kTileRows * p.ld);
  if (geom[0] != kTileRows || p.cluster < 1 || p.cluster > kMaxCluster ||
      geom[2] != tiles * p.cluster || (size_t)geom[3] != smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlp_bwd_kernel, p);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_tiles(q, s);
}

// fused_mlp backward of one layer of long K (ops/fused.py picks it by
// shape): x [n, K], g [n, D], the saved output a [n, D], w [K, D] -> dx
// [n, K] (null to skip), dw [K, D], db [D]; dz [n, D] is scratch.  `geom` is
// the host's launch geometry of phase A (ops/fused.py
// mlp_bwd_long_k_geometry): tile rows, blocks of a row tile, steps a block,
// blocks, dynamic shared memory bytes; the launch is refused unless it
// matches this file's.  Phase B is sqair_fused_mlp_bwd's.  Same contract
// as above; the outputs carry its bits.
extern "C" int sqair_fused_mlp_bwd_long_k(const void* x, const void* g, void* dx, int n, int K,
                                          int D, int act, const void* w, const void* a,
                                          void* dz, void* dw, void* db, const int* geom,
                                          void* stream) {
  using namespace sqair;
  if (n <= 0 || K < 1 || D < 1 || D > kMaxWidth || act < kId || act > kTanh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpBwdLongKArgs p{};
  p.g = static_cast<const float*>(g);
  p.a = static_cast<const float*>(a);
  p.w = static_cast<const float*>(w);
  p.dz = static_cast<float*>(dz);
  p.dx = static_cast<float*>(dx);
  p.n = n;
  p.K = K;
  p.D = D;
  p.act = act;
  p.col_blocks = geom[1];
  p.steps = geom[2];
  p.ldd = cdiv(D, 32) * 32 + 4;
  const int blocks = cdiv(n, kLongRows) * p.col_blocks;
  const size_t smem = sizeof(float) * (size_t)bwd_long_k_smem_floats(p.ldd);
  const int steps = cdiv(K, kLongCols);
  if (geom[0] != kLongRows || p.steps < 1 || p.col_blocks != cdiv(steps, p.steps) ||
      geom[3] != blocks || (size_t)geom[4] != smem || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_bwd_long_k_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_long_k_kernel<<<blocks, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  OuterArgs q{};
  q.n = n;
  q.n_jobs = 1;
  q.job[0] = OuterJob{static_cast<const float*>(x), p.dz, static_cast<float*>(dw),
                      static_cast<float*>(db), K, D, K, D};
  return (int)launch_tiles(q, s);
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
// da [n, 2 units] and rh [n, units] are scratch.  `geom` is the host's
// launch geometry of phase A (ops/fused.py gru_bwd_geometry): tile rows,
// cluster size, blocks and dynamic shared memory bytes; the launch is
// refused unless it matches this file's.  Same contract as above.
extern "C" int sqair_fused_gru_bwd(const void* x, const void* h, const void* wg,
                                   const void* ug, const void* wc, const void* uc,
                                   const void* zr, const void* c, const void* g, void* dc_in,
                                   void* da, void* rh, void* dx, void* dh, void* dwg,
                                   void* dug, void* dbg, void* dwc, void* duc, void* dbc,
                                   int n, int d_x, int units, const int* geom, void* stream) {
  using namespace sqair;
  if (n <= 0 || d_x < 1 || units < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GruBwdArgs p{};
  p.h = static_cast<const float*>(h);
  p.wg = static_cast<const float*>(wg);
  p.ug = static_cast<const float*>(ug);
  p.wc = static_cast<const float*>(wc);
  p.uc = static_cast<const float*>(uc);
  p.zr = static_cast<const float*>(zr);
  p.c = static_cast<const float*>(c);
  p.g = static_cast<const float*>(g);
  p.dc_in = static_cast<float*>(dc_in);
  p.da = static_cast<float*>(da);
  p.rh = static_cast<float*>(rh);
  p.dx = static_cast<float*>(dx);
  p.dh = static_cast<float*>(dh);
  p.n = n;
  p.d_x = d_x;
  p.units = units;
  p.ldu = round4(units);
  p.ldu2 = round4(2 * units);
  const int cluster = geom[1];
  const int tiles = cdiv(n, kTileRows);
  const size_t smem = sizeof(float) * (size_t)gru_bwd_smem_floats(units);
  if (geom[0] != kTileRows || cluster < 1 || cluster > kMaxCluster ||
      geom[2] != tiles * cluster || (size_t)geom[3] != smem || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gru_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(gru_bwd_kernel, p, tiles * cluster, cluster, smem, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* xp = static_cast<const float*>(x);
  const float* hp = static_cast<const float*>(h);
  const float* dcp = static_cast<const float*>(dc_in);
  const float* dap = static_cast<const float*>(da);
  OuterArgs q{};
  q.n = n;
  q.n_jobs = 4;
  // {a, dz, dw, db, lda, ldz, K, J}
  q.job[0] = OuterJob{xp, dcp, static_cast<float*>(dwc), static_cast<float*>(dbc), d_x, units,
                      d_x, units};
  q.job[1] = OuterJob{static_cast<const float*>(rh), dcp, static_cast<float*>(duc), nullptr,
                      units, units, units, units};
  q.job[2] = OuterJob{xp, dap, static_cast<float*>(dwg), static_cast<float*>(dbg), d_x,
                      2 * units, d_x, 2 * units};
  q.job[3] = OuterJob{hp, dap, static_cast<float*>(dug), nullptr, units, 2 * units, units,
                      2 * units};
  return (int)launch_tiles(q, s);
}
