// The products of the kernels redesigned for Hopper that hold a tile's state
// in every block of a thread block cluster: the MLP and GRU backwards
// (fused_bwd.cu), the glimpse encoder's forward and backward
// (fused_glimpse.cu), the propagation unroll's forward and backward
// (fused_prop.cu) and the discovery unroll's forward and backward
// (fused_disc.cu).
//
// - cluster_dense_t: the product of a tile's 8 rows of a gradient with a
//   weight's TRANSPOSE, out[r][k] = sum_j a[r][j] W[k][j] for the row-major
//   W [n_cols, J], its output columns split in 32-column chunks over the C
//   blocks of a thread block cluster.  Each block holds every row of the
//   left operand in its own shared memory, stages the rows of W of its
//   chunks in [32 cols][32 j] tiles by cp.async (coalesced: a row of a tile
//   is 128 contiguous bytes), and its 8 warps take one unit a round (one
//   32-wide block of j for one chunk, as tile_sums.cuh).  Each output's
//   owner (warp = row, lane = column of the chunk) adds the round's
//   partial sums in j order, so every output is the chain
//   acc = ((p_0 + p_1) + p_2) + ... of 32-product partial sums that one
//   thread walking j in order forms: the bits of the first designs, in
//   which each thread walked its own row of W.  The owner then runs the
//   caller's epilogue, which writes what every block needs into each
//   block's shared memory (`Peers::put`, distributed shared memory).
// - cluster_dense: the same for the product with W itself, out[r][j] =
//   sum_k a[r][k] W[k][j] for the row-major W [K, n_cols] (the forwards'
//   products): the tiles are W's [32 k][32 cols] blocks (a row of a tile
//   again 128 contiguous bytes) and the unit is tile_sums.cuh's unit_sums,
//   so every output is the same chain over k.
// Both run the same plan, round loop and staging (the template flag T: the
// transposed product or not).
#pragma once

#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "bwd_common.cuh"
#include "tile_sums.cuh"

namespace sqair {

namespace cg = cooperative_groups;

constexpr int kWLd = kBlockK + 4;             // row stride of a staged W tile [32 cols][36]
constexpr int kUnitT = kChunk32 * kWLd;       // a unit's staged weights
constexpr int kStageT = kWarps * kUnitT;      // a round's weights
constexpr int kRingT = 2 * kStageT;           // the double-buffered ring

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
// the offset of the next n floats of a layout, n rounded up to 4 (16 bytes)
__host__ __device__ inline int take4(int& off, int n) { return take(off, round4(n)); }

// The split arrive / wait of the cluster barrier: `arrive` once a block is
// done reading what a peer may write next, `wait` before the first such
// write (or read of a peer's writes).  Every thread of every block of the
// cluster calls both, in turns.  The relaxed arrive orders no memory
// operation: it serves where a block's reads are all done already (behind
// a __syncthreads or a cluster barrier) and it writes nothing that a peer
// reads before the next barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

// The blocks of a cluster: `put` writes a value at the same place of every
// block's shared memory, this block's included.
struct Peers {
  cg::cluster_group cl;
  int n, rank;
  __device__ Peers() : cl(cg::this_cluster()) {
    n = (int)cl.num_blocks();
    rank = (int)cl.block_rank();
  }
  __device__ __forceinline__ void put(float* local, float v) const {
    for (int b = 0; b < n; ++b) *cl.map_shared_rank(local, b) = v;
  }
  // the same place of block b's shared memory only
  __device__ __forceinline__ void put_to(float* local, int b, float v) const {
    *cl.map_shared_rank(local, b) = v;
  }
};

// One left operand and its weight: a [8 rows][lda] (shared memory, lda a
// multiple of 4, 16-byte aligned), J columns of it; w [n_cols, J] for the
// transposed product, [J, n_cols] for the product with w itself.
struct TTerm {
  const float* a;
  int lda, J;
  const float* __restrict__ w;
};

// part[i][c] += a_i[j + m] w[q + 8 c][j + m] for m < 4, in order: the
// lane's two rows (a0, a1) and its columns q, q + 8, q + 16, q + 24 of the
// staged tile w [32 cols][kWLd] (a quarter-warp's 8 lanes read 8 columns
// whose float4s fall in 8 different bank groups).
__device__ __forceinline__ void tstep4(float (&part)[2][4], const float* a0, const float* a1,
                                       const float* w, int j) {
  const float4 x0 = *reinterpret_cast<const float4*>(a0 + j);
  const float4 x1 = *reinterpret_cast<const float4*>(a1 + j);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 wv = *reinterpret_cast<const float4*>(w + c * 8 * kWLd + j);
    part[0][c] = fmaf(x0.x, wv.x, part[0][c]);
    part[0][c] = fmaf(x0.y, wv.y, part[0][c]);
    part[0][c] = fmaf(x0.z, wv.z, part[0][c]);
    part[0][c] = fmaf(x0.w, wv.w, part[0][c]);
    part[1][c] = fmaf(x1.x, wv.x, part[1][c]);
    part[1][c] = fmaf(x1.y, wv.y, part[1][c]);
    part[1][c] = fmaf(x1.z, wv.z, part[1][c]);
    part[1][c] = fmaf(x1.w, wv.w, part[1][c]);
  }
}

// One unit's partial sums over kn <= 32 steps of j, by one warp: lane
// (g, q) takes rows 2 g, 2 g + 1 of `a` (row stride lda) and columns q + 8 c
// of the staged tile `w`, and writes its 2 x 4 sums to `out` [8 rows][32].
__device__ __forceinline__ void unit_sums_t(float* out, const float* a, int lda, const float* w,
                                            int kn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 3, q = lane & 7;
  const float* a0 = a + 2 * g * lda;
  const float* a1 = a0 + lda;
  const float* wq = w + q * kWLd;
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[i][c] = 0.f;
  int j = 0;
  if (kn == kBlockK) {  // a whole block of j, unrolled so that loads run ahead
#pragma unroll
    for (int j4 = 0; j4 < kBlockK; j4 += 4) tstep4(part, a0, a1, wq, j4);
    j = kBlockK;
  }
  for (; j + 4 <= kn; j += 4) tstep4(part, a0, a1, wq, j);
  for (; j < kn; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      part[0][c] = fmaf(a0[j], wq[c * 8 * kWLd + j], part[0][c]);
      part[1][c] = fmaf(a1[j], wq[c * 8 * kWLd + j], part[1][c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[2 * g * kChunk32 + q + 8 * c] = part[0][c];
    out[(2 * g + 1) * kChunk32 + q + 8 * c] = part[1][c];
  }
}

// How a block runs its share of a transposed product of NT (1 or 2) terms:
// its rank's run of Jc 32-column chunks from column col0, in passes of WJ
// chunks, each of QQ rounds (term 0's Q0 rounds of WK blocks of j, then
// term 1's), so that a round puts WK blocks of j of 8 / WK chunks on the 8
// warps: the split with the fewest rounds, the fewer j-blocks on a tie.
// `chain`: term 1's blocks of j go on adding to term 0's sum (one chain
// over both terms, as the GRU backward's first design summed dx's two
// products into one accumulator), not to a sum of their own.
struct ProductPlan {
  int n_cols, Jc, col0, WK, WJ, wj_log, nkb0, nkb1, Q0, QQ, rounds;
  bool chain;
};

template <int NT>
__device__ __forceinline__ ProductPlan plan_product(const TTerm (&t)[NT], int n_cols,
                                                    const Peers& pe) {
  ProductPlan L;
  L.n_cols = n_cols;
  const int chunks = cdiv(n_cols, kChunk32);
  const int per = cdiv(chunks, pe.n);
  L.Jc = max(0, min(per, chunks - pe.rank * per));
  L.col0 = pe.rank * per * kChunk32;
  L.nkb0 = cdiv(t[0].J, kBlockK);
  L.nkb1 = NT > 1 ? cdiv(t[NT - 1].J, kBlockK) : 0;
  L.WK = 1;
  int best = 0x7fffffff;
  for (int w = 1; w <= kWarps; w *= 2) {
    const int r = cdiv(L.Jc, kWarps / w) * (cdiv(L.nkb0, w) + cdiv(L.nkb1, w));
    if (r < best) {
      best = r;
      L.WK = w;
    }
  }
  L.WJ = kWarps / L.WK;
  L.wj_log = L.WJ == 8 ? 3 : L.WJ == 4 ? 2 : L.WJ == 2 ? 1 : 0;
  L.Q0 = cdiv(L.nkb0, L.WK);
  L.QQ = L.Q0 + cdiv(L.nkb1, L.WK);
  L.rounds = cdiv(L.Jc, L.WJ) * L.QQ;
  L.chain = false;
  return L;
}

// Stages round i of a product into `stage`: unit u takes j-block
// q WK + u / WJ of chunk pass WJ + u % WJ.  Transposed (T): thread t copies
// row t / 8 and float4 t % 8 of every unit's [32 cols][32 j] tile of W (row
// stride kWLd); else row t / 8 and float4 t % 8 of its [32 j][32 cols]
// tile (row stride kChunk32).  A unit's tile takes kUnitT floats either way.
template <int NT, bool T>
__device__ __forceinline__ void stage_round(const TTerm* t, const ProductPlan& L, int i,
                                            float* stage) {
  const int pass = i / L.QQ, rem = i - pass * L.QQ;
  const bool second = NT > 1 && rem >= L.Q0;
  const int q = second ? rem - L.Q0 : rem;
  const int J = second ? t[NT - 1].J : t[0].J;
  const float* w = second ? t[NT - 1].w : t[0].w;
  const int kr = threadIdx.x >> 3, f4 = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int chunk = pass * L.WJ + (u & (L.WJ - 1));
    const int j0 = (q * L.WK + (u >> L.wj_log)) * kBlockK;
    if constexpr (T) {
      const int col = L.col0 + chunk * kChunk32 + kr;
      const int j = j0 + f4;
      if (chunk < L.Jc && col < L.n_cols && j < J)
        copy4_async(stage + u * kUnitT + kr * kWLd + f4, w + (size_t)col * J + j, J - j);
    } else {
      const int col = L.col0 + chunk * kChunk32 + f4;
      const int j = j0 + kr;
      if (chunk < L.Jc && col < L.n_cols && j < J)
        copy4_async(stage + u * kUnitT + kr * kChunk32 + f4, w + (size_t)j * L.n_cols + col,
                    L.n_cols - col);
    }
  }
}

// The QQ rounds of pass `pass` of a product (round i's tiles in ring stage
// i % 2, each round staging the next): acc[t kWarps + c] receives term t's
// sum of the owner's output in chunk pass WJ + c.  One copy of this loop
// serves every product of a kernel, so that its code is fetched once.
template <int NT, bool T>
__device__ __noinline__ void product_pass(const TTerm* t, const ProductPlan L, int pass,
                                          float* ring, float* parts, float* acc) {
  const int warp = threadIdx.x >> 5;
  float acc0[kWarps], acc1[kWarps];
#pragma unroll
  for (int c = 0; c < kWarps; ++c) acc0[c] = acc1[c] = 0.f;
  const int jn = min(L.WJ, L.Jc - pass * L.WJ);
  for (int rem = 0; rem < L.QQ; ++rem) {
    const int i = pass * L.QQ + rem;
    const bool second = NT > 1 && rem >= L.Q0;
    const int q = second ? rem - L.Q0 : rem;
    if (i + 1 < L.rounds) stage_round<NT, T>(t, L, i + 1, ring + ((i + 1) & 1) * kStageT);
    copy_commit();
    copy_wait<1>();
    __syncthreads();  // round i's tiles have landed for every thread
    const TTerm& tt = second ? t[NT - 1] : t[0];
    const int nkb = second ? L.nkb1 : L.nkb0;
    const int kb = q * L.WK + (warp >> L.wj_log), chunk = pass * L.WJ + (warp & (L.WJ - 1));
    if (kb < nkb && chunk < L.Jc) {
      float* out = parts + warp * kTileRows * kChunk32;
      const float* w = ring + (i & 1) * kStageT + warp * kUnitT;
      const int kn = min(kBlockK, tt.J - kb * kBlockK);
      if constexpr (T) unit_sums_t(out, tt.a + kb * kBlockK, tt.lda, w, kn);
      else unit_sums(out, tt.a + kb * kBlockK, tt.lda, w, kn);
    }
    __syncthreads();  // every unit's partial sums are in `parts`
    const int nwk = min(L.WK, nkb - q * L.WK);
    if (second && !L.chain) add_round(acc1, parts, L.wj_log, jn, nwk);
    else add_round(acc0, parts, L.wj_log, jn, nwk);
  }
#pragma unroll
  for (int c = 0; c < kWarps; ++c) {
    acc[c] = acc0[c];
    if (NT > 1) acc[kWarps + c] = acc1[c];
  }
}

// Plans the block's share of a product of NT terms with n_cols outputs
// (the two terms in one chain if `chain`) and stages its first round into
// ring stage 0.  A caller may do this early, before work that leaves the
// ring alone, so that the copies fly meanwhile.  Not inlined, as
// product_pass: a kernel of ~20 products keeps one copy.
template <int NT, bool T = true>
__device__ __noinline__ ProductPlan stage_product(const TTerm (&t)[NT], int n_cols,
                                                  const Peers& pe, float* ring,
                                                  bool chain = false) {
  ProductPlan L = plan_product(t, n_cols, pe);
  L.chain = NT > 1 && chain;
  if (L.rounds > 0) stage_round<NT, T>(t, L, 0, ring);
  copy_commit();
  return L;
}

// The product of NT (1 or 2) terms over the cluster, transposed (T) or
// not, for the tile's 8 rows, staged by stage_product<NT, T>: epi(r, k, v0,
// v1) once for each output column k < n_cols of the block's chunks and
// each row r < 8, by its owner thread, with v_t = sum_j t.a[r][j] t.w[k][j]
// (T) or sum_j t.a[r][j] t.w[j][k] (v1 = 0 for one term; v0 the sum of both
// and v1 = 0 for a chained plan), each a chain of 32-product partial sums
// in j order.  `ring` holds kRingT floats and `parts` kParts.  The cluster
// barrier brackets it: the block arrives before its first round (relaxed:
// the caller's reads of what the epilogues overwrite are behind a
// __syncthreads or a cluster barrier), waits before its first epilogue, and
// after its last epilogue waits for every block's, so that they are all
// seen on return.  No epilogue may write what a block reads in the product
// (its left operands).  Every thread of every block calls it.
template <int NT, bool T, typename Epi>
__device__ __forceinline__ void cluster_product(const TTerm (&t)[NT], const ProductPlan& L,
                                                const Peers& pe, float* ring, float* parts,
                                                Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  cluster_arrive_relaxed();
  float acc[NT * kWarps];
  for (int pass = 0; pass * L.QQ < L.rounds; ++pass) {
    product_pass<NT, T>(t, L, pass, ring, parts, acc);
    if (pass == 0) cluster_wait();
    // the pass's outputs: row `warp`, column `lane` of each chunk (a rolled
    // loop: one copy of the caller's epilogue, as acc is in memory anyway)
    const int jn = min(L.WJ, L.Jc - pass * L.WJ);
#pragma unroll 1
    for (int c = 0; c < kWarps; ++c) {
      const int col = L.col0 + (pass * L.WJ + c) * kChunk32 + lane;
      if (c < jn && col < L.n_cols)
        epi(warp, col, acc[c], NT > 1 ? acc[(NT - 1) * kWarps + c] : 0.f);
    }
  }
  if (L.rounds == 0) cluster_wait();
  cluster_sync_all();
}

// The transposed product, staged by stage_product<NT> or at once.
template <int NT, typename Epi>
__device__ __forceinline__ void cluster_dense_t(const TTerm (&t)[NT], const ProductPlan& L,
                                                const Peers& pe, float* ring, float* parts,
                                                Epi epi) {
  cluster_product<NT, true>(t, L, pe, ring, parts, epi);
}

template <int NT, typename Epi>
__device__ __forceinline__ void cluster_dense_t(const TTerm (&t)[NT], int n_cols, const Peers& pe,
                                                float* ring, float* parts, Epi epi) {
  cluster_product<NT, true>(t, stage_product<NT, true>(t, n_cols, pe, ring), pe, ring, parts,
                            epi);
}

// The product with W itself, staged at once.
template <int NT, typename Epi>
__device__ __forceinline__ void cluster_dense(const TTerm (&t)[NT], int n_cols, const Peers& pe,
                                              float* ring, float* parts, Epi epi) {
  cluster_product<NT, false>(t, stage_product<NT, false>(t, n_cols, pe, ring), pe, ring, parts,
                             epi);
}

// Launches `kernel` (one argument struct) on `blocks` blocks of kThreads
// threads in clusters of `cluster`, with `smem` bytes of dynamic shared
// memory.
template <typename Kernel, typename Args>
__host__ cudaError_t launch_cluster(Kernel kernel, const Args& p, int blocks, int cluster,
                                    size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

}  // namespace sqair
