// The round of the kernels redesigned for Hopper that tile their rows by 8
// and split K over the warps: the MLP forward (fused_mlp.cu), the two
// recurrent cells' forwards (fused_rnn.cu) and, through cluster_dense.cuh
// (with the transposed unit of W's rows for the backwards), its cluster
// kernels.
//
// A block's 8 warps each take one unit a round: one 32-row block of K
// (kBlockK) for one 32-column chunk of the outputs, over the tile's 8 rows.
// A unit's weights [32 k][32 cols] are staged in shared memory (cp.async);
// its left operand (the tile's 8 rows of that K-block) is in shared memory
// too.  Each unit writes its 8 x 32 partial sums to `parts`, and each
// output's owner then adds the round's K-blocks to its sum in K order
// (`add_round`).  So every output is the chain acc = ((p_0 + p_1) + p_2)
// + ... of 32-product partial sums that one thread walking K would form:
// the bits of the first designs, one block per 8 rows, in which each
// thread walked K for its columns.
#pragma once

#include "common.cuh"

namespace sqair {

constexpr int kTileRows = 8;                           // rows of a tile
constexpr int kWarps = kThreads / 32;                  // units of a round
constexpr int kChunk32 = 32;                           // output columns of a unit
constexpr int kUnitW = kBlockK * kChunk32;             // a unit's weights [32 k][32 cols]
constexpr int kStageW = kWarps * kUnitW;               // a round's weights
constexpr int kParts = kWarps * kTileRows * kChunk32;  // a round's partial sums
constexpr int kMaxCluster = 8;
static_assert(kWarps == kTileRows, "the owner of an output is the warp of its row");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// part[i][j] += a[r_i][k + m] * w[k + m][c_j] for m < 4, in order: the
// lane's 2 rows (a0, a1) and 4 columns (wt, a float4 of [k][32] rows).
__device__ __forceinline__ void tile_step4(float (&part)[2][4], const float* a0,
                                           const float* a1, const float* wt, int k) {
  const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
  const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
  const float xs[2][4] = {{x0.x, x0.y, x0.z, x0.w}, {x1.x, x1.y, x1.z, x1.w}};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 wv = *reinterpret_cast<const float4*>(wt + (k + m) * kChunk32);
    const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = fmaf(xs[i][m], ws[j], part[i][j]);
  }
}

// One unit's partial sums over kn <= 32 K-steps, by one warp: lane (g, c4)
// takes rows 2 g, 2 g + 1 of the left operand `a` (row stride lda, 16-byte
// aligned rows) and columns 4 c4 .. 4 c4 + 3 of the staged weights `w`
// ([32 k][32 cols]), and writes its 2 x 4 sums to `out` ([8 rows][32]).
__device__ __forceinline__ void unit_sums(float* out, const float* a, int lda, const float* w,
                                          int kn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 3, c4 = (lane & 7) * 4;
  const float* wt = w + c4;
  const float* a0 = a + 2 * g * lda;
  const float* a1 = a0 + lda;
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
  int k = 0;
  if (kn == kBlockK) {  // a whole K-block, unrolled so that loads run ahead
#pragma unroll
    for (int k4 = 0; k4 < kBlockK; k4 += 4) tile_step4(part, a0, a1, wt, k4);
    k = kBlockK;
  }
  for (; k + 4 <= kn; k += 4) tile_step4(part, a0, a1, wt, k);
  for (; k < kn; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      part[0][j] = fmaf(a0[k], wt[k * kChunk32 + j], part[0][j]);
      part[1][j] = fmaf(a1[k], wt[k * kChunk32 + j], part[1][j]);
    }
  }
  float* pw = out + 2 * g * kChunk32 + c4;
  *reinterpret_cast<float4*>(pw) = make_float4(part[0][0], part[0][1], part[0][2], part[0][3]);
  *reinterpret_cast<float4*>(pw + kChunk32) = make_float4(part[1][0], part[1][1], part[1][2],
                                                          part[1][3]);
}

// After a round whose unit u = (wk << wj_log) + i took K-block wk of the
// pass's chunk i: thread (warp, lane) adds the round's nwk K-blocks of row
// `warp`, column `lane` of each of the pass's jn chunks to acc[i], in K
// order.  One body per split (WJ = 2^wj_log chunks of 8 / WJ K-blocks), so
// that a round reads at most the 8 sums it adds.
template <int WJ>
__device__ __forceinline__ void add_round_wj(float (&acc)[kWarps], const float* pr, int jn,
                                             int nwk) {
#pragma unroll
  for (int i = 0; i < WJ; ++i) {
    if (i < jn) {
      float sum = acc[i];
#pragma unroll
      for (int j = 0; j < kWarps / WJ; ++j)
        if (j < nwk) sum += pr[(j * WJ + i) * kTileRows * kChunk32];
      acc[i] = sum;
    }
  }
}

__device__ __forceinline__ void add_round(float (&acc)[kWarps], const float* parts, int wj_log,
                                          int jn, int nwk) {
  const float* pr = parts + (threadIdx.x >> 5) * kChunk32 + (threadIdx.x & 31);
  switch (wj_log) {
    case 0: add_round_wj<1>(acc, pr, jn, nwk); break;
    case 1: add_round_wj<2>(acc, pr, jn, nwk); break;
    case 2: add_round_wj<4>(acc, pr, jn, nwk); break;
    default: add_round_wj<8>(acc, pr, jn, nwk); break;
  }
}

// The MLP forward of fused_mlp.cu (defined there), launched on `stream` as
// sqair_fused_mlp launches it, with `out_ld` the row stride of y and of the
// saved layers (0: each its own width), so that a caller may write the
// layers side by side (the discovery unroll's input encoder, fused_disc.cu).
cudaError_t launch_mlp_fwd(const float* x, float* y, int n, int n_layers, const int* dims,
                           const int* acts, const float* const* w, const float* const* b,
                           float* const* saved, int out_ld, const int* geom,
                           cudaStream_t stream);

}  // namespace sqair
