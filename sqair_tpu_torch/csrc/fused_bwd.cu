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
// weight gradients over the rows in one body.  On the card that is two
// phases, two launches per call:
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
//
// What bounds them on an H100 at the release model's train-step shapes
// (f32; N = 160 or 480 rows in the time loop, 1600 and 4800 rows in the
// deferred pass; weights up to 2500 x 256): operations, twice the
// forward's FMAs, at most ~3.5 GFLOP for the glimpse decoder at 4800 rows
// (~52 us at 67 TFLOP/s), and well under a microsecond for most calls.
// What the design does about it: nothing yet beyond keeping the chains in
// shared memory; it is right and simple first.  Phase B runs few blocks
// when a dW is small and N is large (the decoder's first layer: 14 blocks
// over 4800 rows), and phase A reads each weight row per thread through
// L1.  Splitting N in phase B (with a second, fixed-order pass) and tiling
// the weights in phase A are later work.

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

// ----------------------------------------------- phase A: vanilla RNN
__global__ void __launch_bounds__(kThreads)
vrnn_bwd_rows_kernel(const float* __restrict__ w, const float* __restrict__ u,
                     const float* __restrict__ hn, const float* __restrict__ g,
                     float* __restrict__ dz, float* __restrict__ dx, float* __restrict__ dh,
                     int n, int d_x, int units) {
  extern __shared__ float dzs[];  // kRows * units
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int i = threadIdx.x; i < kRows * units; i += kThreads) {
    const int r = i / units, j = i - r * units;
    float v = 0.f;
    if (r < rows) {
      const size_t o = (size_t)(row0 + r) * units + j;
      const float hv = hn[o];
      v = g[o] * (1.f - hv * hv);
      dz[o] = v;
    }
    dzs[i] = v;
  }
  __syncthreads();
  if (dx != nullptr) {
    for (int col0 = 0; col0 < d_x; col0 += kMaxWidth) {
      Acc acc;
      zero(acc);
      acc_smem_t(acc, dzs, units, units, w, units, col0, d_x);
      store_rows(acc, dx, d_x, row0, rows, col0, d_x);
    }
  }
  if (dh != nullptr) {
    Acc acc;
    zero(acc);
    acc_smem_t(acc, dzs, units, units, u, units, 0, units);
    store_rows(acc, dh, units, row0, rows, 0, units);
  }
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
// dx [n, d_x] and dh [n, units] (either null to skip), dw, du, db.  dz
// [n, units] is scratch.  Same contract as above.
extern "C" int sqair_fused_vanilla_rnn_bwd(const void* x, const void* h, const void* w,
                                           const void* u, const void* hn, const void* g,
                                           void* dz, void* dx, void* dh, void* dw, void* du,
                                           void* db, int n, int d_x, int units,
                                           void* stream) {
  using namespace sqair;
  if (n <= 0 || d_x < 1 || units < 1 || units > kMaxWidth) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)kRows * units;
  const int blocks = (n + kRows - 1) / kRows;
  vrnn_bwd_rows_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(hn), static_cast<const float*>(g), static_cast<float*>(dz),
      static_cast<float*>(dx), static_cast<float*>(dh), n, d_x, units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  OuterArgs q{};
  q.n = n;
  q.n_jobs = 2;
  q.job[0] = OuterJob{static_cast<const float*>(x), static_cast<const float*>(dz),
                      static_cast<float*>(dw), static_cast<float*>(db), d_x, d_x, units};
  q.job[1] = OuterJob{static_cast<const float*>(h), static_cast<const float*>(dz),
                      static_cast<float*>(du), nullptr, units, units, units};
  return (int)launch_outer(q, s);
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
