// The fused glimpse encoder, forward and backward.
//
// Replaces: sqair_tpu/ops/fused_glimpse.py, `_run_fwd` (the Pallas kernel
// `_fwd_kernel`) and `_run_bwd` (`_bwd_kernel`), behind
// `fused_glimpse_encoder`.  Per row b of the batch:
//
//   s = sigmoid(wl[b, :2]), t = tanh(wl[b, 2:]); s_c = max(s, 1e-4)
//   u_i = (s_c t_i + t + 1)(src - 1) / 2, t_i = i 2/(dst - 1) - 1
//   wy[i, p] = max(0, 1 - |u_i - p|)  [gh, H], wx alike [gw, W]
//   g0 = wy (img_b wx^T)              [gh, gw], saved
//   mhid = elu(mi Wm1 + bm1), mask = sigmoid(mhid Wm2 + bm2)   (masked)
//   h1 = elu((g0 * mask) We1 + be1), h2 = elu(h1 We2 + be2)
//   loc, z = split(h2 Wh + bh); scale = softplus(z) + 1e-2
//
// and the backward of it all, with elu' read off the output (1 at 0, as
// the JAX package's `_delu`), softplus' read off the saved scale, and the
// where-gradient through the interpolation weights:
//   du_i = sum_p dwy[i, p] (wy[i, p] > 0 ? -sign(u_i - p) : 0),
//   d s_c = sum_i du_i t_i (src - 1)/2, d t = sum_i du_i (src - 1)/2,
// the clip straight-through and then the sigmoid / tanh derivatives.  No
// gradient goes into img.
//
// What bounds it on an H100 at the release model's shapes (f32, B k = 160
// rows, 50 x 50 frames, 20 x 20 glimpses, mask 256 -> 128 -> 400, encoder
// 400 -> 256 -> 256, head 256 -> 100): operations.  The forward does about
// 111 MFLOP (crop 22.4, mask 26.9, encoder 53.7, head 8.2), 1.7 us at
// 67 TFLOP/s off the tensor cores, against 1.1 MB of weights and 1.6 MB of
// frames (0.8 us at 3.35 TB/s); the backward about twice that.  What the
// design does: one block owns kRows rows, as in fused_mlp.cu; it crops its
// rows one at a time with the interpolation matrices in shared memory,
// keeps the glimpses and the layers' activations there, and streams the
// weights through L2.  The crop products are plain f32 FMAs (the JAX
// package runs them at Precision.HIGHEST; no TF32 here either).  At 160
// rows that is 20 blocks on 132 SMs: the kernel is right, not fast.
//
// The backward is two launches, as fused_bwd.cu: phase A, row-parallel
// (glimpse_bwd_rows_kernel), chains the row gradients from the head down to
// the mask input and the where logits and writes each layer's dz to
// scratch; phase B (tile_reduce_kernel) reduces dWh, dWe2, dWe1, dWm2 and
// dWm1 with their biases over all rows in fixed order.  No atomics.
//
// The crop, its backward and the encoder's layers are device code shared
// with fused_prop.cu (glimpse_common.cuh).

#include "glimpse_common.cuh"

namespace sqair {

struct GlimpseDims {
  int n, H, W, gh, gw;
  int d_mi, d_m;  // mask input and mask hidden widths (0 when unmasked)
  int d1, d2;     // encoder widths
  int n_what;
};

__host__ __device__ inline CropDims crop_dims(const GlimpseDims& d) {
  return CropDims{d.H, d.W, d.gh, d.gw};
}

// ------------------------------------------------------------- forward
struct GlimpseFwdArgs {
  GlimpseDims d;
  const float *img, *wl, *mi, *wm1, *bm1, *wm2, *bm2, *we1, *be1, *we2, *be2, *wh, *bh;
  float *loc, *scale;
  float *g0, *h1, *h2, *mask, *mhid;  // saved for the backward, or null
};

__global__ void __launch_bounds__(kThreads) glimpse_fwd_kernel(GlimpseFwdArgs p) {
  extern __shared__ float smem[];
  const GlimpseDims& d = p.d;
  const int G = d.gh * d.gw;
  const bool masked = p.mi != nullptr;
  float* gs = smem;                     // kRows x G: the (masked) glimpses
  float* mh = gs + kRows * G;           // kRows x d_m
  float* h1s = mh + kRows * d.d_m;      // kRows x d1
  float* h2s = h1s + kRows * d.d1;      // kRows x d2
  float* stage = h2s + kRows * d.d2;    // kRows x kChunk
  const CropDims cd = crop_dims(d);
  const CropSmem cs(stage + kRows * kChunk, cd);
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, d.n - row0);

  // the crop, one row at a time
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) {
      for (int i = threadIdx.x; i < G; i += kThreads) gs[r * G + i] = 0.f;
      continue;
    }
    const int b = row0 + r;
    float c[4];
    crop_setup(p.img + (size_t)b * d.H * d.W, p.wl + (size_t)b * 4, cd, cs, c);
    crop_glimpse(cd, cs, gs + r * G, p.g0 == nullptr ? nullptr : p.g0 + (size_t)b * G);
  }
  __syncthreads();  // the zero rows of a ragged block are written too

  Acc acc;
  if (masked) {
    zero(acc);
    acc_global(acc, p.mi + (size_t)row0 * d.d_mi, d.d_mi, rows, d.d_mi, p.wm1, d.d_m, d.d_m,
               stage);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j < d.d_m) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float v = apply_act(acc[c][r] + p.bm1[j], kElu);
          mh[r * d.d_m + j] = v;
          if (r < rows && p.mhid != nullptr) p.mhid[(size_t)(row0 + r) * d.d_m + j] = v;
        }
      }
    }
    __syncthreads();
    zero(acc);
    acc_smem(acc, mh, d.d_m, d.d_m, p.wm2, G, G);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j < G) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float m = apply_act(acc[c][r] + p.bm2[j], kSigmoid);
          gs[r * G + j] *= m;  // column j of every row is this thread's alone
          if (r < rows && p.mask != nullptr) p.mask[(size_t)(row0 + r) * G + j] = m;
        }
      }
    }
    __syncthreads();
  }

  // encoder: two elu layers, activations in shared memory
  encode_rows<kRows>(gs, G, p.we1, p.be1, d.d1, p.we2, p.be2, d.d2, h1s, h2s,
                     p.h1 == nullptr ? nullptr : p.h1 + (size_t)row0 * d.d1, d.d1,
                     p.h2 == nullptr ? nullptr : p.h2 + (size_t)row0 * d.d2, d.d2, rows);

  // the Gaussian head: loc, softplus(z) + 1e-2 with the JAX package's softplus
  const int D = 2 * d.n_what;
  zero(acc);
  acc_smem(acc, h2s, d.d2, d.d2, p.wh, D, D);
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = threadIdx.x + c * kThreads;
    if (j < D) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) continue;
        const float z = acc[c][r] + p.bh[j];
        const size_t row = (size_t)(row0 + r);
        if (j < d.n_what) {
          p.loc[row * d.n_what + j] = z;
        } else {
          p.scale[row * d.n_what + j - d.n_what] = softplus(z) + kMinStd;
        }
      }
    }
  }
}

// --------------------------------------------------- backward, phase A
struct GlimpseBwdArgs {
  GlimpseDims d;
  const float *img, *wl, *mi, *wm1, *wm2, *we1, *we2, *wh;
  const float *g0, *h1, *h2, *scale, *mask, *mhid, *dloc, *dscale;
  float *dwl, *dmi;
  // phase A's rows for phase B: dhp [n, 2 n_what], dz2 [n, d2], dz1 [n, d1]
  // and, when masked, gflat (the masked glimpse) [n, G], dmz2 [n, G], dmz1 [n, d_m]
  float *dhp, *dz2, *dz1, *gflat, *dmz2, *dmz1;
};

// out[r * ld + col] = acc[c][r] * act'(saved[row0 + r, col]) for the block's
// rows (0 past them), and the same into dz (global) for the valid rows.
__device__ __forceinline__ void store_dz(const Acc& acc, const float* __restrict__ saved,
                                         float* out, float* __restrict__ dz, int ld, int row0,
                                         int rows) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = threadIdx.x + c * kThreads;
    if (col < ld) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = 0.f;
        if (r < rows) {
          const size_t o = (size_t)(row0 + r) * ld + col;
          v = acc[c][r] * act_grad_from_output(saved[o], kElu);
          dz[o] = v;
        }
        out[r * ld + col] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) glimpse_bwd_rows_kernel(GlimpseBwdArgs p) {
  extern __shared__ float smem[];
  const GlimpseDims& d = p.d;
  const int G = d.gh * d.gw, D = 2 * d.n_what;
  const bool masked = p.mi != nullptr;
  float* dhs = smem;                     // kRows x D
  float* dz2s = dhs + kRows * D;         // kRows x d2
  float* dz1s = dz2s + kRows * d.d2;     // kRows x d1
  float* dgs = dz1s + kRows * d.d1;      // kRows x G: d(masked glimpse), then dg0
  float* dmz2s = dgs + kRows * G;        // kRows x G (masked)
  float* dmz1s = dmz2s + (masked ? kRows * G : 0);  // kRows x d_m (masked)
  const CropDims cd = crop_dims(d);
  const CropSmem cs(dmz1s + kRows * d.d_m, cd);
  float* bw = cs.u + d.gh + d.gw;        // CropSmem::bwd_floats
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, d.n - row0);

  // the head: dhp = [dloc, dscale softplus'(z)], softplus' = 1 - exp(-(scale - 1e-2))
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, j = i - r * D;
    float v = 0.f;
    if (r < rows) {
      const size_t row = (size_t)(row0 + r);
      if (j < d.n_what) {
        v = p.dloc[row * d.n_what + j];
      } else {
        const size_t o = row * d.n_what + j - d.n_what;
        v = p.dscale[o] * (1.f - expf(-(p.scale[o] - kMinStd)));
      }
      p.dhp[row * D + j] = v;
    }
    dhs[i] = v;
  }
  __syncthreads();
  encode_rows_bwd<kRows>(dhs, D, p.wh, p.we2, p.we1, d.d1, d.d2, G,
                         p.h1 + (size_t)row0 * d.d1, d.d1, p.h2 + (size_t)row0 * d.d2, d.d2,
                         dz2s, dz1s, dgs, p.dz2 + (size_t)row0 * d.d2, d.d2,
                         p.dz1 + (size_t)row0 * d.d1, d.d1, rows);

  if (masked) {
    // dmask = dg g0, dg0 = dg mask, dmz2 = dmask mask (1 - mask); the masked
    // glimpse g0 mask goes to phase B
    for (int i = threadIdx.x; i < kRows * G; i += kThreads) {
      const int r = i / G, j = i - r * G;
      float v = 0.f;
      if (r < rows) {
        const size_t o = (size_t)(row0 + r) * G + j;
        const float m = p.mask[o], g = p.g0[o], dg = dgs[i];
        v = dg * g * m * (1.f - m);
        p.dmz2[o] = v;
        p.gflat[o] = g * m;
        dgs[i] = dg * m;
      }
      dmz2s[i] = v;
    }
    __syncthreads();
    Acc acc;
    zero(acc);
    acc_smem_t(acc, dmz2s, G, G, p.wm2, G, 0, d.d_m);  // dmhid = dmz2 Wm2^T
    store_dz(acc, p.mhid, dmz1s, p.dmz1, d.d_m, row0, rows);
    __syncthreads();
    zero(acc);
    acc_smem_t(acc, dmz1s, d.d_m, d.d_m, p.wm1, d.d_m, 0, d.d_mi);  // dmi = dmz1 Wm1^T
    store_rows(acc, p.dmi, d.d_mi, row0, rows, 0, d.d_mi);
  }

  // the crop backward and the where-gradient, one row at a time
  for (int r = 0; r < rows; ++r) {
    const int b = row0 + r;
    float c[4];
    crop_setup(p.img + (size_t)b * d.H * d.W, p.wl + (size_t)b * 4, cd, cs, c);
    crop_bwd(cd, cs, c, dgs + r * G, bw, p.dwl + (size_t)b * 4);
  }
}

size_t fwd_smem(const GlimpseDims& d) {
  return sizeof(float) * ((size_t)kRows * (d.gh * d.gw + d.d_m + d.d1 + d.d2 + kChunk) +
                          CropSmem::floats(crop_dims(d)));
}

size_t bwd_smem(const GlimpseDims& d, bool masked) {
  const size_t G = (size_t)d.gh * d.gw;
  return sizeof(float) * ((size_t)kRows * (2 * d.n_what + d.d2 + d.d1 + G +
                                           (masked ? G + d.d_m : 0)) +
                          CropSmem::floats(crop_dims(d)) + CropSmem::bwd_floats(crop_dims(d)));
}

bool read_dims(const int* dims, GlimpseDims& d) {
  d = GlimpseDims{dims[0], dims[1], dims[2], dims[3], dims[4],
                  dims[5], dims[6], dims[7], dims[8], dims[9]};
  const int G = d.gh * d.gw;
  return d.n > 0 && d.H > 1 && d.W > 1 && d.gh > 1 && d.gw > 1 && d.d1 > 0 && d.d2 > 0 &&
         d.n_what > 0 && G <= kMaxWidth && d.d1 <= kMaxWidth && d.d2 <= kMaxWidth &&
         2 * d.n_what <= kMaxWidth && d.d_mi >= 0 && d.d_mi <= kMaxWidth && d.d_m >= 0 &&
         d.d_m <= kMaxWidth;
}

}  // namespace sqair

// The forward.  ptrs holds, in order: img [n, H, W], wl [n, 4], mi [n, d_mi]
// (null: unmasked), Wm1 [d_mi, d_m], bm1, Wm2 [d_m, G], bm2 (null when
// unmasked), We1 [G, d1], be1, We2 [d1, d2], be2, Wh [d2, 2 n_what], bh, then
// the outputs loc and scale [n, n_what] and the saved g0 [n, gh, gw], h1
// [n, d1], h2 [n, d2], mask [n, G] and mhid [n, d_m] (each may be null).
// dims is {n, H, W, gh, gw, d_mi, d_m, d1, d2, n_what}.  All f32,
// contiguous and on the device; ptrs and dims are host arrays.  Launches on
// `stream`, does not synchronise, allocates nothing, and returns the CUDA
// error code of the launch (0 on success).
extern "C" int sqair_fused_glimpse(void* const* ptrs, const int* dims, void* stream) {
  using namespace sqair;
  GlimpseDims d;
  if (!read_dims(dims, d)) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  GlimpseFwdArgs p{};
  p.d = d;
  p.img = f[0]; p.wl = f[1]; p.mi = f[2];
  p.wm1 = f[3]; p.bm1 = f[4]; p.wm2 = f[5]; p.bm2 = f[6];
  p.we1 = f[7]; p.be1 = f[8]; p.we2 = f[9]; p.be2 = f[10]; p.wh = f[11]; p.bh = f[12];
  float* const* o = reinterpret_cast<float* const*>(ptrs + 13);
  p.loc = o[0]; p.scale = o[1];
  p.g0 = o[2]; p.h1 = o[3]; p.h2 = o[4]; p.mask = o[5]; p.mhid = o[6];
  if (p.mi == nullptr) {
    p.d.d_mi = p.d.d_m = 0;
  } else if (d.d_mi < 1 || d.d_m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fwd_smem(p.d);
  cudaError_t err = allow_smem(glimpse_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.n + kRows - 1) / kRows;
  glimpse_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The backward.  ptrs holds, in order: img, wl, mi (null: unmasked), Wm1,
// Wm2 (null when unmasked), We1, We2, Wh, the saved g0, h1, h2, scale, mask
// and mhid (the last two null when unmasked), dloc and dscale [n, n_what];
// then the outputs dwl [n, 4], dmi [n, d_mi], dWm1, dbm1, dWm2, dbm2 (null
// when unmasked), dWe1, dbe1, dWe2, dbe2, dWh, dbh; then scratch of
// n (2 n_what + d2 + d1) floats, plus n (2 G + d_m) when masked.  dims and
// the contract are the forward's.  Launches phase A and phase B.
extern "C" int sqair_fused_glimpse_bwd(void* const* ptrs, const int* dims, void* stream) {
  using namespace sqair;
  GlimpseDims d;
  if (!read_dims(dims, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  float* const* o = reinterpret_cast<float* const*>(ptrs + 16);
  GlimpseBwdArgs p{};
  p.img = f[0]; p.wl = f[1]; p.mi = f[2]; p.wm1 = f[3]; p.wm2 = f[4];
  p.we1 = f[5]; p.we2 = f[6]; p.wh = f[7];
  p.g0 = f[8]; p.h1 = f[9]; p.h2 = f[10]; p.scale = f[11]; p.mask = f[12]; p.mhid = f[13];
  p.dloc = f[14]; p.dscale = f[15];
  const bool masked = p.mi != nullptr;
  if (!masked) {
    d.d_mi = d.d_m = 0;
  } else if (d.d_mi < 1 || d.d_m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  p.d = d;
  p.dwl = o[0]; p.dmi = o[1];
  const int G = d.gh * d.gw, D = 2 * d.n_what;
  float* scratch = o[12];
  p.dhp = scratch;
  p.dz2 = p.dhp + (size_t)d.n * D;
  p.dz1 = p.dz2 + (size_t)d.n * d.d2;
  p.gflat = masked ? p.dz1 + (size_t)d.n * d.d1 : nullptr;
  p.dmz2 = masked ? p.gflat + (size_t)d.n * G : nullptr;
  p.dmz1 = masked ? p.dmz2 + (size_t)d.n * G : nullptr;

  const size_t smem = bwd_smem(d, masked);
  cudaError_t err = allow_smem(glimpse_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (d.n + kRows - 1) / kRows;
  glimpse_bwd_rows_kernel<<<blocks, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  OuterArgs q{};
  q.n = d.n;
  // {a, dz, dw, db, lda, ldz, K, J}
  q.job[0] = OuterJob{p.h2, p.dhp, o[10], o[11], d.d2, D, d.d2, D};
  q.job[1] = OuterJob{p.h1, p.dz2, o[8], o[9], d.d1, d.d2, d.d1, d.d2};
  q.job[2] = OuterJob{masked ? p.gflat : p.g0, p.dz1, o[6], o[7], G, d.d1, G, d.d1};
  q.n_jobs = 3;
  if (masked) {
    q.job[3] = OuterJob{p.mhid, p.dmz2, o[4], o[5], d.d_m, G, d.d_m, G};
    q.job[4] = OuterJob{p.mi, p.dmz1, o[2], o[3], d.d_mi, d.d_m, d.d_mi, d.d_m};
    q.n_jobs = 5;
  }
  return (int)launch_tiles(q, s);
}
