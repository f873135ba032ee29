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
// scratch; phase B (outer_reduce_kernel) reduces dWh, dWe2, dWe1, dWm2 and
// dWm1 with their biases over all rows in fixed order.  No atomics.
//
// The interpolation coordinate u is computed with explicitly rounded
// operations (no FMA contraction), in the plain version's order: a u that
// rounds to the other side of an integer flips a whole term of dwl.

#include "bwd_common.cuh"

namespace sqair {

constexpr float kMinScale = 1e-4f;  // stn.SCALE_EPS
constexpr float kMinStd = 1e-2f;

struct GlimpseDims {
  int n, H, W, gh, gw;
  int d_mi, d_m;  // mask input and mask hidden widths (0 when unmasked)
  int d1, d2;     // encoder widths
  int n_what;
};

// sigmoid and tanh of the where logits, as torch.sigmoid / torch.tanh
// compute them: c = (sx, sy, tx, ty)
__device__ __forceinline__ void where_coords(const float* wl, float c[4]) {
  c[0] = 1.f / (1.f + expf(-wl[0]));
  c[1] = 1.f / (1.f + expf(-wl[1]));
  c[2] = tanhf(wl[2]);
  c[3] = tanhf(wl[3]);
}

// t_i = i * (2 / (dst - 1)) - 1, rounded after each operation
__device__ __forceinline__ float grid_t(int i, int dst) {
  return __fsub_rn(__fmul_rn((float)i, (float)(2.0 / (dst - 1))), 1.f);
}

// u_i = (scale t_i + shift + 1) (src - 1) / 2, rounded after each operation
__device__ __forceinline__ float grid_u(float scale, float shift, int i, int dst, int src) {
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(scale, grid_t(i, dst)), shift), 1.f);
  return __fmul_rn(v, (float)(src - 1)) / 2.f;
}

// Shared memory of one row's crop (forward and backward).
struct CropSmem {
  float* img;  // [H, W]
  float* wy;   // [gh, H]
  float* wx;   // [gw, W]
  float* A;    // [H, gw] = img wx^T
  float* u;    // [gh + gw]: uy then ux
  static size_t floats(const GlimpseDims& d) {
    return (size_t)d.H * d.W + d.gh * d.H + d.gw * d.W + d.H * d.gw + d.gh + d.gw;
  }
  __device__ CropSmem(float* s, const GlimpseDims& d) {
    img = s;
    wy = img + d.H * d.W;
    wx = wy + d.gh * d.H;
    A = wx + d.gw * d.W;
    u = A + d.H * d.gw;
  }
};

// Loads row b's frame, builds its interpolation matrices and A = img wx^T
// into `cs`; c receives (sx, sy, tx, ty).  Every thread calls it; it
// synchronises before it returns.
__device__ void crop_setup(const float* __restrict__ img, const float* __restrict__ wl, int b,
                           const GlimpseDims& d, const CropSmem& cs, float c[4]) {
  const int hw = d.H * d.W;
  for (int i = threadIdx.x; i < hw; i += kThreads) cs.img[i] = img[(size_t)b * hw + i];
  where_coords(wl + (size_t)b * 4, c);
  const float sxc = fmaxf(c[0], kMinScale), syc = fmaxf(c[1], kMinScale);
  for (int i = threadIdx.x; i < d.gh + d.gw; i += kThreads)
    cs.u[i] = i < d.gh ? grid_u(syc, c[3], i, d.gh, d.H) : grid_u(sxc, c[2], i - d.gh, d.gw, d.W);
  __syncthreads();
  for (int i = threadIdx.x; i < d.gh * d.H; i += kThreads) {
    const int r = i / d.H, p = i - r * d.H;
    cs.wy[i] = fmaxf(0.f, 1.f - fabsf(cs.u[r] - (float)p));
  }
  for (int i = threadIdx.x; i < d.gw * d.W; i += kThreads) {
    const int r = i / d.W, p = i - r * d.W;
    cs.wx[i] = fmaxf(0.f, 1.f - fabsf(cs.u[d.gh + r] - (float)p));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d.H * d.gw; i += kThreads) {
    const int h = i / d.gw, j = i - h * d.gw;
    const float* a = cs.img + h * d.W;
    const float* w = cs.wx + j * d.W;
    float s = 0.f;
    for (int p = 0; p < d.W; ++p) s = fmaf(a[p], w[p], s);
    cs.A[i] = s;
  }
  __syncthreads();
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
  const CropSmem cs(stage + kRows * kChunk, d);
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
    crop_setup(p.img, p.wl, b, d, cs, c);
    for (int i = threadIdx.x; i < G; i += kThreads) {
      const int gi = i / d.gw, j = i - gi * d.gw;
      const float* w = cs.wy + gi * d.H;
      float s = 0.f;
      for (int h = 0; h < d.H; ++h) s = fmaf(w[h], cs.A[h * d.gw + j], s);
      gs[r * G + i] = s;
      if (p.g0 != nullptr) p.g0[(size_t)b * G + i] = s;
    }
    __syncthreads();  // before the next row overwrites the crop buffers
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
  const float* ins[2] = {gs, h1s};
  float* outs[2] = {h1s, h2s};
  float* saved[2] = {p.h1, p.h2};
  const float* ws[2] = {p.we1, p.we2};
  const float* bs[2] = {p.be1, p.be2};
  const int Ks[2] = {G, d.d1}, Ds[2] = {d.d1, d.d2};
  for (int l = 0; l < 2; ++l) {
    zero(acc);
    acc_smem(acc, ins[l], Ks[l], Ks[l], ws[l], Ds[l], Ds[l]);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int j = threadIdx.x + c * kThreads;
      if (j < Ds[l]) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float v = apply_act(acc[c][r] + bs[l][j], kElu);
          outs[l][r * Ds[l] + j] = v;
          if (r < rows && saved[l] != nullptr) saved[l][(size_t)(row0 + r) * Ds[l] + j] = v;
        }
      }
    }
    __syncthreads();
  }

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
          const float sp = fmaxf(z, 0.f) + logf(1.f + expf(-fabsf(z)));
          p.scale[row * d.n_what + j - d.n_what] = sp + kMinStd;
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
  const CropSmem cs(dmz1s + kRows * d.d_m, d);
  float* dA = cs.u + d.gh + d.gw;        // [H, gw]
  float* dwy = dA + d.H * d.gw;          // [gh, H]
  float* dwx = dwy + d.gh * d.H;         // [gw, W]
  float* du = dwx + d.gw * d.W;          // [gh + gw]
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
  Acc acc;
  zero(acc);
  acc_smem_t(acc, dhs, D, D, p.wh, D, 0, d.d2);  // dh2 = dhp Wh^T
  store_dz(acc, p.h2, dz2s, p.dz2, d.d2, row0, rows);
  __syncthreads();
  zero(acc);
  acc_smem_t(acc, dz2s, d.d2, d.d2, p.we2, d.d2, 0, d.d1);  // dh1 = dz2 We2^T
  store_dz(acc, p.h1, dz1s, p.dz1, d.d1, row0, rows);
  __syncthreads();
  zero(acc);
  acc_smem_t(acc, dz1s, d.d1, d.d1, p.we1, d.d1, 0, G);  // d(masked glimpse) = dz1 We1^T
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int col = threadIdx.x + c * kThreads;
    if (col < G) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) dgs[r * G + col] = acc[c][r];
    }
  }
  __syncthreads();

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
    const float* dg0 = dgs + r * G;
    float c[4];
    crop_setup(p.img, p.wl, b, d, cs, c);
    // dwy = dg0 A^T [gh, H]; dA = wy^T dg0 [H, gw]
    for (int i = threadIdx.x; i < d.gh * d.H; i += kThreads) {
      const int gi = i / d.H, h = i - gi * d.H;
      float s = 0.f;
      for (int j = 0; j < d.gw; ++j) s = fmaf(dg0[gi * d.gw + j], cs.A[h * d.gw + j], s);
      dwy[i] = s;
    }
    for (int i = threadIdx.x; i < d.H * d.gw; i += kThreads) {
      const int h = i / d.gw, j = i - h * d.gw;
      float s = 0.f;
      for (int gi = 0; gi < d.gh; ++gi) s = fmaf(cs.wy[gi * d.H + h], dg0[gi * d.gw + j], s);
      dA[i] = s;
    }
    __syncthreads();
    // dwx = dA^T img [gw, W]
    for (int i = threadIdx.x; i < d.gw * d.W; i += kThreads) {
      const int j = i / d.W, w = i - j * d.W;
      float s = 0.f;
      for (int h = 0; h < d.H; ++h) s = fmaf(dA[h * d.gw + j], cs.img[h * d.W + w], s);
      dwx[i] = s;
    }
    __syncthreads();
    // du_i = sum_p dw[i, p] (w[i, p] > 0 ? -sign(u_i - p) : 0)
    for (int i = threadIdx.x; i < d.gh + d.gw; i += kThreads) {
      const bool y = i < d.gh;
      const int src = y ? d.H : d.W;
      const float* dw = y ? dwy + i * d.H : dwx + (i - d.gh) * d.W;
      const float* w = y ? cs.wy + i * d.H : cs.wx + (i - d.gh) * d.W;
      const float ui = cs.u[i];
      float s = 0.f;
      for (int q = 0; q < src; ++q) {
        const float diff = ui - (float)q;
        const float sgn = diff > 0.f ? -1.f : (diff < 0.f ? 1.f : 0.f);
        s += dw[q] * (w[q] > 0.f ? sgn : 0.f);
      }
      du[i] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float st_y = 0.f, s_y = 0.f, st_x = 0.f, s_x = 0.f;
      for (int i = 0; i < d.gh; ++i) {
        st_y += du[i] * grid_t(i, d.gh);
        s_y += du[i];
      }
      for (int j = 0; j < d.gw; ++j) {
        st_x += du[d.gh + j] * grid_t(j, d.gw);
        s_x += du[d.gh + j];
      }
      const float dsyc = st_y * (float)(d.H - 1) / 2.f, dty = s_y * (float)(d.H - 1) / 2.f;
      const float dsxc = st_x * (float)(d.W - 1) / 2.f, dtx = s_x * (float)(d.W - 1) / 2.f;
      float* o = p.dwl + (size_t)b * 4;
      o[0] = dsxc * c[0] * (1.f - c[0]);
      o[1] = dsyc * c[1] * (1.f - c[1]);
      o[2] = dtx * (1.f - c[2] * c[2]);
      o[3] = dty * (1.f - c[3] * c[3]);
    }
    __syncthreads();  // before the next row overwrites the crop buffers
  }
}

size_t fwd_smem(const GlimpseDims& d) {
  return sizeof(float) * ((size_t)kRows * (d.gh * d.gw + d.d_m + d.d1 + d.d2 + kChunk) +
                          CropSmem::floats(d));
}

size_t bwd_smem(const GlimpseDims& d, bool masked) {
  const size_t G = (size_t)d.gh * d.gw;
  return sizeof(float) * ((size_t)kRows * (2 * d.n_what + d.d2 + d.d1 + G +
                                           (masked ? G + d.d_m : 0)) +
                          CropSmem::floats(d) + (size_t)d.H * d.gw + d.gh * d.H + d.gw * d.W +
                          d.gh + d.gw);  // + dA, dwy, dwx, du
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
  q.job[0] = OuterJob{p.h2, p.dhp, o[10], o[11], d.d2, d.d2, D};
  q.job[1] = OuterJob{p.h1, p.dz2, o[8], o[9], d.d1, d.d1, d.d2};
  q.job[2] = OuterJob{masked ? p.gflat : p.g0, p.dz1, o[6], o[7], G, G, d.d1};
  q.n_jobs = 3;
  if (masked) {
    q.job[3] = OuterJob{p.mhid, p.dmz2, o[4], o[5], d.d_m, d.d_m, G};
    q.job[4] = OuterJob{p.mi, p.dmz1, o[2], o[3], d.d_mi, d.d_mi, d.d_m};
    q.n_jobs = 5;
  }
  return (int)launch_outer(q, s);
}
