// Shared device code of the kernels that crop and encode glimpses
// (fused_glimpse.cu, fused_prop.cu, fused_disc.cu): the bilinear crop at a
// where in logit space and its where-gradient, one row at a time with the
// frame and the interpolation matrices in shared memory (crop_setup,
// crop_glimpse, crop_bwd: the propagation backward) or at the two non-zeros
// of each interpolation row (sparse_crop_*, with the same bits: the glimpse
// encoder's forward and backward, the propagation forward, the discovery
// forward and backward), and a tile's glimpses masked (or not) and encoded
// over a thread block cluster (glimpse_encode_fwd: the glimpse encoder's
// forward, the propagation forward and the discovery forward).
//
//   s = sigmoid(wl[:2]), t = tanh(wl[2:]); s_c = max(s, 1e-4)
//   u_i = (s_c t_i + t + 1)(src - 1) / 2, t_i = i 2/(dst - 1) - 1
//   wy[i, p] = max(0, 1 - |u_i - p|)  [gh, H], wx alike [gw, W]
//   g0 = wy (img wx^T)                [gh, gw]
//
// and backward, with the clip straight-through:
//   du_i = sum_p dwy[i, p] (wy[i, p] > 0 ? -sign(u_i - p) : 0),
//   d s_c = sum_i du_i t_i (src - 1)/2, d t = sum_i du_i (src - 1)/2,
// then the sigmoid / tanh derivatives.  No gradient goes into the frame.
//
// The interpolation coordinate u is computed with explicitly rounded
// operations (no FMA contraction), in the plain version's order: a u that
// rounds to the other side of an integer flips a whole term of dwl.
#pragma once

#include "bwd_common.cuh"
#include "cluster_dense.cuh"

namespace sqair {

constexpr float kMinScale = 1e-4f;  // stn.SCALE_EPS
constexpr float kMinStd = 1e-2f;

struct CropDims {
  int H, W, gh, gw;
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

// softplus as the JAX package writes it: max(x, 0) + log(1 + exp(-|x|))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + logf(1.f + expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

// Shared memory of one row's crop (forward and backward).
struct CropSmem {
  float* img;  // [H, W]
  float* wy;   // [gh, H]
  float* wx;   // [gw, W]
  float* A;    // [H, gw] = img wx^T
  float* u;    // [gh + gw]: uy then ux
  __host__ __device__ static size_t floats(const CropDims& d) {
    return (size_t)d.H * d.W + d.gh * d.H + d.gw * d.W + d.H * d.gw + d.gh + d.gw;
  }
  // the backward's dA [H, gw], dwy [gh, H], dwx [gw, W] and du [gh + gw]
  __host__ __device__ static size_t bwd_floats(const CropDims& d) {
    return (size_t)d.H * d.gw + d.gh * d.H + d.gw * d.W + d.gh + d.gw;
  }
  __device__ CropSmem(float* s, const CropDims& d) {
    img = s;
    wy = img + d.H * d.W;
    wx = wy + d.gh * d.H;
    A = wx + d.gw * d.W;
    u = A + d.H * d.gw;
  }
};

// Loads one row's frame, builds its interpolation matrices at the where
// logits wl[0..3] (any memory) and A = img wx^T into `cs`; c receives
// (sx, sy, tx, ty).  Every thread calls it; it synchronises before it
// returns.
__device__ __forceinline__ void crop_setup(const float* __restrict__ frame, const float* wl,
                                           const CropDims& d, const CropSmem& cs, float c[4]) {
  const int hw = d.H * d.W;
  for (int i = threadIdx.x; i < hw; i += kThreads) cs.img[i] = frame[i];
  where_coords(wl, c);
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

// The glimpse g0 = wy A [gh gw] of the row set up in `cs`, into `out`
// (shared memory) and, unless null, `out_global`.  Synchronises.
__device__ __forceinline__ void crop_glimpse(const CropDims& d, const CropSmem& cs, float* out,
                                             float* __restrict__ out_global) {
  const int G = d.gh * d.gw;
  for (int i = threadIdx.x; i < G; i += kThreads) {
    const int gi = i / d.gw, j = i - gi * d.gw;
    const float* w = cs.wy + gi * d.H;
    float s = 0.f;
    for (int h = 0; h < d.H; ++h) s = fmaf(w[h], cs.A[h * d.gw + j], s);
    out[i] = s;
    if (out_global != nullptr) out_global[i] = s;
  }
  __syncthreads();
}

// The where logits' gradient of the row set up in `cs` (with c from
// crop_setup) for the glimpse gradient dg0 [gh gw] (shared memory); thread
// 0 writes dwl[0..3] (any memory).  `bw` holds CropSmem::bwd_floats.
// Synchronises.
__device__ __forceinline__ void crop_bwd(const CropDims& d, const CropSmem& cs, const float c[4],
                                         const float* dg0, float* bw, float* dwl) {
  float* dA = bw;                 // [H, gw]
  float* dwy = dA + d.H * d.gw;   // [gh, H]
  float* dwx = dwy + d.gh * d.H;  // [gw, W]
  float* du = dwx + d.gw * d.W;   // [gh + gw]
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
    dwl[0] = dsxc * c[0] * (1.f - c[0]);
    dwl[1] = dsyc * c[1] * (1.f - c[1]);
    dwl[2] = dtx * (1.f - c[2] * c[2]);
    dwl[3] = dty * (1.f - c[3] * c[3]);
  }
  __syncthreads();
}

// Scales each of the block's rows' where-gradients through a crop, dwl
// [NR, 4] in shared memory, by keep[slot + r] where keep is not null (a
// factor per row-slot, [S, B]: 0 cuts a kink of the step's gradient out
// when two runs are compared).  Synchronises unless keep is null.
template <int NR>
__device__ __forceinline__ void keep_crop_grad(float* dwl, const float* __restrict__ keep,
                                               size_t slot, int rows) {
  if (keep == nullptr) return;
  for (int i = threadIdx.x; i < NR * 4; i += kThreads) {
    const int r = i / 4;
    if (r < rows) dwl[i] *= keep[slot + r];
  }
  __syncthreads();
}

// ------------------------------------------- the crop at two pixels a row
// A row of wy (or wx) has at most two non-zeros, at p = floor(u_i) and
// floor(u_i) + 1 (max(0, 1 - |u_i - p|) is 0 at every other p, and exactly
// 0 there in f32 too, since |u_i - p| >= 1 rounds to >= 1), and u_i rises
// with i because the scale is clipped at >= 1e-4.  So the crop and its
// backward need only those two pixels of each row: A[h, j] and g0[i, j]
// take 2 terms, dA[h, :] the contiguous range of i whose two pixels hold h,
// and dwy, dwx are needed only at the two pixels, where du reads them.
// Dropping products whose weight is exactly 0 from an fmaf chain that starts
// at +0 leaves every bit of the sum as it was (a +0 or -0 product added to a
// sum that is never -0), given a finite frame and glimpse gradient: these
// give the dense crop_setup / crop_glimpse / crop_bwd's bits.
//
// A group of nt threads (t its thread) crops one row; a block runs its
// groups side by side, every thread calling each step (they synchronise
// the block).  The frame is read from device memory.
constexpr int kMaxCropGroups = 4;  // rows a block crops side by side

struct SparseCrop {
  float* u;   // [gh + gw]: uy then ux
  float* w0;  // [gh + gw]: the weight at p0
  float* w1;  // [gh + gw]: at p0 + 1
  int* p0;    // [gh + gw]: floor(u)
  float* A;   // [H, gw] = img wx^T
  // the backward
  float* dA;  // [H, gw] = wy^T dg0
  float* dw;  // [gh + gw][2]: dwy, then dwx, at p0 and p0 + 1
  float* du;  // [gh + gw]
  int* lo;    // [H]: the rows of wy that hold h: [lo[h], hi[h])
  int* hi;
  __host__ __device__ static int floats(const CropDims& d, bool bwd) {
    const int n = d.gh + d.gw, a = d.H * d.gw;
    return 4 * n + a + (bwd ? a + 3 * n + 2 * d.H : 0);
  }
  __device__ SparseCrop(float* s, const CropDims& d, bool bwd) {
    const int n = d.gh + d.gw;
    u = s;
    w0 = u + n;
    w1 = w0 + n;
    p0 = reinterpret_cast<int*>(w1 + n);
    A = reinterpret_cast<float*>(p0 + n);
    dA = A + d.H * d.gw;
    dw = bwd ? dA + d.H * d.gw : nullptr;
    du = bwd ? dw + 2 * n : nullptr;
    lo = bwd ? reinterpret_cast<int*>(du + n) : nullptr;
    hi = bwd ? lo + d.H : nullptr;
  }
};

// The row's coordinates c = (sx, sy, tx, ty) (every thread), u, floor(u)
// and the two weights of each row of wy and wx, then A; `frame` is the
// row's [H, W] in device memory, `wl` its where logits (any memory).
// Inactive groups (no row) only synchronise.
__device__ __forceinline__ void sparse_crop_setup(const float* __restrict__ frame, const float* wl,
                                                  const CropDims& d, const SparseCrop& s,
                                                  float c[4], bool active, int t, int nt) {
  const int n = d.gh + d.gw;
  if (active) {
    where_coords(wl, c);
    const float sxc = fmaxf(c[0], kMinScale), syc = fmaxf(c[1], kMinScale);
    for (int i = t; i < n; i += nt) {
      const float u = i < d.gh ? grid_u(syc, c[3], i, d.gh, d.H)
                               : grid_u(sxc, c[2], i - d.gh, d.gw, d.W);
      const int p = (int)floorf(u);
      s.u[i] = u;
      s.p0[i] = p;
      s.w0[i] = fmaxf(0.f, 1.f - fabsf(u - (float)p));
      s.w1[i] = fmaxf(0.f, 1.f - fabsf(u - (float)(p + 1)));
    }
  }
  __syncthreads();
  if (active) {
    for (int i = t; i < d.H * d.gw; i += nt) {
      const int h = i / d.gw, j = i - h * d.gw, p = s.p0[d.gh + j];
      const float* a = frame + (size_t)h * d.W;
      float v = 0.f;
      if (p >= 0 && p < d.W) v = fmaf(__ldg(a + p), s.w0[d.gh + j], v);
      if (p + 1 >= 0 && p + 1 < d.W) v = fmaf(__ldg(a + p + 1), s.w1[d.gh + j], v);
      s.A[i] = v;
    }
  }
  __syncthreads();
}

// out(i, g0[i]) for the gh gw values of the glimpse g0 = wy A of the row
// set up in `s` (no synchronisation).
template <typename Out>
__device__ __forceinline__ void sparse_crop_glimpse(const CropDims& d, const SparseCrop& s,
                                                    bool active, int t, int nt, Out out) {
  if (!active) return;
  for (int i = t; i < d.gh * d.gw; i += nt) {
    const int gi = i / d.gw, j = i - gi * d.gw, p = s.p0[gi];
    float v = 0.f;
    if (p >= 0 && p < d.H) v = fmaf(s.w0[gi], s.A[p * d.gw + j], v);
    if (p + 1 >= 0 && p + 1 < d.H) v = fmaf(s.w1[gi], s.A[(p + 1) * d.gw + j], v);
    out(i, v);
  }
}

// The where logits' gradient of the row set up in `s` (with c from
// sparse_crop_setup, `s` laid out with the backward) for the glimpse
// gradient dg0 [gh gw] (shared memory): the group's thread 0 writes
// dwl[0..3] (any memory) after the last synchronisation.
__device__ __forceinline__ void sparse_crop_bwd(const float* __restrict__ frame,
                                                const CropDims& d, const SparseCrop& s,
                                                const float c[4], const float* dg0, float* dwl,
                                                bool active, int t, int nt) {
  const int n = d.gh + d.gw;
  if (active) {
    // dwy at the two pixels of each row of wy: dg0 A^T
    for (int i = t; i < 2 * d.gh; i += nt) {
      const int gi = i >> 1, h = s.p0[gi] + (i & 1);
      float v = 0.f;
      if (h >= 0 && h < d.H) {
        for (int j = 0; j < d.gw; ++j) v = fmaf(dg0[gi * d.gw + j], s.A[h * d.gw + j], v);
      }
      s.dw[i] = v;
    }
    // the rows of wy that hold pixel h
    for (int h = t; h < d.H; h += nt) {
      int lo = d.gh, hi = 0;
      for (int gi = 0; gi < d.gh; ++gi) {
        const int p = s.p0[gi];
        if (p == h || p + 1 == h) {
          lo = min(lo, gi);
          hi = gi + 1;
        }
      }
      s.lo[h] = lo;
      s.hi[h] = hi;
    }
  }
  __syncthreads();
  if (active) {
    // dA = wy^T dg0 [H, gw]
    for (int i = t; i < d.H * d.gw; i += nt) {
      const int h = i / d.gw, j = i - h * d.gw;
      float v = 0.f;
      for (int gi = s.lo[h]; gi < s.hi[h]; ++gi) {
        const int p = s.p0[gi];
        if (p == h) v = fmaf(s.w0[gi], dg0[gi * d.gw + j], v);
        else if (p + 1 == h) v = fmaf(s.w1[gi], dg0[gi * d.gw + j], v);
      }
      s.dA[i] = v;
    }
  }
  __syncthreads();
  if (active) {
    // dwx = dA^T img at the two pixels of each row of wx
    for (int i = t; i < 2 * d.gw; i += nt) {
      const int j = i >> 1, w = s.p0[d.gh + j] + (i & 1);
      float v = 0.f;
      if (w >= 0 && w < d.W) {
        for (int h = 0; h < d.H; ++h)
          v = fmaf(s.dA[h * d.gw + j], __ldg(frame + (size_t)h * d.W + w), v);
      }
      s.dw[2 * d.gh + i] = v;
    }
  }
  __syncthreads();
  if (active) {
    // du_i = sum_p dw[i, p] (w[i, p] > 0 ? -sign(u_i - p) : 0), at the two pixels
    for (int i = t; i < n; i += nt) {
      const int src = i < d.gh ? d.H : d.W;
      const float ui = s.u[i];
      float sum = 0.f;
      for (int e = 0; e < 2; ++e) {
        const int q = s.p0[i] + e;
        if (q < 0 || q >= src) continue;
        const float diff = ui - (float)q;
        const float sgn = diff > 0.f ? -1.f : (diff < 0.f ? 1.f : 0.f);
        sum += s.dw[2 * i + e] * ((e ? s.w1[i] : s.w0[i]) > 0.f ? sgn : 0.f);
      }
      s.du[i] = sum;
    }
  }
  __syncthreads();
  if (active && t == 0) {
    const float* du = s.du;
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
    dwl[0] = dsxc * c[0] * (1.f - c[0]);
    dwl[1] = dsyc * c[1] * (1.f - c[1]);
    dwl[2] = dtx * (1.f - c[2] * c[2]);
    dwl[3] = dty * (1.f - c[3] * c[3]);
  }
}

// ------------------------------------------ a tile's glimpses over a cluster
// The glimpse of each of a tile's kTileRows rows over a thread block
// cluster, masked and encoded (the glimpse encoder's forward, fused_glimpse.cu,
// each glimpse of the propagation forward, fused_prop.cu, and, unmasked,
// each slot's glimpse of the discovery forward, fused_disc.cu).  Row r <
// rows is cropped at its where logits wl + r * ldwl (any memory) by block
// r mod C, a block's rows side by side in groups of threads at the two
// non-zeros of each interpolation row, with the crop's scratch in `ring`
// (`room` floats); each value is put into every block's gbuf [8][ldg] and
// handed to save(r, i, v) in the cropping block; rows past `rows` are zero.
// Once every row is in every block, gbuf is multiplied by mask [8][ldg]
// (unless null) and the encoder's two layers and the head's pre-activation
// follow, each a cluster_dense: epi1(r, j, z), epi2(r, j, z) and epih(r, j,
// z) receive the pre-bias sums of e1 = gbuf We1, e2 = e1 We2 (which the
// first two write into every block's e1 [8][ld1] and e2 [8][ld2]) and e2
// Wh.  Every thread of every block calls it.
template <typename Save, typename Epi1, typename Epi2, typename EpiH>
__device__ __forceinline__ void glimpse_encode_fwd(
    const float* __restrict__ img, const CropDims& cd, const float* wl, int ldwl, const Peers& pe,
    int row0, int rows, float* gbuf, int ldg, const float* mask, const float* __restrict__ we1,
    float* e1, int d1, int ld1, const float* __restrict__ we2, float* e2, int d2, int ld2,
    const float* __restrict__ wh, int D, float* ring, int room, float* parts, Save save,
    Epi1 epi1, Epi2 epi2, EpiH epih) {
  const int G = cd.gh * cd.gw, C = pe.n, rank = pe.rank;
  const int fl = round4(SparseCrop::floats(cd, false));
  const int nr = rank < rows ? (rows - rank + C - 1) / C : 0;
  int ng = 1;
  while (ng < nr && ng < kMaxCropGroups && 2 * ng * fl <= room) ng *= 2;
  const int nt = kThreads / ng, g = threadIdx.x / nt, t = threadIdx.x - g * nt;
  const SparseCrop sc(ring + g * fl, cd, false);
  for (int m0 = 0; m0 < nr; m0 += ng) {
    const int m = m0 + g;
    const bool active = m < nr;
    const int r = active ? rank + m * C : 0;
    float c[4];
    sparse_crop_setup(img + (size_t)(row0 + r) * cd.H * cd.W, wl + r * ldwl, cd, sc, c, active,
                      t, nt);
    sparse_crop_glimpse(cd, sc, active, t, nt, [&](int i, float v) {
      pe.put(gbuf + r * ldg + i, v);
      save(r, i, v);
    });
    __syncthreads();  // the next rows reuse the scratch
  }
  for (int i = threadIdx.x; i < (kTileRows - rows) * G; i += kThreads) {
    const int r = rows + i / G, j = i - (r - rows) * G;
    gbuf[r * ldg + j] = 0.f;
  }
  cluster_sync_all();  // every row's glimpse is in every block
  if (mask != nullptr) {
    for (int i = threadIdx.x; i < kTileRows * G; i += kThreads) {
      const int r = i / G, j = i - r * G;
      gbuf[r * ldg + j] *= mask[r * ldg + j];
    }
    __syncthreads();
  }
  // the encoder: two elu layers, then the head's pre-activation
  {
    const TTerm t1[1] = {{gbuf, ldg, G, we1}};
    cluster_dense<1>(t1, d1, pe, ring, parts, [&](int r, int j, float z, float) { epi1(r, j, z); });
  }
  {
    const TTerm t2[1] = {{e1, ld1, d1, we2}};
    cluster_dense<1>(t2, d2, pe, ring, parts, [&](int r, int j, float z, float) { epi2(r, j, z); });
  }
  const TTerm th[1] = {{e2, ld2, d2, wh}};
  cluster_dense<1>(th, D, pe, ring, parts, [&](int r, int j, float z, float) { epih(r, j, z); });
}

}  // namespace sqair
