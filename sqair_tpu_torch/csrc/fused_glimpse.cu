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
// frames (0.8 us at 3.35 TB/s); the backward about twice that.
//
// The forward was redesigned for Hopper with the bits of its first design,
// in which one block owned 8 rows (20 blocks at 160 rows), cropped them
// one at a time with the dense interpolation matrices and streamed every
// weight through L2 per block, each thread walking K for its columns: on
// an H100, 57.5% of its 0.137 ms went to the
// products and 38.2% to the crops (clock64 a block).  It now runs clusters
// of 4 blocks over tiles of 8 rows (glimpse_fwd_kernel, its own note
// below), every product a cluster_dense, and crops at the two non-zeros of
// each interpolation row, the rows spread over the blocks.  The crop
// products are plain f32 FMAs (the JAX package runs them at
// Precision.HIGHEST; no TF32 here either).
//
// The backward is two launches, as fused_bwd.cu, and was redesigned for
// Hopper.  Phase A (glimpse_bwd_kernel, its own note below) chains the row
// gradients from the head down to the mask input and the where logits and
// writes each layer's dz to scratch; phase B (tile_reduce_kernel) reduces
// dWh, dWe2, dWe1, dWm2 and dWm1 with their biases over all rows in fixed
// order.  No atomics: two runs give the same bits, and they are the bits
// of the first design (one block of 8 rows, each thread walking its own
// row of W, the crops dense).  That design spent 0.288 of 0.299 ms in
// phase A at 160 rows, 59% of it in the five transposed products (a warp
// load touching 32 cache lines) and 38% in the crops (140k multiply-adds a
// row, one row at a time); phase A now runs clusters of 4 blocks over
// tiles of 8 rows, every product a cluster_dense_t (cluster_dense.cuh),
// and crops at the two non-zeros of each interpolation row, two rows of a
// block side by side.
//
// The crops and the glimpse encoder over a cluster are device code shared
// with fused_prop.cu and fused_disc.cu (glimpse_common.cuh).

#include "cluster_dense.cuh"
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

// A thread block cluster of C blocks (ops/fused_glimpse.py
// glimpse_fwd_geometry: C = 4 at 160 rows, 80 blocks, one an SM) shares a
// tile of kTileRows = 8 rows.  Every block holds the tile's state in its
// shared memory (fwd_smem); each product (the mask MLP's two, the
// encoder's two and the head) is a cluster_dense, whose owners write the
// global outputs once and what every block reads next into every block
// (`Peers::put`).  The mask input's rows are staged into every block first,
// so that Wm1 is a product like the others.  The crops go row r to block r
// mod C at the two non-zeros of each interpolation row, each glimpse row
// put into every block before the mask multiply (glimpse_encode_fwd,
// shared with the propagation forward).
struct FwdSmem {
  int ldi, ldm, ldg, ld1, ld2;  // row strides (multiples of 4)
  int mask, gbuf, mis, mh, e1, e2, ring, parts, total;
};

__host__ __device__ inline FwdSmem fwd_smem(const GlimpseDims& d, bool masked) {
  FwdSmem L;
  const int n = kTileRows, G = d.gh * d.gw;
  L.ldi = round4(d.d_mi);
  L.ldm = round4(d.d_m);
  L.ldg = round4(G);
  L.ld1 = round4(d.d1);
  L.ld2 = round4(d.d2);
  int o = 0;
  L.mask = take(o, masked ? n * L.ldg : 0);
  L.gbuf = take(o, n * L.ldg);
  // the mask MLP's rows, then (once the mask is made) the encoder's
  const int u0 = o;
  L.mis = take(o, masked ? n * L.ldi : 0);
  L.mh = take(o, masked ? n * L.ldm : 0);
  int end = o;
  o = u0;
  L.e1 = take(o, n * L.ld1);
  L.e2 = take(o, n * L.ld2);
  o = o > end ? o : end;
  // the products' ring, which the crops borrow (one group's scratch at least)
  const int crop = round4(SparseCrop::floats(CropDims{d.H, d.W, d.gh, d.gw}, false));
  L.ring = take(o, crop > kRingT ? crop : kRingT);
  L.parts = take(o, kParts);
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) glimpse_fwd_kernel(GlimpseFwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const GlimpseDims& d = p.d;
  const int G = d.gh * d.gw, D = 2 * d.n_what;
  const bool masked = p.mi != nullptr;
  const FwdSmem L = fwd_smem(d, masked);
  float *mask = masked ? smem + L.mask : nullptr, *gbuf = smem + L.gbuf, *mis = smem + L.mis;
  float *mh = smem + L.mh, *e1 = smem + L.e1, *e2 = smem + L.e2;
  float *ring = smem + L.ring, *parts = smem + L.parts;
  const Peers pe;
  const int row0 = (blockIdx.x / pe.n) * kTileRows;
  const int rows = min(kTileRows, d.n - row0);

  if (masked) {
    // mhid = elu(mi Wm1 + bm1), mask = sigmoid(mhid Wm2 + bm2)
    for (int i = threadIdx.x; i < kTileRows * d.d_mi; i += kThreads) {
      const int r = i / d.d_mi, k = i - r * d.d_mi;
      mis[r * L.ldi + k] = r < rows ? __ldg(&p.mi[(size_t)(row0 + r) * d.d_mi + k]) : 0.f;
    }
    __syncthreads();
    {
      const TTerm t[1] = {{mis, L.ldi, d.d_mi, p.wm1}};
      cluster_dense<1>(t, d.d_m, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = apply_act(z + p.bm1[j], kElu);
        if (r < rows && p.mhid != nullptr) p.mhid[(size_t)(row0 + r) * d.d_m + j] = v;
        pe.put(mh + r * L.ldm + j, v);
      });
    }
    const TTerm t[1] = {{mh, L.ldm, d.d_m, p.wm2}};
    cluster_dense<1>(t, G, pe, ring, parts, [&](int r, int j, float z, float) {
      const float m = apply_act(z + p.bm2[j], kSigmoid);
      if (r < rows && p.mask != nullptr) p.mask[(size_t)(row0 + r) * G + j] = m;
      pe.put(mask + r * L.ldg + j, m);
    });
  } else {
    cluster_sync_all();  // every block runs before a peer's crop writes into it
  }

  // the crops, the mask multiply, the encoder and the Gaussian head: loc,
  // softplus(z) + 1e-2 with the JAX package's softplus
  glimpse_encode_fwd(
      p.img, crop_dims(d), p.wl + (size_t)row0 * 4, 4, pe, row0, rows, gbuf, L.ldg, mask, p.we1,
      e1, d.d1, L.ld1, p.we2, e2, d.d2, L.ld2, p.wh, D, ring, L.parts - L.ring, parts,
      [&](int r, int i, float v) {
        if (p.g0 != nullptr) p.g0[(size_t)(row0 + r) * G + i] = v;
      },
      [&](int r, int j, float z) {
        const float v = apply_act(z + p.be1[j], kElu);
        if (r < rows && p.h1 != nullptr) p.h1[(size_t)(row0 + r) * d.d1 + j] = v;
        pe.put(e1 + r * L.ld1 + j, v);
      },
      [&](int r, int j, float z) {
        const float v = apply_act(z + p.be2[j], kElu);
        if (r < rows && p.h2 != nullptr) p.h2[(size_t)(row0 + r) * d.d2 + j] = v;
        pe.put(e2 + r * L.ld2 + j, v);
      },
      [&](int r, int j, float z) {
        if (r >= rows) return;
        const float v = z + p.bh[j];
        const size_t row = (size_t)(row0 + r);
        if (j < d.n_what) {
          p.loc[row * d.n_what + j] = v;
        } else {
          p.scale[row * d.n_what + j - d.n_what] = softplus(v) + kMinStd;
        }
      });
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

// A thread block cluster of C blocks (ops/fused_glimpse.py
// glimpse_bwd_geometry: C = 4 at 160 rows, 80 blocks, one an SM) shares a
// tile of kTileRows = 8 rows.  Every block holds the tile's row gradients
// (dhp, dz2, dz1 and, masked, dmz2 and dmz1) in its shared memory; each of
// the five transposed products is a cluster_dense_t over the cluster, whose
// owners apply elu' (or the mask's derivatives), write the row gradient
// once to the phase-B scratch and into every block (`Peers::put`).  The
// crops go row r to block r mod C, which receives that row's glimpse
// gradient alone, crops its rows side by side in groups of threads at the
// two non-zeros of each interpolation row (sparse_crop_*) and writes their
// where-gradients.
struct BwdSmem {
  int ld_d, ld2, ld1, ldg, ldm;  // row strides (multiples of 4)
  int dhp, dz2, dz1, dmz2, dmz1, dg0, ring, parts, total;
};

__host__ __device__ inline BwdSmem bwd_smem(const GlimpseDims& d, bool masked) {
  BwdSmem L;
  const int n = kTileRows, G = d.gh * d.gw;
  L.ld_d = round4(2 * d.n_what);
  L.ld2 = round4(d.d2);
  L.ld1 = round4(d.d1);
  L.ldg = round4(G);
  L.ldm = round4(d.d_m);
  int o = 0;
  L.dhp = take(o, n * L.ld_d);
  L.dz2 = take(o, n * L.ld2);
  L.dz1 = take(o, n * L.ld1);
  L.dmz2 = take(o, masked ? n * L.ldg : 0);
  L.dmz1 = take(o, masked ? n * L.ldm : 0);
  L.dg0 = take(o, n * L.ldg);  // the glimpse gradient of the block's crop rows
  // the products' ring, which the crops borrow (one group's scratch at least)
  const int crop = round4(SparseCrop::floats(CropDims{d.H, d.W, d.gh, d.gw}, true));
  L.ring = take(o, crop > kRingT ? crop : kRingT);
  L.parts = take(o, kParts);
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) glimpse_bwd_kernel(GlimpseBwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const GlimpseDims& d = p.d;
  const int G = d.gh * d.gw, D = 2 * d.n_what;
  const bool masked = p.mi != nullptr;
  const BwdSmem L = bwd_smem(d, masked);
  float *dhp = smem + L.dhp, *dz2 = smem + L.dz2, *dz1 = smem + L.dz1, *dmz2 = smem + L.dmz2;
  float *dmz1 = smem + L.dmz1, *dg0 = smem + L.dg0, *ring = smem + L.ring;
  float* parts = smem + L.parts;
  const Peers pe;
  const int C = pe.n, rank = pe.rank;
  const int row0 = (blockIdx.x / C) * kTileRows;
  const int rows = min(kTileRows, d.n - row0);
  // whether this block writes element i of a loop over kThreads-strided
  // elements that every block computes (turns of kThreads, round robin)
  auto mine = [&](int i) { return (i / kThreads) % C == rank; };

  const TTerm t_h[1] = {{dhp, L.ld_d, D, p.wh}};
  const ProductPlan L_h = stage_product(t_h, d.d2, pe, ring);
  // the head: dhp = [dloc, dscale softplus'(z)], softplus' = 1 - exp(-(scale - 1e-2))
  for (int i = threadIdx.x; i < kTileRows * D; i += kThreads) {
    const int r = i / D, j = i - r * D;
    float v = 0.f;
    if (r < rows) {
      const size_t row = (size_t)(row0 + r);
      if (j < d.n_what) {
        v = __ldg(&p.dloc[row * d.n_what + j]);
      } else {
        const size_t o = row * d.n_what + j - d.n_what;
        v = __ldg(&p.dscale[o]) * (1.f - expf(-(__ldg(&p.scale[o]) - kMinStd)));
      }
      if (mine(i)) p.dhp[row * D + j] = v;
    }
    dhp[r * L.ld_d + j] = v;
  }
  __syncthreads();
  // the encoder and the head: dz2 = (dhp Wh^T) elu'(h2), dz1 = (dz2 We2^T) elu'(h1)
  cluster_dense_t(t_h, L_h, pe, ring, parts, [&](int r, int k, float v, float) {
    float dz = 0.f;
    if (r < rows) {
      const size_t o = (size_t)(row0 + r) * d.d2 + k;
      dz = v * act_grad_from_output(__ldg(&p.h2[o]), kElu);
      p.dz2[o] = dz;
    }
    pe.put(dz2 + r * L.ld2 + k, dz);
  });
  {
    const TTerm t[1] = {{dz2, L.ld2, d.d2, p.we2}};
    cluster_dense_t<1>(t, d.d1, pe, ring, parts, [&](int r, int k, float v, float) {
      float dz = 0.f;
      if (r < rows) {
        const size_t o = (size_t)(row0 + r) * d.d1 + k;
        dz = v * act_grad_from_output(__ldg(&p.h1[o]), kElu);
        p.dz1[o] = dz;
      }
      pe.put(dz1 + r * L.ld1 + k, dz);
    });
  }
  // dg = dz1 We1^T, the (masked) glimpse's gradient; when masked, dmask =
  // dg g0, dg0 = dg mask, dmz2 = dmask mask (1 - mask), and the masked
  // glimpse g0 mask goes to phase B.  Row r's dg0 goes to block r mod C.
  {
    const TTerm t[1] = {{dz1, L.ld1, d.d1, p.we1}};
    cluster_dense_t<1>(t, G, pe, ring, parts, [&](int r, int k, float v, float) {
      if (!masked) {
        if (r < rows) pe.put_to(dg0 + r * L.ldg + k, r % C, v);
        return;
      }
      float vz = 0.f;
      if (r < rows) {
        const size_t o = (size_t)(row0 + r) * G + k;
        const float m = __ldg(&p.mask[o]), g = __ldg(&p.g0[o]);
        vz = v * g * m * (1.f - m);
        p.dmz2[o] = vz;
        p.gflat[o] = g * m;
        pe.put_to(dg0 + r * L.ldg + k, r % C, v * m);
      }
      pe.put(dmz2 + r * L.ldg + k, vz);
    });
  }
  if (masked) {
    // dmhid = dmz2 Wm2^T, dmz1 = dmhid elu'(mhid); dmi = dmz1 Wm1^T
    {
      const TTerm t[1] = {{dmz2, L.ldg, G, p.wm2}};
      cluster_dense_t<1>(t, d.d_m, pe, ring, parts, [&](int r, int k, float v, float) {
        float dz = 0.f;
        if (r < rows) {
          const size_t o = (size_t)(row0 + r) * d.d_m + k;
          dz = v * act_grad_from_output(__ldg(&p.mhid[o]), kElu);
          p.dmz1[o] = dz;
        }
        pe.put(dmz1 + r * L.ldm + k, dz);
      });
    }
    const TTerm t[1] = {{dmz1, L.ldm, d.d_m, p.wm1}};
    cluster_dense_t<1>(t, d.d_mi, pe, ring, parts, [&](int r, int k, float v, float) {
      if (r < rows) p.dmi[(size_t)(row0 + r) * d.d_mi + k] = v;
    });
  }

  // the crops of the block's rows r = rank + m C, ng side by side in the ring
  const CropDims cd = crop_dims(d);
  const int fl = round4(SparseCrop::floats(cd, true));
  const int nr = rank < rows ? (rows - rank + C - 1) / C : 0;
  int ng = 1;
  while (ng < nr && ng < kMaxCropGroups && 2 * ng * fl <= L.parts - L.ring) ng *= 2;
  const int nt = kThreads / ng, g = threadIdx.x / nt, t = threadIdx.x - g * nt;
  const SparseCrop sc(ring + g * fl, cd, true);
  for (int m0 = 0; m0 < nr; m0 += ng) {
    const int m = m0 + g;
    const bool active = m < nr;
    const int r = active ? rank + m * C : 0;
    const size_t b = (size_t)(row0 + r);
    const float* frame = p.img + b * d.H * d.W;
    float c[4];
    sparse_crop_setup(frame, p.wl + b * 4, cd, sc, c, active, t, nt);
    sparse_crop_bwd(frame, cd, sc, c, dg0 + r * L.ldg, p.dwl + b * 4, active, t, nt);
    __syncthreads();  // the next rows reuse the scratch
  }
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
// dims is {n, H, W, gh, gw, d_mi, d_m, d1, d2, n_what}.  `geom` is the
// host's launch geometry (ops/fused_glimpse.py glimpse_fwd_geometry): tile
// rows, cluster size and blocks; the launch is refused unless they match
// this file's tiles, or the tile's state (fwd_smem) does not fit a block's
// 227 KB.  All f32, contiguous and on the device; ptrs, dims and geom are
// host arrays.  Launches on `stream`, does not synchronise, allocates
// nothing, and returns the CUDA error code of the launch (0 on success).
extern "C" int sqair_fused_glimpse(void* const* ptrs, const int* dims, const int* geom,
                                   void* stream) {
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
  const bool masked = p.mi != nullptr;
  if (!masked) {
    p.d.d_mi = p.d.d_m = 0;
  } else if (d.d_mi < 1 || d.d_m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int cluster = geom[1];
  const int tiles = cdiv(d.n, kTileRows);
  const size_t smem = sizeof(float) * (size_t)fwd_smem(p.d, masked).total;
  if (geom[0] != kTileRows || cluster < 1 || cluster > kMaxCluster ||
      geom[2] != tiles * cluster || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(glimpse_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(glimpse_fwd_kernel, p, tiles * cluster, cluster, smem,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward.  ptrs holds, in order: img, wl, mi (null: unmasked), Wm1,
// Wm2 (null when unmasked), We1, We2, Wh, the saved g0, h1, h2, scale, mask
// and mhid (the last two null when unmasked), dloc and dscale [n, n_what];
// then the outputs dwl [n, 4], dmi [n, d_mi], dWm1, dbm1, dWm2, dbm2 (null
// when unmasked), dWe1, dbe1, dWe2, dbe2, dWh, dbh; then scratch of
// n (2 n_what + d2 + d1) floats, plus n (2 G + d_m) when masked.  dims and
// the contract are the forward's.  `geom` is the host's launch geometry of
// phase A (ops/fused_glimpse.py glimpse_bwd_geometry): tile rows, cluster
// size and blocks; the launch is refused unless they match this file's
// tiles, or the tile's state (bwd_smem) does not fit a block's 227 KB.
// Launches phase A and phase B.
extern "C" int sqair_fused_glimpse_bwd(void* const* ptrs, const int* dims, const int* geom,
                                       void* stream) {
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

  const int cluster = geom[1];
  const int tiles = cdiv(d.n, kTileRows);
  const size_t smem = sizeof(float) * (size_t)bwd_smem(d, masked).total;
  if (geom[0] != kTileRows || cluster < 1 || cluster > kMaxCluster ||
      geom[2] != tiles * cluster || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(glimpse_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(glimpse_bwd_kernel, p, tiles * cluster, cluster, smem, s);
  if (err != cudaSuccess) return (int)err;
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
