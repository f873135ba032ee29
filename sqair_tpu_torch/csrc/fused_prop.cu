// The fused propagation unroll of one frame, forward and backward.
//
// Replaces: sqair_tpu/ops/fused_cells.py, `_prop_run_fwd` (the Pallas
// kernel `_prop_fwd_kernel`) and `_prop_run_bwd` (`_prop_bwd_kernel`),
// behind `fused_prop_ssm`.  Per row b of the batch the S propagation slots
// run in order (slot k + 1 reads slot k's what, where and presence and its
// transition state h):
//
//   gwl = where_tm1 + (elu(ht Wb1 + bb1) Wb2 + bb2) 0.1
//   mask = sigmoid(elu(ht Wm1 + bm1) Wm2 + bm2)
//   g1loc = (elu(elu((crop(gwl) mask) We1 + be1) We2 + be2) Wh + bh)[:n_what]
//   h = tanh([g1loc, what_{k-1}, where_{k-1}, pres_{k-1}, what_tm1,
//             where_tm1, pres_tm1, ht] Wr + h Ur + br)
//   a = elu-elu-id MLP([h, where_tm1, ht]); where_loc = where_tm1 + a[:4]
//   where_scale = softplus(a[4:]) + 1e-2 (the scale offset - 1 is in the bias)
//   where = where_loc + where_scale (eps_w tril^T + eps_w)
//   g2loc, g2scale = the encoder and head at where (softplus + 1e-2)
//   zr = sigmoid(tin Wg + ht Ug + bg), tin = [h, where, g2loc, g2scale]
//   c = tanh(tin Wc + (r ht) Uc + bc); ht' = (1 - z) ht + z c
//   tloc, tscale = ht' Wtd + btd (softplus + 1e-2); gates = sigmoid(ht' Wga + bga) 0.9999
//   what_loc = f what_tm1 + (1 - i) g2loc + (1 - t) tloc
//   what_scale = (1 - i) g2scale + (1 - t) tscale; what = what_loc + what_scale eps_x
//   logit = pres_tm1 (elu([h, ht, what] Wsp1 + bsp1) Wsp2 + bsp2) + (pres_tm1 - 1) 88
//   presence = (u < sigmoid(logit)) pres_tm1
//
// The forward writes the ten outputs and one residual row per (slot, row)
// (the JAX package's fields in its order, unpadded; R = 3749 floats at the
// release model's widths).  The backward is the JAX package's
// `_prop_bwd_kernel`: slots in reverse, carrying the gradients of the
// explaining-away inputs and of h across slots, recomputing both crops,
// elu' read off the output (1 at 0), the scale clip straight-through, no
// gradient into the frame or the noise.
//
// What bounds it on an H100 at the release model's shapes (f32, B k = 160
// rows, S = 3, 50 x 50 frames, 20 x 20 glimpses, 256 wide): operations.  A
// row-slot does ~1.63 M multiply-adds (two crops and two encoders, the
// mask, the transition, the estimator, the GRU, the heads), 1.56 GFLOP a
// call: 23 us at 67 TFLOP/s off the tensor cores, against ~14 MB of
// weights, frames, outputs and residuals (4 us at 3.35 TB/s); the backward
// about twice that.
//
// The forward was redesigned for Hopper (prop_fwd_kernel, its own note
// below) with the bits of its first design, in which one block owned 2 rows
// and every thread walked K for its columns with each weight load feeding
// 2 FMAs: 80 blocks each re-read the ~5.9 MB of a slot's weights from L2,
// and 92% of its 1.29 ms went to the products (clock64 a block), bound by
// L2 latency, not FLOPs.  It now runs clusters of 4 blocks over tiles of 8
// rows: every product a cluster_dense (cluster_dense.cuh: W's tiles staged
// coalesced, K split over the warps, columns over the cluster's blocks),
// the rows' crops spread over the blocks at the two non-zeros of each
// interpolation row.  The crops and encoders are glimpse_common.cuh's,
// shared with fused_glimpse.cu.
//
// The backward is two launches, as fused_bwd.cu's MLP backward, and was
// redesigned for Hopper: phase A (prop_bwd_kernel) chains the row
// gradients through the slots in reverse and writes every layer's dz and
// the weight products' left operands that the residual rows do not hold to
// scratch; phase B (fused_bwd.cu's tile_reduce_kernel) reduces the 21 weight
// gradients and their biases over all rows and slots in fixed order.  No
// atomics: two runs give the same bits, and they are the bits of the first
// design (one block of 2 rows, each thread walking its own row of W).
// That design spent 2.7 of its 2.8 ms in phase A, ~20 products a slot each
// a warp load touching 32 cache lines; phase A now runs clusters of 4
// blocks over tiles of 8 rows, every product a cluster_dense_t
// (cluster_dense.cuh: W staged coalesced, j split over the warps, columns
// over the cluster's blocks) and the rows' crops spread over the blocks
// (its own note below).

#include "cluster_dense.cuh"
#include "glimpse_common.cuh"

namespace sqair {

struct PropDims {
  int B, S, H, W, gh, gw, nw, U, SP, WB, MH;
  int G, d_rnn, d_stp, d_tin, d_spf;
  int R, Z;  // residual and scratch row widths
  // residual fields (the JAX package's `_prop_offsets`, unpadded)
  int wbh, maskh, mask, e11, e12, g1loc, h, a1, a2, e21, e22, g2loc, g2sc, zr, c, tloc, tsc,
      gates, s1, lraw, gwl;
};

// Scratch fields of one row-slot (backward): the weight products' left
// operands that the residual row does not hold, then every layer's dz.
struct PropScratch {
  int rnn_in, hprev, stp_in, tin, rh, spf, gfl1, gfl2, dwsc;
  int dwbh, dwb, dmaskh, dmz2, dz11, dz21, dz12, dz22, dhp1, dhp2, dzr, dza1, dza2, dstp8, da,
      dcin, dtd, dzg, dsp1, dlraw;
  int Z;
};

__host__ __device__ inline PropScratch prop_scratch(const PropDims& d) {
  PropScratch s;
  int o = 0;
  s.rnn_in = take(o, d.d_rnn);
  s.hprev = take(o, d.U);
  s.stp_in = take(o, d.d_stp);
  s.tin = take(o, d.d_tin);
  s.rh = take(o, d.U);
  s.spf = take(o, d.d_spf);
  s.gfl1 = take(o, d.G);
  s.gfl2 = take(o, d.G);
  s.dwsc = take(o, 4);
  s.dwbh = take(o, d.WB);
  s.dwb = take(o, 4);
  s.dmaskh = take(o, d.MH);
  s.dmz2 = take(o, d.G);
  s.dz11 = take(o, d.U);
  s.dz21 = take(o, d.U);
  s.dz12 = take(o, d.U);
  s.dz22 = take(o, d.U);
  s.dhp1 = take(o, 2 * d.nw);
  s.dhp2 = take(o, 2 * d.nw);
  s.dzr = take(o, d.U);
  s.dza1 = take(o, d.U);
  s.dza2 = take(o, d.U);
  s.dstp8 = take(o, 8);
  s.da = take(o, 2 * d.U);
  s.dcin = take(o, d.U);
  s.dtd = take(o, 2 * d.nw);
  s.dzg = take(o, 3 * d.nw);
  s.dsp1 = take(o, d.SP);
  s.dlraw = take(o, 1);
  s.Z = o;
  return s;
}

bool read_prop_dims(const int* v, PropDims& d) {
  d = PropDims{};
  d.B = v[0]; d.S = v[1]; d.H = v[2]; d.W = v[3]; d.gh = v[4]; d.gw = v[5];
  d.nw = v[6]; d.U = v[7]; d.SP = v[8]; d.WB = v[9]; d.MH = v[10];
  d.G = d.gh * d.gw;
  d.d_rnn = 3 * d.nw + 10 + d.U;
  d.d_stp = 2 * d.U + 4;
  d.d_tin = d.U + 4 + 2 * d.nw;
  d.d_spf = 2 * d.U + d.nw;
  int o = 0;
  d.wbh = take(o, d.WB); d.maskh = take(o, d.MH); d.mask = take(o, d.G);
  d.e11 = take(o, d.U); d.e12 = take(o, d.U); d.g1loc = take(o, d.nw);
  d.h = take(o, d.U); d.a1 = take(o, d.U); d.a2 = take(o, d.U);
  d.e21 = take(o, d.U); d.e22 = take(o, d.U); d.g2loc = take(o, d.nw); d.g2sc = take(o, d.nw);
  d.zr = take(o, 2 * d.U); d.c = take(o, d.U); d.tloc = take(o, d.nw); d.tsc = take(o, d.nw);
  d.gates = take(o, 3 * d.nw); d.s1 = take(o, d.SP); d.lraw = take(o, 1); d.gwl = take(o, 4);
  d.R = o;
  d.Z = prop_scratch(d).Z;
  const int widest[] = {d.G, 2 * d.U, 3 * d.nw, d.d_rnn, d.d_stp, d.d_tin, d.d_spf, d.WB, d.MH,
                        d.SP};
  for (int w : widest)
    if (w > kMaxWidth) return false;
  return d.B > 0 && d.S > 0 && d.H > 1 && d.W > 1 && d.gh > 1 && d.gw > 1 && d.nw > 0 &&
         d.U > 0 && d.SP > 0 && d.WB > 0 && d.MH > 0;
}

// The 38 weights, in the order of the JAX package's `_prop_weights_flat`.
struct PropWeights {
  const float *wb1w, *wb1b, *wb2w, *wb2b, *m1w, *m1b, *m2w, *m2b, *we1, *be1, *we2, *be2, *wh,
      *bh, *rw, *ru, *rb, *s1w, *s1b, *s2w, *s2b, *s3w, *s3b, *tril, *gwg, *gug, *gbg, *gwc,
      *guc, *gbc, *tdw, *tdb, *gaw, *gab, *sp1w, *sp1b, *sp2w, *sp2b;
};
constexpr int kPropWeights = 38;
static_assert(sizeof(PropWeights) == kPropWeights * sizeof(const float*), "38 pointers");

PropWeights read_weights(const float* const* f) {
  PropWeights w;
  const float** dst = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kPropWeights; ++i) dst[i] = f[i];
  return w;
}

// The inputs: img [B, H, W], what_tm1 [S, B, nw], where_tm1 [S, B, 4],
// pres_tm1 [S, B, 1], ht [S, B, U], h0 [B, U], eps_w [S, B, 4], eps_x
// [S, B, nw], u [S, B, 1].
struct PropInputs {
  const float *img, *wt1, *wh1, *p1, *th, *h0b, *epsw, *epsx, *u;
};

PropInputs read_inputs(const float* const* f) {
  return PropInputs{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
}

// ------------------------------------------------------------- forward
struct PropFwdArgs {
  PropDims d;
  PropWeights w;
  PropInputs in;
  // what, what_loc, what_scale, where, where_loc, where_scale, prob,
  // presence, logit, temporal state [S, B, d]; residual rows [S, B, R]
  float *what, *what_loc, *what_scale, *where, *where_loc, *where_scale, *prob, *pres, *logit,
      *tnew, *res;
};

// A thread block cluster of C blocks (ops/fused_cells.py prop_fwd_geometry:
// C = 4 at 160 rows, 80 blocks, one an SM) shares a tile of kTileRows = 8
// rows.  Every block holds the tile's forward state in its shared memory
// and runs the elementwise steps (the where sample, the GRU's mix, the what
// fusion and sample) for all 8 rows itself; each of the ~20 products of a
// slot is a cluster_dense over the cluster (W's [32 k][32 cols] tiles staged
// coalesced, K split over the warps, columns over the blocks), whose owners
// write the outputs into every block's state (`Peers::put`) and the residual
// fields once.  The crops go row r to block r mod C, at the two non-zeros
// of each interpolation row (sparse_crop_*), each glimpse row put into
// every block before the mask multiply and the encoder.  A global write of
// a value every block computes is made by one block.
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Row strides of the forward's buffers (multiples of 4: the products read
// their left operands as float4s).
struct FwdLds {
  int rin, stp, tin, spf, g, u, u2, hp, wb, mh, sp, td, ga;
};

__host__ __device__ inline FwdLds fwd_lds(const PropDims& d) {
  return FwdLds{round4(d.d_rnn), round4(d.d_stp), round4(d.d_tin), round4(d.d_spf),
                round4(d.G),     round4(d.U),     round4(2 * d.U), round4(2 * d.nw),
                round4(d.WB),    round4(d.MH),    round4(d.SP),    round4(2 * d.nw),
                round4(3 * d.nw)};
}

// Shared memory of the forward, [kTileRows][ld] each: the state that lives
// across a slot (the concatenated rows rin, stp, tin, spf; the where-bias
// location and the mask, which both glimpses read), then one region that
// each phase of a slot lays out anew (the where bias and the mask MLP; a
// glimpse and its encoder; the estimator; the GRU; the heads and the
// presence, which keep the GRU's htn), then the products' ring (which the
// crops borrow) and partial sums.  The estimator's st8 lies past the
// glimpse's gbuf: the where sample reads it while peers' crops of glimpse
// 2 already fill gbuf.
struct FwdSmem {
  int rin, stp, tin, spf, gwl, mask;
  int wbh, maskh, gbuf, e1, e2, hp, a1, a2, st8, htn, zr, rh, c, td, gates, s1;
  int ring, parts, total;
};

__host__ __device__ inline FwdSmem fwd_smem(const PropDims& d) {
  FwdSmem L;
  const FwdLds ld = fwd_lds(d);
  const int n = kTileRows;
  int o = 0;
  L.rin = take4(o, n * ld.rin);  // [g1loc, what, where, pres of slot k-1, what_tm1, where_tm1, pres_tm1, ht]
  L.stp = take4(o, n * ld.stp);  // [h, where_tm1, ht]; h is the transition's previous state
  L.tin = take4(o, n * ld.tin);  // [h, where, g2loc, g2scale]
  L.spf = take4(o, n * ld.spf);  // [h, ht, what]
  L.gwl = take4(o, n * 4);
  L.mask = take4(o, n * ld.g);
  const int u0 = o;
  int end = u0, q;
  q = u0;  // the where bias and the mask MLP
  L.wbh = take4(q, n * ld.wb);
  L.maskh = take4(q, n * ld.mh);
  end = imax(end, q);
  q = u0;  // a glimpse and its encoder
  L.gbuf = take4(q, n * ld.g);
  L.e1 = take4(q, n * ld.u);
  L.e2 = take4(q, n * ld.u);
  L.hp = take4(q, n * ld.hp);
  end = imax(end, q);
  q = u0;  // the estimator
  L.a1 = take4(q, n * ld.u);
  L.a2 = take4(q, n * ld.u);
  q = imax(q, L.gbuf + n * ld.g);
  L.st8 = take4(q, n * 8);
  end = imax(end, q);
  q = u0;  // the GRU
  L.htn = take4(q, n * ld.u);
  L.zr = take4(q, n * ld.u2);
  L.rh = take4(q, n * ld.u);
  L.c = take4(q, n * ld.u);
  end = imax(end, q);
  q = L.htn + n * ld.u;  // the heads and the presence, after htn
  L.td = take4(q, n * ld.td);
  L.gates = take4(q, n * ld.ga);
  L.s1 = take4(q, n * ld.sp);
  end = imax(end, q);
  o = end;
  const int crop = round4(SparseCrop::floats(CropDims{d.H, d.W, d.gh, d.gw}, false));
  L.ring = take4(o, imax(kRingT, crop));
  L.parts = take4(o, kParts);
  L.total = o;
  return L;
}

// The glimpse of each row of the tile at its where logits wl + r * ldwl
// (shared memory), masked and encoded (glimpse_encode_fwd): e1, e2 (and
// their residual fields o1, o2) and the head's pre-activation hp [2 nw].
// Row r is cropped by block r mod C and put into every block's gbuf; rows
// past `rows` get a zero glimpse.  Every thread of every block calls it.
__device__ __forceinline__ void prop_glimpse_fwd(const PropFwdArgs& p, const Peers& pe,
                                                 const FwdSmem& L, int row0, int rows,
                                                 const float* wl, int ldwl, float* smem,
                                                 float* res0, int o1, int o2) {
  const PropDims& d = p.d;
  const PropWeights& w = p.w;
  const FwdLds ld = fwd_lds(d);
  const int R = d.R;
  float *e1 = smem + L.e1, *e2 = smem + L.e2, *hp = smem + L.hp;
  glimpse_encode_fwd(
      p.in.img, CropDims{d.H, d.W, d.gh, d.gw}, wl, ldwl, pe, row0, rows, smem + L.gbuf, ld.g,
      smem + L.mask, w.we1, e1, d.U, ld.u, w.we2, e2, d.U, ld.u, w.wh, 2 * d.nw, smem + L.ring,
      L.parts - L.ring, smem + L.parts, [](int, int, float) {},
      [&](int r, int j, float z) {
        const float v = apply_act(z + w.be1[j], kElu);
        if (r < rows) res0[r * R + o1 + j] = v;
        pe.put(e1 + r * ld.u + j, v);
      },
      [&](int r, int j, float z) {
        const float v = apply_act(z + w.be2[j], kElu);
        if (r < rows) res0[r * R + o2 + j] = v;
        pe.put(e2 + r * ld.u + j, v);
      },
      [&](int r, int j, float z) { pe.put(hp + r * ld.hp + j, z + w.bh[j]); });
}

__global__ void __launch_bounds__(kThreads, 1) prop_fwd_kernel(PropFwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NR = kTileRows;
  const PropDims& d = p.d;
  const PropWeights& w = p.w;
  const PropInputs& in = p.in;
  const FwdSmem L = fwd_smem(d);
  const FwdLds ld = fwd_lds(d);
  float *rin = smem + L.rin, *stp = smem + L.stp, *tin = smem + L.tin, *spf = smem + L.spf;
  float *wbh = smem + L.wbh, *gwl = smem + L.gwl, *maskh = smem + L.maskh, *mask = smem + L.mask;
  float *hp = smem + L.hp, *a1 = smem + L.a1, *a2 = smem + L.a2, *st8 = smem + L.st8;
  float *rh = smem + L.rh, *zr = smem + L.zr, *cc = smem + L.c, *htn = smem + L.htn;
  float *td = smem + L.td, *gates = smem + L.gates, *s1 = smem + L.s1;
  float *ring = smem + L.ring, *parts = smem + L.parts;
  const Peers pe;
  const int C = pe.n, rank = pe.rank;
  const int NW = d.nw, U = d.U, G = d.G, R = d.R;
  const int drn = ld.rin, dst = ld.stp, dti = ld.tin, dsp = ld.spf;  // row strides
  const int o_sw = NW, o_swh = 2 * NW, o_sp = 2 * NW + 4, o_wt = 2 * NW + 5, o_wh = 3 * NW + 5,
            o_p = 3 * NW + 9, o_ht = 3 * NW + 10;  // fields of rin
  const int row0 = (blockIdx.x / C) * NR;
  const int rows = min(NR, d.B - row0);
  const float* ht = rin + o_ht;     // row stride drn
  const float* ht4 = spf + U;       // the same, 16-byte aligned rows: a product's operand
  // whether this block writes element i of a loop over kThreads-strided
  // elements that every block computes (turns of kThreads, round robin)
  auto mine = [&](int i) { return (i / kThreads) % C == rank; };

  // slot 0: no explaining-away inputs yet; the transition's state is h0
  for (int i = threadIdx.x; i < NR * drn; i += kThreads) rin[i] = 0.f;
  for (int i = threadIdx.x; i < NR * U; i += kThreads) {
    const int r = i / U, j = i - r * U;
    stp[r * dst + j] = r < rows ? in.h0b[(size_t)(row0 + r) * U + j] : 0.f;
  }
  __syncthreads();

  for (int k = 0; k < d.S; ++k) {
    const size_t slot = (size_t)k * d.B + row0;  // the tile's first row-slot
    float* res0 = p.res + slot * R;              // row r at res0 + r * R
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      const float v = r < rows ? in.th[(slot + r) * U + j] : 0.f;
      rin[r * drn + o_ht + j] = v;
      stp[r * dst + U + 4 + j] = v;
      spf[r * dsp + U + j] = v;
    }
    for (int i = threadIdx.x; i < NR * NW; i += kThreads) {
      const int r = i / NW, j = i - r * NW;
      rin[r * drn + o_wt + j] = r < rows ? in.wt1[(slot + r) * NW + j] : 0.f;
    }
    for (int i = threadIdx.x; i < NR * 4; i += kThreads) {
      const int r = i / 4, j = i - r * 4;
      const float v = r < rows ? in.wh1[(slot + r) * 4 + j] : 0.f;
      rin[r * drn + o_wh + j] = v;
      stp[r * dst + U + j] = v;
    }
    for (int r = threadIdx.x; r < NR; r += kThreads)
      rin[r * drn + o_p] = r < rows ? in.p1[slot + r] : 0.f;
    __syncthreads();

    // the where bias and the glimpse mask, from the old temporal state
    {
      const TTerm t[1] = {{ht4, dsp, U, w.wb1w}};
      cluster_dense<1>(t, d.WB, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = apply_act(z + w.wb1b[j], kElu);
        if (r < rows) res0[r * R + d.wbh + j] = v;
        pe.put(wbh + r * ld.wb + j, v);
      });
    }
    {
      const TTerm t[1] = {{wbh, ld.wb, d.WB, w.wb2w}};
      cluster_dense<1>(t, 4, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = rin[r * drn + o_wh + j] + (z + w.wb2b[j]) * 0.1f;
        if (r < rows) res0[r * R + d.gwl + j] = v;
        pe.put(gwl + r * 4 + j, v);
      });
    }
    {
      const TTerm t[1] = {{ht4, dsp, U, w.m1w}};
      cluster_dense<1>(t, d.MH, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = apply_act(z + w.m1b[j], kElu);
        if (r < rows) res0[r * R + d.maskh + j] = v;
        pe.put(maskh + r * ld.mh + j, v);
      });
    }
    {
      const TTerm t[1] = {{maskh, ld.mh, d.MH, w.m2w}};
      cluster_dense<1>(t, G, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = sigmoidf(z + w.m2b[j]);
        if (r < rows) res0[r * R + d.mask + j] = v;
        pe.put(mask + r * ld.g + j, v);
      });
    }

    // glimpse 1 at the where-bias location: its loc feeds the transition
    prop_glimpse_fwd(p, pe, L, row0, rows, gwl, 4, smem, res0, d.e11, d.e12);
    for (int i = threadIdx.x; i < NR * NW; i += kThreads) {
      const int r = i / NW, j = i - r * NW;
      const float v = hp[r * ld.hp + j];
      rin[r * drn + j] = v;
      if (r < rows && mine(i)) res0[r * R + d.g1loc + j] = v;
    }
    __syncthreads();

    // the transition: h = tanh(rin Wr + h Ur + br), h into tin[:U] and spf[:U]
    {
      const TTerm t[2] = {{rin, drn, d.d_rnn, w.rw}, {stp, dst, U, w.ru}};
      cluster_dense<2>(t, U, pe, ring, parts, [&](int r, int j, float z0, float z1) {
        const float z = z0 + z1;
        const float v = tanhf(z + w.rb[j]);
        if (r < rows) res0[r * R + d.h + j] = v;
        pe.put(tin + r * dti + j, v);
        pe.put(spf + r * dsp + j, v);
      });
    }
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      stp[r * dst + j] = tin[r * dti + j];
    }
    __syncthreads();

    // the relative where: estimator, then the full-covariance sample
    {
      const TTerm t[1] = {{stp, dst, d.d_stp, w.s1w}};
      cluster_dense<1>(t, U, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = apply_act(z + w.s1b[j], kElu);
        if (r < rows) res0[r * R + d.a1 + j] = v;
        pe.put(a1 + r * ld.u + j, v);
      });
    }
    {
      const TTerm t[1] = {{a1, ld.u, U, w.s2w}};
      cluster_dense<1>(t, U, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = apply_act(z + w.s2b[j], kElu);
        if (r < rows) res0[r * R + d.a2 + j] = v;
        pe.put(a2 + r * ld.u + j, v);
      });
    }
    {
      const TTerm t[1] = {{a2, ld.u, U, w.s3w}};
      cluster_dense<1>(t, 8, pe, ring, parts, [&](int r, int j, float z, float) {
        pe.put(st8 + r * 8 + j, z + w.s3b[j]);
      });
    }
    for (int i = threadIdx.x; i < NR * 4; i += kThreads) {
      const int r = i / 4, j = i - r * 4;
      const float wloc = stp[r * dst + U + j] + st8[r * 8 + j];
      const float wsc = softplus(st8[r * 8 + 4 + j]) + kMinStd;
      float where = 0.f;
      if (r < rows) {
        const float* e = in.epsw + (slot + r) * 4;
        float m = 0.f;
        for (int q = 0; q < 4; ++q) m += e[q] * w.tril[j * 4 + q];
        where = wloc + wsc * (m + e[j]);
        if (mine(i)) {
          const size_t o = (slot + r) * 4 + j;
          p.where[o] = where;
          p.where_loc[o] = wloc;
          p.where_scale[o] = wsc;
        }
      }
      tin[r * dti + U + j] = where;
    }
    __syncthreads();

    // glimpse 2 at the sampled where
    prop_glimpse_fwd(p, pe, L, row0, rows, tin + U, dti, smem, res0, d.e21, d.e22);
    for (int i = threadIdx.x; i < NR * 2 * NW; i += kThreads) {
      const int r = i / (2 * NW), j = i - r * 2 * NW;
      const float z = hp[r * ld.hp + j];
      const float v = j < NW ? z : softplus(z) + kMinStd;
      tin[r * dti + U + 4 + j] = v;
      if (r < rows && mine(i)) res0[r * R + (j < NW ? d.g2loc + j : d.g2sc + j - NW)] = v;
    }
    __syncthreads();

    // the temporal GRU
    {
      const TTerm t[2] = {{tin, dti, d.d_tin, w.gwg}, {ht4, dsp, U, w.gug}};
      cluster_dense<2>(t, 2 * U, pe, ring, parts, [&](int r, int j, float z0, float z1) {
        const float z = z0 + z1;
        const float v = sigmoidf(z + w.gbg[j]);
        if (r < rows) res0[r * R + d.zr + j] = v;
        pe.put(zr + r * ld.u2 + j, v);
      });
    }
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      rh[r * ld.u + j] = zr[r * ld.u2 + U + j] * ht[r * drn + j];
    }
    __syncthreads();
    {
      const TTerm t[2] = {{tin, dti, d.d_tin, w.gwc}, {rh, ld.u, U, w.guc}};
      cluster_dense<2>(t, U, pe, ring, parts, [&](int r, int j, float z0, float z1) {
        const float z = z0 + z1;
        const float v = tanhf(z + w.gbc[j]);
        if (r < rows) res0[r * R + d.c + j] = v;
        pe.put(cc + r * ld.u + j, v);
      });
    }
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      const float z = zr[r * ld.u2 + j];
      const float v = (1.f - z) * ht[r * drn + j] + z * cc[r * ld.u + j];
      htn[r * ld.u + j] = v;
      if (r < rows && mine(i)) p.tnew[(slot + r) * U + j] = v;
    }
    __syncthreads();

    // the temporal what distribution and the gates
    {
      const TTerm t[1] = {{htn, ld.u, U, w.tdw}};
      cluster_dense<1>(t, 2 * NW, pe, ring, parts, [&](int r, int j, float z, float) {
        float v = z + w.tdb[j];
        if (j >= NW) v = softplus(v) + kMinStd;
        if (r < rows) res0[r * R + (j < NW ? d.tloc + j : d.tsc + j - NW)] = v;
        pe.put(td + r * ld.td + j, v);
      });
    }
    {
      const TTerm t[1] = {{htn, ld.u, U, w.gaw}};
      cluster_dense<1>(t, 3 * NW, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = sigmoidf(z + w.gab[j]) * 0.9999f;
        if (r < rows) res0[r * R + d.gates + j] = v;
        pe.put(gates + r * ld.ga + j, v);
      });
    }

    // the what fusion and sample; what is the next slot's explaining away
    for (int i = threadIdx.x; i < NR * NW; i += kThreads) {
      const int r = i / NW, j = i - r * NW;
      const float* g = gates + r * ld.ga;
      const float f = g[j], ig = g[NW + j], tg = g[2 * NW + j];
      const float g2l = tin[r * dti + U + 4 + j], g2s = tin[r * dti + U + 4 + NW + j];
      const float tl = td[r * ld.td + j], ts = td[r * ld.td + NW + j];
      const float wl = f * rin[r * drn + o_wt + j] + (1.f - ig) * g2l + (1.f - tg) * tl;
      const float ws = (1.f - ig) * g2s + (1.f - tg) * ts;
      float what = 0.f;
      if (r < rows) {
        const size_t o = (slot + r) * NW + j;
        what = wl + ws * in.epsx[o];
        if (mine(i)) {
          p.what[o] = what;
          p.what_loc[o] = wl;
          p.what_scale[o] = ws;
        }
      }
      spf[r * dsp + 2 * U + j] = what;
      rin[r * drn + o_sw + j] = what;
    }
    __syncthreads();

    // the steps predictor (on the OLD temporal state) and the presence
    {
      const TTerm t[1] = {{spf, dsp, d.d_spf, w.sp1w}};
      cluster_dense<1>(t, d.SP, pe, ring, parts, [&](int r, int j, float z, float) {
        const float v = apply_act(z + w.sp1b[j], kElu);
        if (r < rows) res0[r * R + d.s1 + j] = v;
        pe.put(s1 + r * ld.sp + j, v);
      });
    }
    {
      const TTerm t[1] = {{s1, ld.sp, d.SP, w.sp2w}};
      cluster_dense<1>(t, 1, pe, ring, parts, [&](int r, int, float z, float) {
        const float lraw = z + w.sp2b[0];
        const float pk = rin[r * drn + o_p];
        const float logit = pk * lraw + (pk - 1.f) * 88.f;
        const float prob = sigmoidf(logit);
        float pres = 0.f;
        if (r < rows) {
          pres = (in.u[slot + r] < prob ? 1.f : 0.f) * pk;
          res0[r * R + d.lraw] = lraw;
          p.prob[slot + r] = prob;
          p.pres[slot + r] = pres;
          p.logit[slot + r] = logit;
        }
        pe.put(rin + r * drn + o_sp, pres);
      });
    }
    for (int i = threadIdx.x; i < NR * 4; i += kThreads) {
      const int r = i / 4, j = i - r * 4;
      rin[r * drn + o_swh + j] = tin[r * dti + U + j];
    }
    __syncthreads();
  }
}

// --------------------------------------------------- backward, phase A
// A thread block cluster of C blocks (ops/fused_cells.py prop_bwd_geometry:
// C = 4 at 160 rows, 80 blocks, one an SM) shares a tile of kTileRows = 8
// rows.  Every block holds the tile's whole backward state in its shared
// memory and runs the elementwise steps for all 8 rows itself; each of
// the ~20 transposed products of a slot is a cluster_dense_t over the
// cluster, whose epilogue writes its outputs into every block's state.  The
// rows' crops and crop backwards are spread over the blocks (row r by block
// r mod C), which send the where-gradient (and, once both glimpses have
// added to it, the mask gradient) of their rows to the others.  A global
// write of a value every block computes is made by one block: the scratch
// rows are split over the blocks in turns of kThreads elements.
struct PropBwdArgs {
  PropDims d;
  PropScratch sc;
  PropWeights w;
  PropInputs in;
  // saved outputs: what, what_scale, where, where_scale, prob, presence,
  // temporal state; residual rows
  const float *what, *what_scale, *where, *where_scale, *prob, *pres, *tnew, *res;
  // the outputs' gradients, in the forward's output order
  const float *dwhat, *dwhat_loc, *dwhat_scale, *dwhere, *dwhere_loc, *dwhere_scale, *dprob,
      *dpres, *dlogit, *dtnew;
  float *dwt1, *dwh1, *dp1, *dth, *dh0;  // the inputs' gradients
  float* scratch;                        // [S, B, Z]
  const float* crop_keep;  // [S, B] or null: keep_crop_grad's factors, both crops
};

// Row strides of the left operands of the products (multiples of 4: the
// units read them as float4s).
struct BwdLds {
  int u, u2, sp, zg, td, hp, g, wbh, mh, rnn;
};

__host__ __device__ inline BwdLds bwd_lds(const PropDims& d) {
  return BwdLds{round4(d.U), round4(2 * d.U), round4(d.SP), round4(3 * d.nw), round4(2 * d.nw),
                round4(2 * d.nw), round4(d.G), round4(d.WB), round4(d.MH), round4(d.d_rnn)};
}

// Shared memory of the backward, [kTileRows][width] each: the state that
// lives across a slot, then one region that each phase of a slot lays out
// anew (the steps predictor; the gates and the GRU; a glimpse's encoder;
// the estimator; the transition; the where bias and the mask), then the
// products' ring (which a crop borrows) and partial sums.
struct BwdSmem {
  int ht, dsw, dswh, dsp, dhc, dlr, dp1, dspf, dwt1, dwh1, dg2, dtin, dmask, dwl;
  int dsp1, dzg, dtd, dhtn, dcin, drh, da, dhp, dz2, dz1, dg, dst8, dza2, dza1, dzr, drnn, dwb,
      dwbh, dmz2, dmaskh;
  int ring, parts, total;
};

__host__ __device__ inline BwdSmem bwd_smem(const PropDims& d) {
  BwdSmem L;
  const BwdLds ld = bwd_lds(d);
  const int n = kTileRows, NW = d.nw, U = d.U;
  int o = 0;
  L.ht = take4(o, n * U);
  L.dsw = take4(o, n * NW);  // carried from slot k + 1: d what_{k}
  L.dswh = take4(o, n * 4);  // d where_{k}
  L.dsp = take4(o, n);       // d presence_{k}
  L.dhc = take4(o, n * U);   // d h_{k}
  L.dlr = take4(o, n);
  L.dp1 = take4(o, n);
  L.dspf = take4(o, n * d.d_spf);  // [d h (accumulated), d ht (accumulated), d what]
  L.dwt1 = take4(o, n * NW);
  L.dwh1 = take4(o, n * 4);
  L.dg2 = take4(o, n * 2 * NW);
  L.dtin = take4(o, n * d.d_tin);
  L.dmask = take4(o, n * d.G);
  L.dwl = take4(o, n * 4);
  const int u0 = o;
  int end = u0, q;
  q = u0;  // the steps predictor
  L.dsp1 = take4(q, n * ld.sp);
  end = imax(end, q);
  q = u0;  // the gates and the GRU
  L.dzg = take4(q, n * ld.zg);
  L.dtd = take4(q, n * ld.td);
  L.dhtn = take4(q, n * ld.u);
  L.dcin = take4(q, n * ld.u);
  L.drh = take4(q, n * ld.u);
  L.da = take4(q, n * ld.u2);
  end = imax(end, q);
  q = u0;  // a glimpse's encoder
  L.dhp = take4(q, n * ld.hp);
  L.dz2 = take4(q, n * ld.u);
  L.dz1 = take4(q, n * ld.u);
  L.dg = take4(q, n * ld.g);
  end = imax(end, q);
  q = u0;  // the estimator
  L.dst8 = take4(q, n * 8);
  L.dza2 = take4(q, n * ld.u);
  L.dza1 = take4(q, n * ld.u);
  end = imax(end, q);
  q = u0;  // the transition; glimpse 1's dhp (at u0) is formed from drnn
  L.dzr = take4(q, n * imax(ld.u, ld.hp));
  L.drnn = take4(q, n * ld.rnn);
  end = imax(end, q);
  q = u0;  // the where bias
  L.dwb = take4(q, n * 4);
  L.dwbh = take4(q, n * ld.wbh);
  end = imax(end, q);
  q = u0;  // the mask
  L.dmz2 = take4(q, n * ld.g);
  L.dmaskh = take4(q, n * ld.mh);
  end = imax(end, q);
  o = end;
  const CropDims cd{d.H, d.W, d.gh, d.gw};
  const int crop = (int)(CropSmem::floats(cd) + CropSmem::bwd_floats(cd)) + d.G;
  L.ring = take4(o, imax(kRingT, crop));
  L.parts = take4(o, kParts);
  L.total = o;
  return L;
}

// One glimpse's backward over the tile's rows, from the head's gradient dhp
// [8][ld hp] (t_head, its product with Wh^T, staged by the caller as
// L_head): the encoder chain over the cluster (dz into the scratch
// fields s_dz2, s_dz1), then the crops of the block's rows recomputed at
// each row's where (res or output memory, stride ldwl), dmask (set when
// `first`, else added and sent to every block), the masked glimpse into the
// scratch field s_gfl, and the where gradient into dwl [4] per row, sent to
// every block.  Every thread of every block calls it.
__device__ __forceinline__ void prop_glimpse_bwd(const PropBwdArgs& p, const Peers& pe, int row0,
                                                 int rows, size_t slot, const float* wl,
                                                 size_t ldwl, int o_e1, int o_e2, int s_dz2,
                                                 int s_dz1, int s_gfl, bool first,
                                                 const TTerm (&t_head)[1],
                                                 const ProductPlan& L_head, float* dz2, float* dz1,
                                                 float* dg, float* dmask, float* dwl, float* ring,
                                                 float* parts) {
  const PropDims& d = p.d;
  const PropWeights& w = p.w;
  const BwdLds ld = bwd_lds(d);
  const CropDims cd{d.H, d.W, d.gh, d.gw};
  const int G = d.G, R = d.R, Z = p.sc.Z, U = d.U;
  const float* res0 = p.res + slot * R;
  float* sc0 = p.scratch + slot * Z;
  // the encoder's backward: dz2 = (dhp Wh^T) elu'(h2), dz1 = (dz2 We2^T) elu'(h1), dg = dz1 We1^T
  const float* h1 = res0 + o_e1;
  const float* h2 = res0 + o_e2;
  cluster_dense_t(t_head, L_head, pe, ring, parts, [&](int r, int k, float v, float) {
    float dz = 0.f;
    if (r < rows) {
      dz = v * act_grad_from_output(__ldg(&h2[(size_t)r * R + k]), kElu);
      sc0[(size_t)r * Z + s_dz2 + k] = dz;
    }
    pe.put(dz2 + r * ld.u + k, dz);
  });
  {
    const TTerm t[1] = {{dz2, ld.u, U, w.we2}};
    cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k, float v, float) {
      float dz = 0.f;
      if (r < rows) {
        dz = v * act_grad_from_output(__ldg(&h1[(size_t)r * R + k]), kElu);
        sc0[(size_t)r * Z + s_dz1 + k] = dz;
      }
      pe.put(dz1 + r * ld.u + k, dz);
    });
  }
  {
    const TTerm t[1] = {{dz1, ld.u, U, w.we1}};
    cluster_dense_t<1>(t, G, pe, ring, parts,
                       [&](int r, int k, float v, float) { pe.put(dg + r * ld.g + k, v); });
  }
  // the crops, row r by block r mod C, in the ring
  const CropSmem cs(ring, cd);
  float* bw = ring + CropSmem::floats(cd);
  float* g0 = bw + CropSmem::bwd_floats(cd);
  for (int r = 0; r < kTileRows; ++r) {
    if (r >= rows) {
      for (int i = threadIdx.x; i < G; i += kThreads) {
        if (first) dmask[r * G + i] = 0.f;
      }
      for (int i = threadIdx.x; i < 4; i += kThreads) dwl[r * 4 + i] = 0.f;
      continue;
    }
    if (r % pe.n != pe.rank) continue;
    float c[4];
    crop_setup(p.in.img + (size_t)(row0 + r) * d.H * d.W, wl + r * ldwl, cd, cs, c);
    crop_glimpse(cd, cs, g0, nullptr);
    for (int i = threadIdx.x; i < G; i += kThreads) {
      const float m = __ldg(&res0[(size_t)r * R + d.mask + i]), g = g0[i], dgv = dg[r * ld.g + i];
      dmask[r * G + i] = first ? dgv * g : dmask[r * G + i] + dgv * g;
      sc0[(size_t)r * Z + s_gfl + i] = g * m;
      dg[r * ld.g + i] = dgv * m;
    }
    __syncthreads();
    crop_bwd(cd, cs, c, dg + r * ld.g, bw, dwl + r * 4);
    for (int i = threadIdx.x; i < 4; i += kThreads) pe.put(dwl + r * 4 + i, dwl[r * 4 + i]);
    if (!first) {
      for (int i = threadIdx.x; i < G; i += kThreads) pe.put(dmask + r * G + i, dmask[r * G + i]);
    }
  }
  cluster_sync_all();
}

__global__ void __launch_bounds__(kThreads, 1) prop_bwd_kernel(PropBwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NR = kTileRows;
  const PropDims& d = p.d;
  const PropScratch& s = p.sc;
  const PropWeights& w = p.w;
  const PropInputs& in = p.in;
  const BwdSmem L = bwd_smem(d);
  const BwdLds ld = bwd_lds(d);
  float *hts = smem + L.ht, *dsw = smem + L.dsw, *dswh = smem + L.dswh, *dsp = smem + L.dsp;
  float *dhc = smem + L.dhc, *dlr = smem + L.dlr, *dp1 = smem + L.dp1, *dspf = smem + L.dspf;
  float *dwt1 = smem + L.dwt1, *dwh1 = smem + L.dwh1, *dg2 = smem + L.dg2, *dtin = smem + L.dtin;
  float *dmask = smem + L.dmask, *dwl = smem + L.dwl, *dsp1 = smem + L.dsp1;
  float *dzg = smem + L.dzg, *dtd = smem + L.dtd, *dhtn = smem + L.dhtn, *dcin = smem + L.dcin;
  float *drh = smem + L.drh, *da = smem + L.da, *dhp = smem + L.dhp, *dz2 = smem + L.dz2;
  float *dz1 = smem + L.dz1, *dg = smem + L.dg, *dst8 = smem + L.dst8, *dza2 = smem + L.dza2;
  float *dza1 = smem + L.dza1, *dzr = smem + L.dzr, *drnn = smem + L.drnn, *dwb = smem + L.dwb;
  float *dwbh = smem + L.dwbh, *dmz2 = smem + L.dmz2, *dmaskh = smem + L.dmaskh;
  float *ring = smem + L.ring, *parts = smem + L.parts;
  const Peers pe;
  const int C = pe.n, rank = pe.rank;
  const int NW = d.nw, U = d.U, G = d.G, R = d.R, Z = s.Z;
  const int dsf = d.d_spf, dti = d.d_tin;
  const int row0 = (blockIdx.x / C) * NR;
  const int rows = min(NR, d.B - row0);
  // whether this block writes element i of a loop over kThreads-strided
  // elements that every block computes (turns of kThreads, round robin)
  auto mine = [&](int i) { return (i / kThreads) % C == rank; };

  for (int i = threadIdx.x; i < NR * U; i += kThreads) dhc[i] = 0.f;
  for (int i = threadIdx.x; i < NR * NW; i += kThreads) dsw[i] = 0.f;
  for (int i = threadIdx.x; i < NR * 4; i += kThreads) dswh[i] = 0.f;
  for (int i = threadIdx.x; i < NR; i += kThreads) dsp[i] = 0.f;
  // every block of the cluster runs before any writes into its shared memory
  cluster_sync_all();

  for (int k = d.S - 1; k >= 0; --k) {
    const size_t slot = (size_t)k * d.B + row0;
    const float* res0 = p.res + slot * R;  // row r at res0 + r * R
    float* sc0 = p.scratch + slot * Z;     // row r at sc0 + r * Z
    __syncthreads();
    // each product's first round is staged before the elementwise step
    // before it, where there is one (stage_product)
    const TTerm t_sp[1] = {{dsp1, ld.sp, d.SP, w.sp1w}};
    const ProductPlan L_sp = stage_product(t_sp, dsf, pe, ring);
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      hts[i] = r < rows ? __ldg(&in.th[(slot + r) * U + j]) : 0.f;
    }
    // the presence
    for (int r = threadIdx.x; r < NR; r += kThreads) {
      float dlraw = 0.f, dpv = 0.f;
      if (r < rows) {
        const size_t o = slot + r;
        const float prob = __ldg(&p.prob[o]), pk = __ldg(&in.p1[o]);
        const float lraw = __ldg(&res0[r * R + d.lraw]);
        const float dpres = __ldg(&p.dpres[o]) + dsp[r];
        const float dlogit = __ldg(&p.dlogit[o]) + __ldg(&p.dprob[o]) * prob * (1.f - prob);
        dlraw = dlogit * pk;
        const float psamp = __ldg(&in.u[o]) < prob ? 1.f : 0.f;
        dpv = dpres * psamp + dlogit * (lraw + 88.f);
        if (mine(r)) sc0[r * Z + s.dlraw] = dlraw;
      }
      dlr[r] = dlraw;
      dp1[r] = dpv;
    }
    __syncthreads();
    // the steps predictor on [h, ht, what]
    for (int i = threadIdx.x; i < NR * d.SP; i += kThreads) {
      const int r = i / d.SP, j = i - r * d.SP;
      float v = 0.f;
      if (r < rows) {
        v = dlr[r] * __ldg(&w.sp2w[j]) * act_grad_from_output(__ldg(&res0[r * R + d.s1 + j]), kElu);
        if (mine(i)) sc0[r * Z + s.dsp1 + j] = v;
      }
      dsp1[r * ld.sp + j] = v;
    }
    for (int i = threadIdx.x + rank * kThreads; i < rows * dsf; i += C * kThreads) {
      const int r = i / dsf, j = i - r * dsf;
      sc0[r * Z + s.spf + j] = j < U ? __ldg(&res0[r * R + d.h + j])
                               : j < 2 * U ? hts[r * U + j - U]
                                           : __ldg(&p.what[(slot + r) * NW + j - 2 * U]);
    }
    __syncthreads();
    cluster_dense_t(t_sp, L_sp, pe, ring, parts,
                    [&](int r, int k2, float v, float) { pe.put(dspf + r * dsf + k2, v); });
    const TTerm t_ga[2] = {{dzg, ld.zg, 3 * NW, w.gaw}, {dtd, ld.td, 2 * NW, w.tdw}};
    const ProductPlan L_ga = stage_product(t_ga, U, pe, ring);

    // the what fusion and the gates
    for (int i = threadIdx.x; i < NR * NW; i += kThreads) {
      const int r = i / NW, j = i - r * NW;
      float v_wt = 0.f, v_g2l = 0.f, v_g2s = 0.f, v_f = 0.f, v_i = 0.f, v_t = 0.f, v_tl = 0.f,
            v_ts = 0.f;
      if (r < rows) {
        const size_t o = (slot + r) * NW + j;
        const float* rr = res0 + r * R;
        const float dwt = __ldg(&p.dwhat[o]) + dsw[i] + dspf[r * dsf + 2 * U + j];
        const float dwl_t = dwt + __ldg(&p.dwhat_loc[o]);
        const float dws_t = dwt * __ldg(&in.epsx[o]) + __ldg(&p.dwhat_scale[o]);
        const float f = __ldg(&rr[d.gates + j]), ig = __ldg(&rr[d.gates + NW + j]);
        const float tg = __ldg(&rr[d.gates + 2 * NW + j]);
        const float g2l = __ldg(&rr[d.g2loc + j]), g2s = __ldg(&rr[d.g2sc + j]);
        const float tl = __ldg(&rr[d.tloc + j]), ts = __ldg(&rr[d.tsc + j]);
        const float gs[3] = {f, ig, tg};
        const float dgt[3] = {dwl_t * __ldg(&in.wt1[o]), -(dwl_t * g2l + dws_t * g2s),
                              -(dwl_t * tl + dws_t * ts)};
        float dz[3];
        for (int q = 0; q < 3; ++q) {
          const float sg = gs[q] * (1.f / 0.9999f);
          dz[q] = dgt[q] * 0.9999f * sg * (1.f - sg);
        }
        v_f = dz[0];
        v_i = dz[1];
        v_t = dz[2];
        v_wt = dwl_t * f;
        v_g2l = dwl_t * (1.f - ig);
        v_g2s = dws_t * (1.f - ig);
        v_tl = dwl_t * (1.f - tg);
        v_ts = dws_t * (1.f - tg) * (1.f - expf(-(ts - kMinStd)));
        if (mine(i)) {
          float* sr = sc0 + r * Z;
          sr[s.dzg + j] = v_f;
          sr[s.dzg + NW + j] = v_i;
          sr[s.dzg + 2 * NW + j] = v_t;
          sr[s.dtd + j] = v_tl;
          sr[s.dtd + NW + j] = v_ts;
        }
      }
      dwt1[i] = v_wt;
      dg2[r * 2 * NW + j] = v_g2l;
      dg2[r * 2 * NW + NW + j] = v_g2s;
      dzg[r * ld.zg + j] = v_f;
      dzg[r * ld.zg + NW + j] = v_i;
      dzg[r * ld.zg + 2 * NW + j] = v_t;
      dtd[r * ld.td + j] = v_tl;
      dtd[r * ld.td + NW + j] = v_ts;
    }
    __syncthreads();
    cluster_dense_t(t_ga, L_ga, pe, ring, parts, [&](int r, int k2, float v, float v2) {
      pe.put(dhtn + r * ld.u + k2,
             r < rows ? (__ldg(&p.dtnew[(slot + r) * U + k2]) + v) + v2 : 0.f);
    });
    const TTerm t_uc[1] = {{dcin, ld.u, U, w.guc}};
    const ProductPlan L_uc = stage_product(t_uc, U, pe, ring);

    // the temporal GRU
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      float vc = 0.f, vz = 0.f;
      if (r < rows) {
        const float* rr = res0 + r * R;
        const float c = __ldg(&rr[d.c + j]), z = __ldg(&rr[d.zr + j]), dh = dhtn[r * ld.u + j];
        vz = dh * (c - hts[i]);
        vc = (dh * z) * (1.f - c * c);
        if (mine(i)) {
          sc0[r * Z + s.dcin + j] = vc;
          sc0[r * Z + s.rh + j] = __ldg(&rr[d.zr + U + j]) * hts[i];
        }
      }
      dcin[r * ld.u + j] = vc;
      da[r * ld.u2 + j] = vz;  // dz_g, times the sigmoid' below
    }
    for (int i = threadIdx.x + rank * kThreads; i < rows * dti; i += C * kThreads) {
      const int r = i / dti, j = i - r * dti;
      const float* rr = res0 + r * R;
      sc0[r * Z + s.tin + j] = j < U ? __ldg(&rr[d.h + j])
                               : j < U + 4 ? __ldg(&p.where[(slot + r) * 4 + j - U])
                               : j < U + 4 + NW ? __ldg(&rr[d.g2loc + j - U - 4])
                                                : __ldg(&rr[d.g2sc + j - U - 4 - NW]);
    }
    __syncthreads();
    cluster_dense_t(t_uc, L_uc, pe, ring, parts,
                    [&](int r, int k2, float v, float) { pe.put(drh + r * ld.u + k2, v); });
    const TTerm t_in[2] = {{dcin, ld.u, U, w.gwc}, {da, ld.u2, 2 * U, w.gwg}};
    const ProductPlan L_in = stage_product(t_in, dti, pe, ring);
    for (int i = threadIdx.x; i < NR * 2 * U; i += kThreads) {
      const int r = i / (2 * U), j = i - r * 2 * U;
      float v = 0.f;
      if (r < rows) {
        const float zz = __ldg(&res0[r * R + d.zr + j]);
        const float pre = j < U ? da[r * ld.u2 + j] : drh[r * ld.u + j - U] * hts[r * U + j - U];
        v = pre * zz * (1.f - zz);
        if (mine(i)) sc0[r * Z + s.da + j] = v;
      }
      da[r * ld.u2 + j] = v;
    }
    __syncthreads();
    cluster_dense_t(t_in, L_in, pe, ring, parts, [&](int r, int k2, float v, float v2) {
      pe.put(dtin + r * dti + k2, v + v2);
    });
    {
      const TTerm t[1] = {{da, ld.u2, 2 * U, w.gug}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        if (r >= rows) return;
        const float z = __ldg(&res0[r * R + d.zr + k2]), rg = __ldg(&res0[r * R + d.zr + U + k2]);
        const float dht = dspf[r * dsf + U + k2];
        pe.put(dspf + r * dsf + U + k2,
               ((dht + dhtn[r * ld.u + k2] * (1.f - z)) + drh[r * ld.u + k2] * rg) + v);
      });
    }
    const TTerm t_head[1] = {{dhp, ld.hp, 2 * NW, w.wh}};
    const ProductPlan L_head2 = stage_product(t_head, U, pe, ring);
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      dspf[r * dsf + j] += dtin[r * dti + j];
    }
    for (int i = threadIdx.x; i < NR * 2 * NW; i += kThreads) {
      const int r = i / (2 * NW), j = i - r * 2 * NW;
      dg2[i] += dtin[r * dti + U + 4 + j];
    }
    __syncthreads();

    // glimpse 2
    for (int i = threadIdx.x; i < NR * 2 * NW; i += kThreads) {
      const int r = i / (2 * NW), j = i - r * 2 * NW;
      float v = 0.f;
      if (r < rows) {
        v = j < NW ? dg2[i]
                   : dg2[i] * (1.f - expf(-(__ldg(&res0[r * R + d.g2sc + j - NW]) - kMinStd)));
        if (mine(i)) sc0[r * Z + s.dhp2 + j] = v;
      }
      dhp[r * ld.hp + j] = v;
    }
    __syncthreads();
    prop_glimpse_bwd(p, pe, row0, rows, slot, p.where + slot * 4, 4, d.e21, d.e22, s.dz22, s.dz21,
                     s.gfl2, true, t_head, L_head2, dz2, dz1, dg, dmask, dwl, ring, parts);
    keep_crop_grad<NR>(dwl, p.crop_keep, slot, rows);
    const TTerm t_s3[1] = {{dst8, 8, 8, w.s3w}};
    const ProductPlan L_s3 = stage_product(t_s3, U, pe, ring);

    // the where sample and the transform estimator
    for (int i = threadIdx.x; i < NR * 4; i += kThreads) {
      const int r = i / 4, j = i - r * 4;
      float dloc = 0.f, dsc = 0.f;
      if (r < rows) {
        const size_t o = (slot + r) * 4 + j;
        const float dwt = ((__ldg(&p.dwhere[o]) + dswh[i]) + dtin[r * dti + U + j]) + dwl[i];
        dloc = dwt + __ldg(&p.dwhere_loc[o]);
        const float* e = in.epsw + (slot + r) * 4;
        float m = 0.f;
        for (int q = 0; q < 4; ++q) m += __ldg(&e[q]) * __ldg(&w.tril[j * 4 + q]);
        const float wsc = __ldg(&p.where_scale[o]);
        const float dwscale = dwt * (m + __ldg(&e[j])) + __ldg(&p.dwhere_scale[o]);
        dsc = dwscale * (1.f - expf(-(wsc - kMinStd)));
        if (mine(i)) {
          float* sr = sc0 + r * Z;
          sr[s.dwsc + j] = dwt * wsc;
          sr[s.dstp8 + j] = dloc;
          sr[s.dstp8 + 4 + j] = dsc;
        }
      }
      dwh1[i] = dloc;
      dst8[r * 8 + j] = dloc;
      dst8[r * 8 + 4 + j] = dsc;
    }
    for (int i = threadIdx.x + rank * kThreads; i < rows * d.d_stp; i += C * kThreads) {
      const int r = i / d.d_stp, j = i - r * d.d_stp;
      sc0[r * Z + s.stp_in + j] = j < U ? __ldg(&res0[r * R + d.h + j])
                                  : j < U + 4 ? __ldg(&in.wh1[(slot + r) * 4 + j - U])
                                              : hts[r * U + j - U - 4];
    }
    __syncthreads();
    cluster_dense_t(t_s3, L_s3, pe, ring, parts, [&](int r, int k2, float v, float) {
      float dz = 0.f;
      if (r < rows) {
        dz = v * act_grad_from_output(__ldg(&res0[r * R + d.a2 + k2]), kElu);
        sc0[r * Z + s.dza2 + k2] = dz;
      }
      pe.put(dza2 + r * ld.u + k2, dz);
    });
    {
      const TTerm t[1] = {{dza2, ld.u, U, w.s2w}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        float dz = 0.f;
        if (r < rows) {
          dz = v * act_grad_from_output(__ldg(&res0[r * R + d.a1 + k2]), kElu);
          sc0[r * Z + s.dza1 + k2] = dz;
        }
        pe.put(dza1 + r * ld.u + k2, dz);
      });
    }
    {
      const TTerm t[1] = {{dza1, ld.u, U, w.s1w}};
      cluster_dense_t<1>(t, d.d_stp, pe, ring, parts, [&](int r, int k2, float v, float) {
        if (k2 < U) {
          pe.put(dspf + r * dsf + k2, dspf[r * dsf + k2] + v);
        } else if (k2 < U + 4) {
          pe.put(dwh1 + r * 4 + k2 - U, dwh1[r * 4 + k2 - U] + v);
        } else {
          pe.put(dspf + r * dsf + U + k2 - U - 4, dspf[r * dsf + U + k2 - U - 4] + v);
        }
      });
    }
    const TTerm t_rw[1] = {{dzr, ld.u, U, w.rw}};
    const ProductPlan L_rw = stage_product(t_rw, d.d_rnn, pe, ring);

    // the transition
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      float v = 0.f;
      if (r < rows) {
        const float h = __ldg(&res0[r * R + d.h + j]);
        v = (dspf[r * dsf + j] + dhc[i]) * (1.f - h * h);
        if (mine(i)) {
          sc0[r * Z + s.dzr + j] = v;
          sc0[r * Z + s.hprev + j] = k > 0 ? __ldg(&res0[r * R - (ptrdiff_t)d.B * R + d.h + j])
                                           : __ldg(&in.h0b[(size_t)(row0 + r) * U + j]);
        }
      }
      dzr[r * ld.u + j] = v;
    }
    for (int i = threadIdx.x + rank * kThreads; i < rows * d.d_rnn; i += C * kThreads) {
      const int r = i / d.d_rnn, j = i - r * d.d_rnn;
      const size_t o = slot + r, prev = o - d.B;
      float v;
      if (j < NW) {
        v = __ldg(&res0[r * R + d.g1loc + j]);
      } else if (j < 2 * NW) {
        v = k > 0 ? __ldg(&p.what[prev * NW + j - NW]) : 0.f;
      } else if (j < 2 * NW + 4) {
        v = k > 0 ? __ldg(&p.where[prev * 4 + j - 2 * NW]) : 0.f;
      } else if (j < 2 * NW + 5) {
        v = k > 0 ? __ldg(&p.pres[prev]) : 0.f;
      } else if (j < 3 * NW + 5) {
        v = __ldg(&in.wt1[o * NW + j - 2 * NW - 5]);
      } else if (j < 3 * NW + 9) {
        v = __ldg(&in.wh1[o * 4 + j - 3 * NW - 5]);
      } else if (j < 3 * NW + 10) {
        v = __ldg(&in.p1[o]);
      } else {
        v = hts[r * U + j - 3 * NW - 10];
      }
      sc0[r * Z + s.rnn_in + j] = v;
    }
    __syncthreads();
    cluster_dense_t(t_rw, L_rw, pe, ring, parts, [&](int r, int k2, float v, float) {
      pe.put(drnn + r * ld.rnn + k2, v);
    });
    {
      const TTerm t[1] = {{dzr, ld.u, U, w.ru}};
      cluster_dense_t<1>(t, U, pe, ring, parts,
                         [&](int r, int k2, float v, float) { pe.put(dhc + r * U + k2, v); });
    }
    const ProductPlan L_head1 = stage_product(t_head, U, pe, ring);
    for (int i = threadIdx.x; i < NR * d.d_rnn; i += kThreads) {
      const int r = i / d.d_rnn, j = i - r * d.d_rnn;
      const float v = drnn[r * ld.rnn + j];
      if (j < NW) {
        // d g1loc: the head's gradient of glimpse 1 (its scale feeds nothing)
      } else if (j < 2 * NW) {
        dsw[r * NW + j - NW] = v;
      } else if (j < 2 * NW + 4) {
        dswh[r * 4 + j - 2 * NW] = v;
      } else if (j < 2 * NW + 5) {
        dsp[r] = v;
      } else if (j < 3 * NW + 5) {
        dwt1[r * NW + j - 2 * NW - 5] += v;
      } else if (j < 3 * NW + 9) {
        dwh1[r * 4 + j - 3 * NW - 5] += v;
      } else if (j < 3 * NW + 10) {
        dp1[r] += v;
      } else {
        dspf[r * dsf + U + j - 3 * NW - 10] += v;
      }
    }
    for (int i = threadIdx.x; i < NR * 2 * NW; i += kThreads) {
      const int r = i / (2 * NW), j = i - r * 2 * NW;
      const float v = j < NW && r < rows ? drnn[r * ld.rnn + j] : 0.f;
      dhp[r * ld.hp + j] = v;
      if (r < rows && mine(i)) sc0[r * Z + s.dhp1 + j] = v;
    }
    __syncthreads();

    // glimpse 1, at the where-bias location
    prop_glimpse_bwd(p, pe, row0, rows, slot, res0 + d.gwl, R, d.e11, d.e12, s.dz12, s.dz11,
                     s.gfl1, false, t_head, L_head1, dz2, dz1, dg, dmask, dwl, ring, parts);
    keep_crop_grad<NR>(dwl, p.crop_keep, slot, rows);
    const TTerm t_b2[1] = {{dwb, 4, 4, w.wb2w}};
    const ProductPlan L_b2 = stage_product(t_b2, d.WB, pe, ring);
    for (int i = threadIdx.x; i < NR * 4; i += kThreads) {
      const int r = i / 4, j = i - r * 4;
      dwh1[i] += dwl[i];
      const float v = dwl[i] * 0.1f;
      dwb[i] = v;
      if (r < rows && mine(i)) sc0[r * Z + s.dwb + j] = v;
    }
    __syncthreads();

    // the where-bias MLP
    cluster_dense_t(t_b2, L_b2, pe, ring, parts, [&](int r, int k2, float v, float) {
      float dz = 0.f;
      if (r < rows) {
        dz = v * act_grad_from_output(__ldg(&res0[r * R + d.wbh + k2]), kElu);
        sc0[r * Z + s.dwbh + k2] = dz;
      }
      pe.put(dwbh + r * ld.wbh + k2, dz);
    });
    {
      const TTerm t[1] = {{dwbh, ld.wbh, d.WB, w.wb1w}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        pe.put(dspf + r * dsf + U + k2, dspf[r * dsf + U + k2] + v);
      });
    }
    const TTerm t_m2[1] = {{dmz2, ld.g, G, w.m2w}};
    const ProductPlan L_m2 = stage_product(t_m2, d.MH, pe, ring);

    // the mask MLP, for both glimpses' uses
    for (int i = threadIdx.x; i < NR * G; i += kThreads) {
      const int r = i / G, j = i - r * G;
      float v = 0.f;
      if (r < rows) {
        const float m = __ldg(&res0[r * R + d.mask + j]);
        v = dmask[i] * m * (1.f - m);
        if (mine(i)) sc0[r * Z + s.dmz2 + j] = v;
      }
      dmz2[r * ld.g + j] = v;
    }
    __syncthreads();
    cluster_dense_t(t_m2, L_m2, pe, ring, parts, [&](int r, int k2, float v, float) {
      float dz = 0.f;
      if (r < rows) {
        dz = v * act_grad_from_output(__ldg(&res0[r * R + d.maskh + k2]), kElu);
        sc0[r * Z + s.dmaskh + k2] = dz;
      }
      pe.put(dmaskh + r * ld.mh + k2, dz);
    });
    {
      const TTerm t[1] = {{dmaskh, ld.mh, d.MH, w.m1w}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        pe.put(dspf + r * dsf + U + k2, dspf[r * dsf + U + k2] + v);
      });
    }

    // this slot's input gradients
    for (int i = threadIdx.x + rank * kThreads; i < rows * U; i += C * kThreads) {
      const int r = i / U, j = i - r * U;
      p.dth[(slot + r) * U + j] = dspf[r * dsf + U + j];
    }
    for (int i = threadIdx.x + rank * kThreads; i < rows * NW; i += C * kThreads) {
      const int r = i / NW, j = i - r * NW;
      p.dwt1[(slot + r) * NW + j] = dwt1[i];
    }
    if (rank == 0) {
      for (int i = threadIdx.x; i < rows * 4; i += kThreads) p.dwh1[slot * 4 + i] = dwh1[i];
      for (int r = threadIdx.x; r < rows; r += kThreads) p.dp1[slot + r] = dp1[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x + rank * kThreads; i < rows * U; i += C * kThreads)
    p.dh0[(size_t)row0 * U + i] = dhc[i];
}

}  // namespace sqair

// The forward.  ptrs holds, in order: img [B, H, W], what_tm1 [S, B, nw],
// where_tm1 [S, B, 4], pres_tm1 [S, B, 1], ht [S, B, U], h0 [B, U], eps_w
// [S, B, 4], eps_x [S, B, nw], u [S, B, 1]; the 38 weights in the order of
// `_prop_weights_flat` (the estimator's last bias with the scale offset
// minus one folded in; We1 [gh gw, U]); then the outputs what, what_loc,
// what_scale [S, B, nw], where, where_loc, where_scale [S, B, 4], prob,
// presence, logit [S, B, 1], the new temporal state [S, B, U] and the
// residual rows [S, B, R].  dims is {B, S, H, W, gh, gw, nw, U, SP, WB,
// MH}.  `geom` is the host's launch geometry (ops/fused_cells.py
// prop_fwd_geometry): tile rows, cluster size and blocks; the launch is
// refused unless they match this file's tiles, or the tile's state
// (fwd_smem) does not fit a block's 227 KB.  All f32, contiguous and on
// the device; ptrs, dims and geom are host arrays.  Launches on `stream`,
// does not synchronise, allocates nothing, and returns the CUDA error code
// of the launch (0 on success).
extern "C" int sqair_fused_prop(void* const* ptrs, const int* dims, const int* geom,
                                void* stream) {
  using namespace sqair;
  PropFwdArgs p{};
  if (!read_prop_dims(dims, p.d)) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  p.in = read_inputs(f);
  p.w = read_weights(f + 9);
  float* const* o = reinterpret_cast<float* const*>(ptrs + 9 + kPropWeights);
  p.what = o[0]; p.what_loc = o[1]; p.what_scale = o[2];
  p.where = o[3]; p.where_loc = o[4]; p.where_scale = o[5];
  p.prob = o[6]; p.pres = o[7]; p.logit = o[8]; p.tnew = o[9]; p.res = o[10];
  const int cluster = geom[1];
  const int tiles = cdiv(p.d.B, kTileRows);
  const size_t smem = sizeof(float) * (size_t)fwd_smem(p.d).total;
  if (geom[0] != kTileRows || cluster < 1 || cluster > kMaxCluster ||
      geom[2] != tiles * cluster || smem > 227 * 1024 || p.d.U % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(prop_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(prop_fwd_kernel, p, tiles * cluster, cluster, smem,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Z, the floats per row-slot of the backward's scratch (PropScratch), for
// the forward's dims; -1 where the dims are refused.
extern "C" int sqair_fused_prop_scratch_floats(const int* dims) {
  sqair::PropDims d;
  return sqair::read_prop_dims(dims, d) ? d.Z : -1;
}

// The backward.  ptrs holds, in order: the forward's 9 inputs and 38
// weights; the saved what, what_scale, where, where_scale, prob, presence,
// new temporal state and residual rows; the gradients of the ten outputs
// (in the forward's order); then the outputs d what_tm1, d where_tm1,
// d pres_tm1, d ht, d h0 and the 38 weights' gradients (in their order; the
// full [4, 4] product for tril); then scratch of S B Z floats, Z as
// sqair_fused_prop_scratch_floats gives it, and a factor [S, B] on each
// row-slot's where-gradients through its two crops, or null (none).  dims
// is the forward's.  `geom` is the host's launch geometry
// (ops/fused_cells.py prop_bwd_geometry): tile rows, cluster size and
// phase A's blocks; the launch is refused unless they match this file's
// tiles, or the tile's state (bwd_smem) does not fit a block's 227 KB.
// Launches phase A and phase B.
extern "C" int sqair_fused_prop_bwd(void* const* ptrs, const int* dims, const int* geom,
                                    void* stream) {
  using namespace sqair;
  PropBwdArgs p{};
  if (!read_prop_dims(dims, p.d)) return (int)cudaErrorInvalidValue;
  p.sc = prop_scratch(p.d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  p.in = read_inputs(f);
  p.w = read_weights(f + 9);
  const float* const* sv = f + 9 + kPropWeights;
  p.what = sv[0]; p.what_scale = sv[1]; p.where = sv[2]; p.where_scale = sv[3];
  p.prob = sv[4]; p.pres = sv[5]; p.tnew = sv[6]; p.res = sv[7];
  const float* const* g = sv + 8;
  p.dwhat = g[0]; p.dwhat_loc = g[1]; p.dwhat_scale = g[2];
  p.dwhere = g[3]; p.dwhere_loc = g[4]; p.dwhere_scale = g[5];
  p.dprob = g[6]; p.dpres = g[7]; p.dlogit = g[8]; p.dtnew = g[9];
  float* const* o = reinterpret_cast<float* const*>(ptrs + 9 + kPropWeights + 18);
  p.dwt1 = o[0]; p.dwh1 = o[1]; p.dp1 = o[2]; p.dth = o[3]; p.dh0 = o[4];
  float* const* dw = o + 5;
  p.scratch = o[5 + kPropWeights];
  p.crop_keep = o[6 + kPropWeights];

  // phase B: every weight gradient over the S B row-slots, in fixed order
  const PropDims& d = p.d;
  const PropScratch& c = p.sc;
  const float* res = p.res;
  const float* sc = p.scratch;
  const int R = d.R, Z = c.Z, U = d.U, NW = d.nw;
  OuterArgs q{};
  q.n = d.S * d.B;
  int n = 0;
  auto job = [&](const float* a, int lda, const float* dz, int ldz, int wi, bool bias, int K,
                 int J, const float* a2 = nullptr, const float* dz2 = nullptr) {
    OuterJob& jb = q.job[n++];
    jb = OuterJob{a, dz, dw[wi], bias ? dw[wi + 1] : nullptr, lda, ldz, K, J, a2, dz2};
  };
  // weight indices in `_prop_weights_flat` order (the bias follows its matrix)
  job(p.in.th, U, sc + c.dwbh, Z, 0, true, U, d.WB);                 // wb1
  job(res + d.wbh, R, sc + c.dwb, Z, 2, true, d.WB, 4);               // wb2
  job(p.in.th, U, sc + c.dmaskh, Z, 4, true, U, d.MH);                // m1
  job(res + d.maskh, R, sc + c.dmz2, Z, 6, true, d.MH, d.G);          // m2
  job(sc + c.gfl1, Z, sc + c.dz11, Z, 8, true, d.G, U, sc + c.gfl2, sc + c.dz21);    // we1
  job(res + d.e11, R, sc + c.dz12, Z, 10, true, U, U, res + d.e21, sc + c.dz22);     // we2
  job(res + d.e12, R, sc + c.dhp1, Z, 12, true, U, 2 * NW, res + d.e22, sc + c.dhp2);  // wh
  job(sc + c.rnn_in, Z, sc + c.dzr, Z, 14, false, d.d_rnn, U);        // rw
  job(sc + c.hprev, Z, sc + c.dzr, Z, 15, false, U, U);               // ru
  q.job[n - 2].db = dw[16];                                            // rb, with rw
  job(sc + c.stp_in, Z, sc + c.dza1, Z, 17, true, d.d_stp, U);        // s1
  job(res + d.a1, R, sc + c.dza2, Z, 19, true, U, U);                 // s2
  job(res + d.a2, R, sc + c.dstp8, Z, 21, true, U, 8);                // s3
  job(sc + c.dwsc, Z, p.in.epsw, 4, 23, false, 4, 4);                 // tril
  job(sc + c.tin, Z, sc + c.da, Z, 24, false, d.d_tin, 2 * U);        // gwg
  q.job[n - 1].db = dw[26];                                            // gbg
  job(p.in.th, U, sc + c.da, Z, 25, false, U, 2 * U);                 // gug
  job(sc + c.tin, Z, sc + c.dcin, Z, 27, false, d.d_tin, U);          // gwc
  q.job[n - 1].db = dw[29];                                            // gbc
  job(sc + c.rh, Z, sc + c.dcin, Z, 28, false, U, U);                 // guc
  job(p.tnew, U, sc + c.dtd, Z, 30, true, U, 2 * NW);                 // td
  job(p.tnew, U, sc + c.dzg, Z, 32, true, U, 3 * NW);                 // gates
  job(sc + c.spf, Z, sc + c.dsp1, Z, 34, true, d.d_spf, d.SP);        // sp1
  job(res + d.s1, R, sc + c.dlraw, Z, 36, true, d.SP, 1);             // sp2
  q.n_jobs = n;

  const int cluster = geom[1];
  const int tiles = cdiv(d.B, kTileRows);
  const size_t smem = sizeof(float) * (size_t)bwd_smem(d).total;
  if (geom[0] != kTileRows || cluster < 1 || cluster > kMaxCluster ||
      geom[2] != tiles * cluster || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(prop_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(prop_bwd_kernel, p, tiles * cluster, cluster, smem, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_tiles(q, s);
}

