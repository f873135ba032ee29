// The fused discovery unroll of one frame, forward and backward.
//
// Replaces: sqair_tpu/ops/fused_cells.py, `_disc_run_fwd` (the Pallas
// kernel `_disc_fwd_kernel`) and `_disc_run_bwd` (`_disc_bwd_kernel`),
// behind `fused_disc_ssm`.  Once per frame the input encoder
//
//   enc = elu(elu(img Wi1 + bi1) Wi2 + bi2)        [B, H W] -> U -> U
//
// then per row b of the batch the S discovery slots in order (slot k + 1
// reads slot k's what, where and presence and its transition state h):
//
//   h = tanh([enc, cond, what_{k-1}, where_{k-1}, pres_{k-1}] Wr + h Ur + br)
//   a = elu-elu-id MLP(h) -> 8; where_loc = a[:4]
//   where_scale = softplus(a[4:]) + 1e-2 (the scale offset is in the bias)
//   where = where_loc + where_scale eps_w
//   g = crop(img, where) (unmasked); e = elu(elu(g We1 + be1) We2 + be2)
//   what_loc, what_scale = (e Wh + bh) split (softplus + 1e-2)
//   what = what_loc + what_scale eps_x
//   logit = pres_{k-1} (elu([h, what] Wsp1 + bsp1) Wsp2 + bsp2) + (pres_{k-1} - 1) 88
//   presence = (u < sigmoid(logit)) pres_{k-1}
//
// with (what, where, presence) = (0, 0, 1) and h = h0 before slot 0.  The
// forward writes the nine outputs, one residual row per (slot, row) (the
// JAX package's fields h, a1, a2, e1, e2, s1, lraw in its order, unpadded;
// R = 5 U + SP + 1 = 1409 floats at the release model's widths), the
// glimpses [S, B, gh gw] and the input encoder's two layers [B, 2U].  The
// backward is the JAX package's `_disc_bwd_kernel`: slots in reverse,
// carrying the gradients of the explaining-away inputs, of h and the
// two-term gradient of the previous presence across slots, recomputing the
// crop's interpolation from the saved where, then the input encoder; elu'
// read off the output (1 at 0), the scale clip straight-through, no
// gradient into the frame or the noise.
//
// What bounds it on an H100 at the release model's shapes (f32, B k = 160
// rows, S = 3, 50 x 50 frames, 20 x 20 glimpses, 256 wide, conditioning
// 256): operations.  The input encoder is ~113 M multiply-adds a call
// (160 x 2500 x 256 + 160 x 256 x 256) and a row-slot ~0.65 M (the
// transition, 567 + 256 wide; the estimator; the crop; the glimpse encoder
// and head; the steps predictor), 0.85 GFLOP a call: 13 us at 67 TFLOP/s
// off the tensor cores, against ~13 MB of frames, weights, outputs and
// residuals (4 us at 3.35 TB/s); the backward about twice that.
//
// The forward was redesigned for Hopper with the bits of its first design,
// in which the input encoder was a launch of 8 rows a block (each thread
// walking K = 2500 for its columns) and the slots a launch of 2 rows a
// block, every product a per-thread walk over W's columns (each weight load
// feeding 2 FMAs, the slot's weights re-read from L2 by all 80 blocks) and
// the crops dense, one row at a time: 0.717 ms a call on an H100.  The
// input encoder now runs fused_mlp.cu's kernel (clusters of 8 blocks over
// 8-row tiles at 160 rows, its outputs written side by side into the
// layers' [B, 2U]), and the slots run clusters of 4 blocks over tiles of 8
// rows (disc_fwd_kernel, its own note below): every product a
// cluster_dense (cluster_dense.cuh), the glimpse and its encoder
// glimpse_common.cuh's glimpse_encode_fwd, shared with fused_glimpse.cu and
// fused_prop.cu.

// The backward is three launches: phase A (disc_bwd_kernel) chains the row
// gradients through the slots in reverse and then through the input
// encoder, and writes every layer's dz and the weight products' left
// operands that the residual rows do not hold to scratch; phase B
// (tile_reduce_kernel, twice) reduces the ten slot layers' weight
// gradients over all S B row-slots and the input encoder's two over the B
// rows, in fixed order.  No atomics: two runs give the same bits, and they
// are the bits of phase A's first design, in which one block owned 2
// rows (80 blocks at 160 rows), each thread walked its own row
// of W for each transposed product (a warp load touching 32 cache lines)
// and the crops were dense, one row at a time: on an H100 that phase took
// 1.122 of the call's 1.171 ms, 88.6% of it in the products (clock64 a
// block).  Phase A now runs clusters of 4 blocks over tiles of 8 rows,
// every product a cluster_dense_t (cluster_dense.cuh) and the crops at the
// two non-zeros of each interpolation row, the rows spread over the blocks
// (its own note below).

#include "glimpse_common.cuh"

namespace sqair {

struct DiscDims {
  int B, S, H, W, gh, gw, nw, U, SP, C;
  int G, HW, d_rnn, d_spf;
  int R, Z;  // residual and scratch row widths
  // residual fields (the JAX package's `_disc_offsets`, unpadded)
  int h, a1, a2, e1, e2, s1, lraw;
};

// Scratch fields of one row-slot (backward): the weight products' left
// operands that the residual row does not hold, then every layer's dz.
struct DiscScratch {
  int rnn_in, hprev, spf, dzr, dza1, dza2, dstp8, dz1, dz2, dhp, dsp1, dlraw;
  int Z;
};

__host__ __device__ inline DiscScratch disc_scratch(const DiscDims& d) {
  DiscScratch s;
  int o = 0;
  s.rnn_in = take(o, d.d_rnn);
  s.hprev = take(o, d.U);
  s.spf = take(o, d.d_spf);
  s.dzr = take(o, d.U);
  s.dza1 = take(o, d.U);
  s.dza2 = take(o, d.U);
  s.dstp8 = take(o, 8);
  s.dz1 = take(o, d.U);
  s.dz2 = take(o, d.U);
  s.dhp = take(o, 2 * d.nw);
  s.dsp1 = take(o, d.SP);
  s.dlraw = take(o, 1);
  s.Z = o;
  return s;
}

bool read_disc_dims(const int* v, DiscDims& d) {
  d = DiscDims{};
  d.B = v[0]; d.S = v[1]; d.H = v[2]; d.W = v[3]; d.gh = v[4]; d.gw = v[5];
  d.nw = v[6]; d.U = v[7]; d.SP = v[8]; d.C = v[9];
  d.G = d.gh * d.gw;
  d.HW = d.H * d.W;
  d.d_rnn = d.U + d.C + d.nw + 5;
  d.d_spf = d.U + d.nw;
  int o = 0;
  d.h = take(o, d.U); d.a1 = take(o, d.U); d.a2 = take(o, d.U);
  d.e1 = take(o, d.U); d.e2 = take(o, d.U); d.s1 = take(o, d.SP); d.lraw = take(o, 1);
  d.R = o;
  d.Z = disc_scratch(d).Z;
  const int widest[] = {d.G, d.U, 2 * d.nw, d.d_rnn, d.d_spf, d.SP};
  for (int w : widest)
    if (w > kMaxWidth) return false;
  return d.B > 0 && d.S > 0 && d.H > 1 && d.W > 1 && d.gh > 1 && d.gw > 1 && d.nw > 0 &&
         d.U > 0 && d.SP > 0 && d.C > 0;
}

// The 23 weights, in the order of the JAX package's `_disc_weights_flat`.
struct DiscWeights {
  const float *wi1, *bi1, *wi2, *bi2, *rw, *ru, *rb, *s1w, *s1b, *s2w, *s2b, *s3w, *s3b, *we1,
      *be1, *we2, *be2, *wh, *bh, *sp1w, *sp1b, *sp2w, *sp2b;
};
constexpr int kDiscWeights = 23;
static_assert(sizeof(DiscWeights) == kDiscWeights * sizeof(const float*), "23 pointers");

DiscWeights read_disc_weights(const float* const* f) {
  DiscWeights w;
  const float** dst = reinterpret_cast<const float**>(&w);
  for (int i = 0; i < kDiscWeights; ++i) dst[i] = f[i];
  return w;
}

// The inputs: img [B, H, W], imgf [B, H W] (the same frames flat), cond
// [B, C], h0 [B, U], eps_w [S, B, 4], eps_x [S, B, nw], u [S, B, 1].
struct DiscInputs {
  const float *img, *imgf, *cond, *h0b, *epsw, *epsx, *u;
};

DiscInputs read_disc_inputs(const float* const* f) {
  return DiscInputs{f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
}

// ------------------------------------------------------------- forward
struct DiscFwdArgs {
  DiscDims d;
  DiscWeights w;
  DiscInputs in;
  // what, what_loc, what_scale, where, where_loc, where_scale, prob,
  // presence, logit [S, B, d]; residual rows [S, B, R]; glimpses
  // [S, B, G]; the input encoder's layers [B, 2U]
  float *what, *what_loc, *what_scale, *where, *where_loc, *where_scale, *prob, *pres, *logit,
      *res, *g0s, *fres;
};

// A thread block cluster of C blocks (ops/fused_cells.py disc_fwd_geometry:
// C = 4 at 160 rows, 80 blocks, one an SM) shares a tile of kTileRows = 8
// rows and runs its S slots; the input encoder is the launch before it
// (fused_mlp.cu's kernel), which writes fres.  Every block holds the tile's
// forward state in its shared memory and runs the elementwise steps (the
// where, what and presence samples) for all 8 rows itself; each product of
// a slot is a cluster_dense (the transition's two terms summed apart and
// then added, as the first design did), whose owners write the outputs
// into every block's state (`Peers::put`) and the residual fields once.
// The glimpse and its encoder are glimpse_encode_fwd's, unmasked: row r
// cropped by block r mod C at the two non-zeros of each interpolation row.
// A global write of a value every block computes is made by one block.

// Row strides of the forward's buffers (multiples of 4: the products read
// their left operands as float4s).
struct DiscFwdLds {
  int rin, spf, u, g, hp, sp;
};

__host__ __device__ inline DiscFwdLds disc_fwd_lds(const DiscDims& d) {
  return DiscFwdLds{round4(d.d_rnn), round4(d.d_spf), round4(d.U), round4(d.G),
                    round4(2 * d.nw), round4(d.SP)};
}

// Shared memory of the forward, [kTileRows][ld] each: the state that lives
// across slots (rin, spf and the transition's previous h), then one region
// that each phase of a slot lays out anew (the estimator; the glimpse and
// its encoder; the steps predictor), then the products' ring (which the
// crops borrow) and partial sums.  The estimator's st8 lies past the
// glimpse's gbuf: the where sample reads it while peers' crops already
// fill gbuf.
struct DiscFwdSmem {
  int rin, spf, hprev, a1, a2, st8, gbuf, e1, e2, hp, s1, ring, parts, total;
};

__host__ __device__ inline DiscFwdSmem disc_fwd_smem(const DiscDims& d) {
  DiscFwdSmem L;
  const DiscFwdLds ld = disc_fwd_lds(d);
  const int n = kTileRows;
  int o = 0;
  L.rin = take4(o, n * ld.rin);  // [enc, cond, what, where, pres of slot k - 1]
  L.spf = take4(o, n * ld.spf);  // [h, what]
  L.hprev = take4(o, n * ld.u);  // the transition's state before the slot
  const int u0 = o;
  int end = u0, q;
  q = u0;  // the glimpse and its encoder
  L.gbuf = take4(q, n * ld.g);
  L.e1 = take4(q, n * ld.u);
  L.e2 = take4(q, n * ld.u);
  L.hp = take4(q, n * ld.hp);
  end = end > q ? end : q;
  q = u0;  // the estimator, st8 past gbuf
  L.a1 = take4(q, n * ld.u);
  L.a2 = take4(q, n * ld.u);
  q = q > L.gbuf + n * ld.g ? q : L.gbuf + n * ld.g;
  L.st8 = take4(q, n * 8);
  end = end > q ? end : q;
  q = u0;  // the steps predictor
  L.s1 = take4(q, n * ld.sp);
  end = end > q ? end : q;
  o = end;
  const int crop = round4(SparseCrop::floats(CropDims{d.H, d.W, d.gh, d.gw}, false));
  L.ring = take4(o, crop > kRingT ? crop : kRingT);
  L.parts = take4(o, kParts);
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) disc_fwd_kernel(DiscFwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NR = kTileRows;
  const DiscDims& d = p.d;
  const DiscWeights& w = p.w;
  const DiscInputs& in = p.in;
  const DiscFwdSmem L = disc_fwd_smem(d);
  const DiscFwdLds ld = disc_fwd_lds(d);
  float *rin = smem + L.rin, *spf = smem + L.spf, *hprev = smem + L.hprev;
  float *a1 = smem + L.a1, *a2 = smem + L.a2, *st8 = smem + L.st8, *gbuf = smem + L.gbuf;
  float *e1 = smem + L.e1, *e2 = smem + L.e2, *hp = smem + L.hp, *s1 = smem + L.s1;
  float *ring = smem + L.ring, *parts = smem + L.parts;
  const CropDims cd{d.H, d.W, d.gh, d.gw};
  const Peers pe;
  const int CL = pe.n, rank = pe.rank;
  const int NW = d.nw, U = d.U, C = d.C, G = d.G, R = d.R;
  const int drn = ld.rin, dsp = ld.spf;  // row strides
  const int o_what = U + C, o_where = U + C + NW, o_pres = U + C + NW + 4;  // fields of rin
  const int row0 = (blockIdx.x / CL) * NR;
  const int rows = min(NR, d.B - row0);
  // whether this block writes element i of a loop over kThreads-strided
  // elements that every block computes (turns of kThreads, round robin)
  auto mine = [&](int i) { return (i / kThreads) % CL == rank; };

  // slot 0: the frame's code and conditioning, no object yet, h = h0
  for (int i = threadIdx.x; i < NR * d.d_rnn; i += kThreads) {
    const int r = i / d.d_rnn, j = i - r * d.d_rnn;
    const size_t row = (size_t)row0 + r;
    float v = 0.f;
    if (j >= o_pres) {
      v = 1.f;
    } else if (r < rows && j < U) {
      v = p.fres[row * 2 * U + U + j];
    } else if (r < rows && j < U + C) {
      v = in.cond[row * C + j - U];
    }
    rin[r * drn + j] = v;
  }
  for (int i = threadIdx.x; i < NR * U; i += kThreads) {
    const int r = i / U, j = i - r * U;
    hprev[r * ld.u + j] = r < rows ? in.h0b[(size_t)(row0 + r) * U + j] : 0.f;
  }
  __syncthreads();

  for (int k = 0; k < d.S; ++k) {
    const size_t slot = (size_t)k * d.B + row0;  // the tile's first row-slot
    float* res0 = p.res + slot * R;              // row r at res0 + r * R

    // the transition: h = tanh(rin Wr + h Ur + br), h into spf[:U]
    {
      const TTerm t[2] = {{rin, drn, d.d_rnn, w.rw}, {hprev, ld.u, U, w.ru}};
      cluster_dense<2>(t, U, pe, ring, parts, [&](int r, int j, float z0, float z1) {
        const float z = z0 + z1;
        const float v = tanhf(z + w.rb[j]);
        if (r < rows) res0[r * R + d.h + j] = v;
        pe.put(spf + r * dsp + j, v);
      });
    }
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      hprev[r * ld.u + j] = spf[r * dsp + j];
    }

    // the transform estimator and the where sample
    {
      const TTerm t[1] = {{spf, dsp, U, w.s1w}};
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
      const float wloc = st8[r * 8 + j];
      const float wsc = softplus(st8[r * 8 + 4 + j]) + kMinStd;
      float where = 0.f;
      if (r < rows) {
        const size_t o = (slot + r) * 4 + j;
        // the plain version's order, unfused: the crop turns at integers
        where = __fadd_rn(wloc, __fmul_rn(wsc, in.epsw[o]));
        if (mine(i)) {
          p.where[o] = where;
          p.where_loc[o] = wloc;
          p.where_scale[o] = wsc;
        }
      }
      rin[r * drn + o_where + j] = where;
    }
    __syncthreads();

    // the unmasked glimpse at the sampled where, encoded, and the head
    glimpse_encode_fwd(
        in.img, cd, rin + o_where, drn, pe, row0, rows, gbuf, ld.g, nullptr, w.we1, e1, U, ld.u,
        w.we2, e2, U, ld.u, w.wh, 2 * NW, ring, L.parts - L.ring, parts,
        [&](int r, int i, float v) { p.g0s[(slot + r) * G + i] = v; },
        [&](int r, int j, float z) {
          const float v = apply_act(z + w.be1[j], kElu);
          if (r < rows) res0[r * R + d.e1 + j] = v;
          pe.put(e1 + r * ld.u + j, v);
        },
        [&](int r, int j, float z) {
          const float v = apply_act(z + w.be2[j], kElu);
          if (r < rows) res0[r * R + d.e2 + j] = v;
          pe.put(e2 + r * ld.u + j, v);
        },
        [&](int r, int j, float z) { pe.put(hp + r * ld.hp + j, z + w.bh[j]); });

    // the what sample; what is the next slot's explaining away
    for (int i = threadIdx.x; i < NR * NW; i += kThreads) {
      const int r = i / NW, j = i - r * NW;
      const float gloc = hp[r * ld.hp + j];
      const float gsc = softplus(hp[r * ld.hp + NW + j]) + kMinStd;
      float what = 0.f;
      if (r < rows) {
        const size_t o = (slot + r) * NW + j;
        what = __fadd_rn(gloc, __fmul_rn(gsc, in.epsx[o]));
        if (mine(i)) {
          p.what[o] = what;
          p.what_loc[o] = gloc;
          p.what_scale[o] = gsc;
        }
      }
      spf[r * dsp + U + j] = what;
      rin[r * drn + o_what + j] = what;
    }
    __syncthreads();

    // the steps predictor on [h, what] and the presence
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
        const float pk = rin[r * drn + o_pres];
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
        pe.put(rin + r * drn + o_pres, pres);
      });
    }
  }
}

// --------------------------------------------------- backward, phase A
struct DiscBwdArgs {
  DiscDims d;
  DiscScratch sc;
  DiscWeights w;
  DiscInputs in;
  // saved outputs: what, what_scale, where, where_scale, prob, presence;
  // residual rows, glimpses, the input encoder's layers
  const float *what, *what_scale, *where, *where_scale, *prob, *pres, *res, *g0s, *fres;
  // the outputs' gradients, in the forward's output order
  const float *dwhat, *dwhat_loc, *dwhat_scale, *dwhere, *dwhere_loc, *dwhere_scale, *dprob,
      *dpres, *dlogit;
  float *dcond, *dh0;  // the inputs' gradients
  float* scratch;      // [S, B, Z], then the input encoder's dz2 and dz1 [B, U] each
  const float* crop_keep;  // [S, B] or null: keep_crop_grad's factors
};

// A thread block cluster of C blocks (ops/fused_cells.py disc_bwd_geometry:
// C = 4 at 160 rows, 80 blocks, one an SM) shares a tile of kTileRows = 8
// rows.  Every block holds the tile's backward state in its shared memory
// (the carried d presence, d what, d where and d h, the d enc and d cond
// sums) and runs the elementwise steps for all 8 rows itself; each of the
// transposed products of a slot, and the input encoder's, is a
// cluster_dense_t over the cluster (W staged coalesced, j split over the
// warps, columns over the blocks), whose owners write the scratch rows once
// and what every block reads next into every block (`Peers::put`).  The
// crops go row r to block r mod C, which alone receives that row's glimpse
// gradient, crops its rows side by side in groups of threads at the two
// non-zeros of each interpolation row (sparse_crop_*) and sends their
// where-gradients to every block.  A global write of a value every block
// computes is made by one block: the scratch rows are split over the
// blocks in turns of kThreads elements.
struct DiscBwdSmem {
  int ldsp, ldhp, ldu, ldg, ldrnn;  // row strides of the products' left operands
  int dpc, dpt, dlr, dwc, dwhc, dhc, denc, dcond, dspf, dwl;
  int dsp1, dhp, dz2, dz1, dg, dst8, dza2, dza1, dzr, drnn;
  int ring, parts, total;
};

// Shared memory of phase A, [kTileRows][width] each: the state that lives
// across a slot, then one region that each phase of a slot lays out anew
// (the steps predictor; the head, the glimpse encoder and the crop's
// gradient; the estimator; the transition), then the products' ring (which
// the crops borrow) and partial sums.  The input encoder's dz2 takes the
// glimpse encoder's place after the last slot.
__host__ __device__ inline DiscBwdSmem disc_bwd_smem(const DiscDims& d) {
  DiscBwdSmem L;
  const int n = kTileRows, U = d.U;
  L.ldsp = round4(d.SP);
  L.ldhp = round4(2 * d.nw);
  L.ldu = round4(U);
  L.ldg = round4(d.G);
  L.ldrnn = round4(d.d_rnn);
  int o = 0;
  L.dpc = take4(o, n);             // carried from slot k + 1: d presence_{k}
  L.dpt = take4(o, n);             // this slot's d pres_{k-1} before the transition's part
  L.dlr = take4(o, n);
  L.dwc = take4(o, n * d.nw);      // d what_{k}
  L.dwhc = take4(o, n * 4);        // d where_{k}
  L.dhc = take4(o, n * U);         // d h_{k}
  L.denc = take4(o, n * U);        // d enc, summed over the slots
  L.dcond = take4(o, n * d.C);     // d cond, summed over the slots
  L.dspf = take4(o, n * d.d_spf);  // [d h (accumulated), d what]
  L.dwl = take4(o, n * 4);
  const int u0 = o;
  int end = u0, q;
  q = u0;  // the steps predictor
  L.dsp1 = take4(q, n * L.ldsp);
  end = end > q ? end : q;
  q = u0;  // the head, the glimpse encoder and the crop's gradient
  L.dhp = take4(q, n * L.ldhp);
  L.dz2 = take4(q, n * L.ldu);
  L.dz1 = take4(q, n * L.ldu);
  L.dg = take4(q, n * L.ldg);
  end = end > q ? end : q;
  q = u0;  // the estimator
  L.dst8 = take4(q, n * 8);
  L.dza2 = take4(q, n * L.ldu);
  L.dza1 = take4(q, n * L.ldu);
  end = end > q ? end : q;
  q = u0;  // the transition
  L.dzr = take4(q, n * L.ldu);
  L.drnn = take4(q, n * L.ldrnn);
  end = end > q ? end : q;
  o = end;
  const int crop = round4(SparseCrop::floats(CropDims{d.H, d.W, d.gh, d.gw}, true));
  L.ring = take4(o, crop > kRingT ? crop : kRingT);
  L.parts = take4(o, kParts);
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) disc_bwd_kernel(DiscBwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NR = kTileRows;
  const DiscDims& d = p.d;
  const DiscScratch& s = p.sc;
  const DiscWeights& w = p.w;
  const DiscInputs& in = p.in;
  const DiscBwdSmem L = disc_bwd_smem(d);
  float *dpc = smem + L.dpc, *dpt = smem + L.dpt, *dlr = smem + L.dlr, *dwc = smem + L.dwc;
  float *dwhc = smem + L.dwhc, *dhc = smem + L.dhc, *denc = smem + L.denc;
  float *dcond = smem + L.dcond, *dsp1 = smem + L.dsp1, *dspf = smem + L.dspf;
  float *dhp = smem + L.dhp, *dz2 = smem + L.dz2, *dz1 = smem + L.dz1, *dg = smem + L.dg;
  float *dwl = smem + L.dwl, *dst8 = smem + L.dst8, *dza2 = smem + L.dza2;
  float *dza1 = smem + L.dza1, *dzr = smem + L.dzr, *drnn = smem + L.drnn;
  float *ring = smem + L.ring, *parts = smem + L.parts;
  const CropDims cd{d.H, d.W, d.gh, d.gw};
  const Peers pe;
  const int CL = pe.n, rank = pe.rank;
  const int NW = d.nw, U = d.U, C = d.C, G = d.G, R = d.R, Z = s.Z;
  const int dsf = d.d_spf, drn = d.d_rnn;
  const int row0 = (blockIdx.x / CL) * NR;
  const int rows = min(NR, d.B - row0);
  // whether this block writes element i of a loop over kThreads-strided
  // elements that every block computes (turns of kThreads, round robin)
  auto mine = [&](int i) { return (i / kThreads) % CL == rank; };

  for (int i = threadIdx.x; i < NR; i += kThreads) dpc[i] = 0.f;
  for (int i = threadIdx.x; i < NR * NW; i += kThreads) dwc[i] = 0.f;
  for (int i = threadIdx.x; i < NR * 4; i += kThreads) dwhc[i] = 0.f;
  for (int i = threadIdx.x; i < NR * U; i += kThreads) {
    dhc[i] = 0.f;
    denc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < NR * C; i += kThreads) dcond[i] = 0.f;
  // every block of the cluster runs before any writes into its shared memory
  cluster_sync_all();

  for (int k = d.S - 1; k >= 0; --k) {
    const size_t slot = (size_t)k * d.B + row0;
    const float* res0 = p.res + slot * R;  // row r at res0 + r * R
    float* sc0 = p.scratch + slot * Z;     // row r at sc0 + r * Z
    __syncthreads();
    // the presence
    for (int r = threadIdx.x; r < NR; r += kThreads) {
      float dlraw = 0.f, part = 0.f;
      if (r < rows) {
        const size_t o = slot + r;
        const float prob = p.prob[o], lraw = res0[r * R + d.lraw];
        const float pprev = k > 0 ? p.pres[o - d.B] : 1.f;
        const float dpres = p.dpres[o] + dpc[r];
        const float dlogit = p.dlogit[o] + p.dprob[o] * prob * (1.f - prob);
        dlraw = dlogit * pprev;
        const float psamp = in.u[o] < prob ? 1.f : 0.f;
        part = dpres * psamp + dlogit * (lraw + 88.f);
        if (mine(r)) sc0[r * Z + s.dlraw] = dlraw;
      }
      dlr[r] = dlraw;
      dpt[r] = part;
    }
    __syncthreads();
    // the steps predictor on [h, what]
    for (int i = threadIdx.x; i < NR * d.SP; i += kThreads) {
      const int r = i / d.SP, j = i - r * d.SP;
      float v = 0.f;
      if (r < rows) {
        v = dlr[r] * w.sp2w[j] * act_grad_from_output(res0[r * R + d.s1 + j], kElu);
        if (mine(i)) sc0[r * Z + s.dsp1 + j] = v;
      }
      dsp1[r * L.ldsp + j] = v;
    }
    for (int i = threadIdx.x + rank * kThreads; i < rows * dsf; i += CL * kThreads) {
      const int r = i / dsf, j = i - r * dsf;
      sc0[r * Z + s.spf + j] = j < U ? res0[r * R + d.h + j] : p.what[(slot + r) * NW + j - U];
    }
    __syncthreads();
    {
      const TTerm t[1] = {{dsp1, L.ldsp, d.SP, w.sp1w}};
      cluster_dense_t<1>(t, dsf, pe, ring, parts,
                         [&](int r, int k2, float v, float) { pe.put(dspf + r * dsf + k2, v); });
    }

    // the what sample and the head
    for (int i = threadIdx.x; i < NR * NW; i += kThreads) {
      const int r = i / NW, j = i - r * NW;
      float vl = 0.f, vs = 0.f;
      if (r < rows) {
        const size_t o = (slot + r) * NW + j;
        const float dwt = (p.dwhat[o] + dwc[i]) + dspf[r * dsf + U + j];
        vl = dwt + p.dwhat_loc[o];
        const float dgsc = dwt * in.epsx[o] + p.dwhat_scale[o];
        vs = dgsc * (1.f - expf(-(p.what_scale[o] - kMinStd)));
        if (mine(i)) {
          sc0[r * Z + s.dhp + j] = vl;
          sc0[r * Z + s.dhp + NW + j] = vs;
        }
      }
      dhp[r * L.ldhp + j] = vl;
      dhp[r * L.ldhp + NW + j] = vs;
    }
    __syncthreads();

    // the glimpse encoder: dz2 = (dhp Wh^T) elu'(e2), dz1 = (dz2 We2^T)
    // elu'(e1), dg = dz1 We1^T (row r's to block r mod C)
    {
      const TTerm t[1] = {{dhp, L.ldhp, 2 * NW, w.wh}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        float dz = 0.f;
        if (r < rows) {
          dz = v * act_grad_from_output(res0[r * R + d.e2 + k2], kElu);
          sc0[r * Z + s.dz2 + k2] = dz;
        }
        pe.put(dz2 + r * L.ldu + k2, dz);
      });
    }
    {
      const TTerm t[1] = {{dz2, L.ldu, U, w.we2}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        float dz = 0.f;
        if (r < rows) {
          dz = v * act_grad_from_output(res0[r * R + d.e1 + k2], kElu);
          sc0[r * Z + s.dz1 + k2] = dz;
        }
        pe.put(dz1 + r * L.ldu + k2, dz);
      });
    }
    {
      const TTerm t[1] = {{dz1, L.ldu, U, w.we1}};
      cluster_dense_t<1>(t, G, pe, ring, parts, [&](int r, int k2, float v, float) {
        if (r < rows) pe.put_to(dg + r * L.ldg + k2, r % CL, v);
      });
    }

    // the crops of the block's rows r = rank + m C at the saved where, ng
    // side by side in the ring; their where-gradients go to every block
    {
      const int fl = round4(SparseCrop::floats(cd, true));
      const int nr = rank < rows ? (rows - rank + CL - 1) / CL : 0;
      int ng = 1;
      while (ng < nr && ng < kMaxCropGroups && 2 * ng * fl <= L.parts - L.ring) ng *= 2;
      const int nt = kThreads / ng, g = threadIdx.x / nt, t = threadIdx.x - g * nt;
      const SparseCrop sc(ring + g * fl, cd, true);
      for (int m0 = 0; m0 < nr; m0 += ng) {
        const int m = m0 + g;
        const bool active = m < nr;
        const int r = active ? rank + m * CL : 0;
        const float* frame = in.img + (size_t)(row0 + r) * d.HW;
        float c[4];
        sparse_crop_setup(frame, p.where + (slot + r) * 4, cd, sc, c, active, t, nt);
        sparse_crop_bwd(frame, cd, sc, c, dg + r * L.ldg, dwl + r * 4, active, t, nt);
        __syncthreads();  // the next rows reuse the scratch
      }
      for (int i = threadIdx.x; i < nr * 4; i += kThreads) {
        const int r = rank + (i >> 2) * CL, j = i & 3;
        pe.put(dwl + r * 4 + j, dwl[r * 4 + j]);
      }
      for (int i = threadIdx.x; i < (NR - rows) * 4; i += kThreads) dwl[rows * 4 + i] = 0.f;
      cluster_sync_all();  // every row's where-gradient is in every block
    }
    keep_crop_grad<NR>(dwl, p.crop_keep, slot, rows);

    // the where sample and the transform estimator
    for (int i = threadIdx.x; i < NR * 4; i += kThreads) {
      const int r = i / 4, j = i - r * 4;
      float dloc = 0.f, dsc = 0.f;
      if (r < rows) {
        const size_t o = (slot + r) * 4 + j;
        const float dwt = (p.dwhere[o] + dwhc[i]) + dwl[i];
        dloc = dwt + p.dwhere_loc[o];
        const float dwscale = dwt * in.epsw[o] + p.dwhere_scale[o];
        dsc = dwscale * (1.f - expf(-(p.where_scale[o] - kMinStd)));
        if (mine(i)) {
          sc0[r * Z + s.dstp8 + j] = dloc;
          sc0[r * Z + s.dstp8 + 4 + j] = dsc;
        }
      }
      dst8[r * 8 + j] = dloc;
      dst8[r * 8 + 4 + j] = dsc;
    }
    __syncthreads();
    {
      const TTerm t[1] = {{dst8, 8, 8, w.s3w}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        float dz = 0.f;
        if (r < rows) {
          dz = v * act_grad_from_output(res0[r * R + d.a2 + k2], kElu);
          sc0[r * Z + s.dza2 + k2] = dz;
        }
        pe.put(dza2 + r * L.ldu + k2, dz);
      });
    }
    {
      const TTerm t[1] = {{dza2, L.ldu, U, w.s2w}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        float dz = 0.f;
        if (r < rows) {
          dz = v * act_grad_from_output(res0[r * R + d.a1 + k2], kElu);
          sc0[r * Z + s.dza1 + k2] = dz;
        }
        pe.put(dza1 + r * L.ldu + k2, dz);
      });
    }
    {
      const TTerm t[1] = {{dza1, L.ldu, U, w.s1w}};
      cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
        pe.put(dspf + r * dsf + k2, dspf[r * dsf + k2] + v);
      });
    }

    // the transition
    for (int i = threadIdx.x; i < NR * U; i += kThreads) {
      const int r = i / U, j = i - r * U;
      float v = 0.f;
      if (r < rows) {
        const float h = res0[r * R + d.h + j];
        v = (dspf[r * dsf + j] + dhc[i]) * (1.f - h * h);
        if (mine(i)) {
          sc0[r * Z + s.dzr + j] = v;
          sc0[r * Z + s.hprev + j] = k > 0 ? res0[r * R - (ptrdiff_t)d.B * R + d.h + j]
                                           : in.h0b[(size_t)(row0 + r) * U + j];
        }
      }
      dzr[r * L.ldu + j] = v;
    }
    for (int i = threadIdx.x + rank * kThreads; i < rows * drn; i += CL * kThreads) {
      const int r = i / drn, j = i - r * drn;
      const size_t row = (size_t)row0 + r, prev = slot + r - d.B;
      float v;
      if (j < U) {
        v = p.fres[row * 2 * U + U + j];
      } else if (j < U + C) {
        v = in.cond[row * C + j - U];
      } else if (j < U + C + NW) {
        v = k > 0 ? p.what[prev * NW + j - U - C] : 0.f;
      } else if (j < U + C + NW + 4) {
        v = k > 0 ? p.where[prev * 4 + j - U - C - NW] : 0.f;
      } else {
        v = k > 0 ? p.pres[prev] : 1.f;
      }
      sc0[r * Z + s.rnn_in + j] = v;
    }
    __syncthreads();
    {
      const TTerm t[1] = {{dzr, L.ldu, U, w.rw}};
      cluster_dense_t<1>(t, drn, pe, ring, parts, [&](int r, int k2, float v, float) {
        pe.put(drnn + r * L.ldrnn + k2, v);
      });
    }
    {
      const TTerm t[1] = {{dzr, L.ldu, U, w.ru}};
      cluster_dense_t<1>(t, U, pe, ring, parts,
                         [&](int r, int k2, float v, float) { pe.put(dhc + r * U + k2, v); });
    }
    for (int i = threadIdx.x; i < NR * drn; i += kThreads) {
      const int r = i / drn, j = i - r * drn;
      const float v = drnn[r * L.ldrnn + j];
      if (j < U) {
        denc[r * U + j] += v;
      } else if (j < U + C) {
        dcond[r * C + j - U] += v;
      } else if (j < U + C + NW) {
        dwc[r * NW + j - U - C] = v;
      } else if (j < U + C + NW + 4) {
        dwhc[r * 4 + j - U - C - NW] = v;
      } else {
        dpc[r] = dpt[r] + v;
      }
    }
  }
  __syncthreads();

  // the input encoder: dz2 = d enc elu'(enc), dz1 = (dz2 Wi2^T) elu'(ench1)
  float* dz2e = p.scratch + (size_t)d.S * d.B * Z;
  float* dz1e = dz2e + (size_t)d.B * U;
  for (int i = threadIdx.x; i < NR * U; i += kThreads) {
    const int r = i / U, j = i - r * U;
    float v = 0.f;
    if (r < rows) {
      const size_t o = (size_t)(row0 + r) * U + j;
      v = denc[i] * act_grad_from_output(p.fres[(size_t)(row0 + r) * 2 * U + U + j], kElu);
      if (mine(i)) dz2e[o] = v;
    }
    dz2[r * L.ldu + j] = v;
  }
  __syncthreads();
  {
    const TTerm t[1] = {{dz2, L.ldu, U, w.wi2}};
    cluster_dense_t<1>(t, U, pe, ring, parts, [&](int r, int k2, float v, float) {
      if (r < rows)
        dz1e[(size_t)(row0 + r) * U + k2] =
            v * act_grad_from_output(p.fres[(size_t)(row0 + r) * 2 * U + k2], kElu);
    });
  }
  for (int i = threadIdx.x + rank * kThreads; i < rows * C; i += CL * kThreads)
    p.dcond[(size_t)row0 * C + i] = dcond[i];
  for (int i = threadIdx.x + rank * kThreads; i < rows * U; i += CL * kThreads)
    p.dh0[(size_t)row0 * U + i] = dhc[i];
}

}  // namespace sqair

// The forward.  ptrs holds, in order: img [B, H, W], imgf [B, H W] (the
// same frames flat), cond [B, C], h0 [B, U], eps_w [S, B, 4], eps_x
// [S, B, nw], u [S, B, 1]; the 23 weights in the order of
// `_disc_weights_flat` (the estimator's last bias with the scale offset
// folded in; We1 [gh gw, U]); then the outputs what, what_loc, what_scale
// [S, B, nw], where, where_loc, where_scale [S, B, 4], prob, presence,
// logit [S, B, 1], the residual rows [S, B, R], the glimpses [S, B, gh gw]
// and the input encoder's layers [B, 2U].  dims is {B, S, H, W, gh, gw, nw,
// U, SP, C}.  `geom` is the host's launch geometry (ops/fused_cells.py
// disc_fwd_geometry): the slots' tile rows, cluster size and blocks, then
// the input encoder's (ops/fused.py mlp_fwd_geometry of B rows, [H W, U,
// U]): tile rows, cluster size, blocks, dynamic shared memory bytes and
// each layer's K-blocks a round; the launches are refused unless they
// match this file's tiles and fused_mlp.cu's, or the tile's state
// (disc_fwd_smem) does not fit a block's 227 KB.  All f32, contiguous and
// on the device; ptrs, dims and geom are host arrays.  Launches the input
// encoder, then the slots, on `stream`; does not synchronise, allocates
// nothing, and returns the CUDA error code of the launches (0 on success).
extern "C" int sqair_fused_disc(void* const* ptrs, const int* dims, const int* geom,
                                void* stream) {
  using namespace sqair;
  DiscFwdArgs p{};
  if (!read_disc_dims(dims, p.d)) return (int)cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  p.in = read_disc_inputs(f);
  p.w = read_disc_weights(f + 7);
  float* const* o = reinterpret_cast<float* const*>(ptrs + 7 + kDiscWeights);
  p.what = o[0]; p.what_loc = o[1]; p.what_scale = o[2];
  p.where = o[3]; p.where_loc = o[4]; p.where_scale = o[5];
  p.prob = o[6]; p.pres = o[7]; p.logit = o[8];
  p.res = o[9]; p.g0s = o[10]; p.fres = o[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cluster = geom[1];
  const int tiles = cdiv(p.d.B, kTileRows);
  const size_t smem = sizeof(float) * (size_t)disc_fwd_smem(p.d).total;
  if (geom[0] != kTileRows || cluster < 1 || cluster > kMaxCluster ||
      geom[2] != tiles * cluster || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;

  // the input encoder, both layers into fres [B, 2U]
  const int U = p.d.U;
  const int enc_dims[3] = {p.d.HW, U, U};
  const int enc_acts[2] = {kElu, kElu};
  const float* enc_w[2] = {p.w.wi1, p.w.wi2};
  const float* enc_b[2] = {p.w.bi1, p.w.bi2};
  float* enc_saved[2] = {p.fres, nullptr};
  cudaError_t err = launch_mlp_fwd(p.in.imgf, p.fres + U, p.d.B, 2, enc_dims, enc_acts, enc_w,
                                   enc_b, enc_saved, 2 * U, geom + 3, s);
  if (err != cudaSuccess) return (int)err;

  err = allow_smem(disc_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(disc_fwd_kernel, p, tiles * cluster, cluster, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The floats of the backward's scratch (S B row-slots of DiscScratch, then
// the input encoder's dz2 and dz1 [B, U] each) for the forward's dims; -1
// where the dims are refused.
extern "C" int sqair_fused_disc_scratch_floats(const int* dims) {
  sqair::DiscDims d;
  if (!sqair::read_disc_dims(dims, d)) return -1;
  return d.S * d.B * d.Z + 2 * d.B * d.U;
}

// The backward.  ptrs holds, in order: the forward's 7 inputs and 23
// weights; the saved what, what_scale, where, where_scale, prob and
// presence, the residual rows, the glimpses and the input encoder's
// layers; the gradients of the nine outputs (in the forward's order); then
// the outputs d cond, d h0 and the 23 weights' gradients (in their order);
// then the scratch, as sqair_fused_disc_scratch_floats sizes it, and a
// factor [S, B] on each row-slot's where-gradient through the crop, or
// null (none).  dims is the forward's.  `geom` is the host's launch
// geometry of phase A (ops/fused_cells.py disc_bwd_geometry): tile rows,
// cluster size and blocks; the launch is refused unless they match this
// file's tiles, or the tile's state (disc_bwd_smem) does not fit a block's
// 227 KB.  Launches phase A and phase B (twice).
extern "C" int sqair_fused_disc_bwd(void* const* ptrs, const int* dims, const int* geom,
                                    void* stream) {
  using namespace sqair;
  DiscBwdArgs p{};
  if (!read_disc_dims(dims, p.d)) return (int)cudaErrorInvalidValue;
  p.sc = disc_scratch(p.d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  p.in = read_disc_inputs(f);
  p.w = read_disc_weights(f + 7);
  const float* const* sv = f + 7 + kDiscWeights;
  p.what = sv[0]; p.what_scale = sv[1]; p.where = sv[2]; p.where_scale = sv[3];
  p.prob = sv[4]; p.pres = sv[5]; p.res = sv[6]; p.g0s = sv[7]; p.fres = sv[8];
  const float* const* g = sv + 9;
  p.dwhat = g[0]; p.dwhat_loc = g[1]; p.dwhat_scale = g[2];
  p.dwhere = g[3]; p.dwhere_loc = g[4]; p.dwhere_scale = g[5];
  p.dprob = g[6]; p.dpres = g[7]; p.dlogit = g[8];
  float* const* o = reinterpret_cast<float* const*>(ptrs + 7 + kDiscWeights + 18);
  p.dcond = o[0]; p.dh0 = o[1];
  float* const* dw = o + 2;
  p.scratch = o[2 + kDiscWeights];
  p.crop_keep = o[3 + kDiscWeights];

  const int cluster = geom[1];
  const int tiles = cdiv(p.d.B, kTileRows);
  const size_t smem = sizeof(float) * (size_t)disc_bwd_smem(p.d).total;
  if (geom[0] != kTileRows || cluster < 1 || cluster > kMaxCluster ||
      geom[2] != tiles * cluster || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(disc_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_cluster(disc_bwd_kernel, p, tiles * cluster, cluster, smem, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // phase B: the slot layers' weight gradients over the S B row-slots,
  // then the input encoder's over the B rows, each in fixed order
  const DiscDims& d = p.d;
  const DiscScratch& c = p.sc;
  const float* res = p.res;
  const float* sc = p.scratch;
  const int R = d.R, Z = c.Z, U = d.U;
  OuterArgs q{};
  int n = 0;
  auto job = [&](const float* a, int lda, const float* dz, int ldz, int wi, bool bias, int K,
                 int J) {
    OuterJob& jb = q.job[n++];
    jb = OuterJob{a, dz, dw[wi], bias ? dw[wi + 1] : nullptr, lda, ldz, K, J};
  };
  // weight indices in `_disc_weights_flat` order (the bias follows its matrix)
  q.n = d.S * d.B;
  job(sc + c.rnn_in, Z, sc + c.dzr, Z, 4, false, d.d_rnn, U);    // rw
  q.job[n - 1].db = dw[6];                                        // rb
  job(sc + c.hprev, Z, sc + c.dzr, Z, 5, false, U, U);           // ru
  job(res + d.h, R, sc + c.dza1, Z, 7, true, U, U);              // s1
  job(res + d.a1, R, sc + c.dza2, Z, 9, true, U, U);             // s2
  job(res + d.a2, R, sc + c.dstp8, Z, 11, true, U, 8);           // s3
  job(p.g0s, d.G, sc + c.dz1, Z, 13, true, d.G, U);              // we1
  job(res + d.e1, R, sc + c.dz2, Z, 15, true, U, U);             // we2
  job(res + d.e2, R, sc + c.dhp, Z, 17, true, U, 2 * d.nw);      // wh
  job(sc + c.spf, Z, sc + c.dsp1, Z, 19, true, d.d_spf, d.SP);   // sp1
  job(res + d.s1, R, sc + c.dlraw, Z, 21, true, d.SP, 1);        // sp2
  q.n_jobs = n;
  err = launch_tiles(q, s);
  if (err != cudaSuccess) return (int)err;

  const float* dz2e = sc + (size_t)d.S * d.B * Z;
  const float* dz1e = dz2e + (size_t)d.B * U;
  q = OuterArgs{};
  n = 0;
  q.n = d.B;
  job(p.in.imgf, d.HW, dz1e, U, 0, true, d.HW, U);  // wi1
  job(p.fres, 2 * U, dz2e, U, 2, true, U, U);       // wi2 (on ench1, fres[:, :U])
  q.n_jobs = n;
  return (int)launch_tiles(q, s);
}
