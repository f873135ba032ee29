"""The fused discovery and propagation unrolls of one frame, forward and
backward, with their plain versions.

The port of ``sqair_tpu/ops/fused_cells.py``: all S slots of the
DiscoveryCore (``csrc/fused_disc.cu``) or of the PropagationCore
(``csrc/fused_prop.cu``) for one frame as one kernel forward and one
backward.

Discovery, once per frame enc = elu(elu(img Wi1 + bi1) Wi2 + bi2), then per
slot k, with the previous slot's (what, where, presence) (0, 0, 1 at k = 0):

  h = tanh([enc, cond, what_{k-1}, where_{k-1}, pres_{k-1}] W + h U + b)
  a = MLP(h) (elu, elu, id) -> 8; where_loc = a[:4]
  where_scale = softplus(a[4:]) + 1e-2; where = where_loc + where_scale eps_w
  what_loc, what_scale = head(encode(crop(img, where)))   # unmasked
  what = what_loc + what_scale eps_x
  logit = pres_{k-1} MLP([h, what]) + (pres_{k-1} - 1) 88
  presence = (u < sigmoid(logit)) pres_{k-1}

Propagation, per slot k, with the previous frame's (what, where, presence)
of the object and its temporal state ht:

  gwl = where_tm1 + (elu(ht Wb1 + bb1) Wb2 + bb2) 0.1     # where bias
  mask = sigmoid(elu(ht Wm1 + bm1) Wm2 + bm2)             # one per slot
  g1loc = head(encode(crop(img, gwl) * mask))[:n_what]
  h = tanh([g1loc, what_{k-1}, where_{k-1}, pres_{k-1}, what_tm1,
            where_tm1, pres_tm1, ht] W + h U + b)         # explaining away
  a = MLP([h, where_tm1, ht]) (elu, elu, id) -> 8
  where_loc = where_tm1 + a[:4]; where_scale = softplus(a[4:]) + 1e-2
  where = where_loc + where_scale (eps_w tril^T + eps_w)
  g2loc, g2scale = head(encode(crop(img, where) * mask))
  ht' = GRU([h, where, g2loc, g2scale], ht)
  tloc, tscale = Dense(ht'); f, i, t = sigmoid(ht' Wg + bg) 0.9999
  what_loc = f what_tm1 + (1 - i) g2loc + (1 - t) tloc
  what_scale = (1 - i) g2scale + (1 - t) tscale; what = loc + scale eps_x
  logit = pres_tm1 MLP([h, ht, what]) + (pres_tm1 - 1) 88
  presence = (u < sigmoid(logit)) pres_tm1

The noise (eps_w, eps_x, u) comes in from outside and gets no gradient;
``img`` gets none either.  The estimator's scale offset is folded into its
last bias by ``fused_disc_ssm`` (as is) and ``fused_prop_ssm`` (minus one),
as the JAX package does.  Each forward writes every activation its backward
needs into one residual blob [S, B, R] (``disc_residual_layout``,
``residual_layout``; the JAX package's fields in its order, without its
128-lane padding); discovery also keeps its glimpses [S, B, gh gw] and the
input encoder's two layers [B, 2U].

On a CUDA tensor a wrapper launches the kernels or raises; on a CPU tensor
it runs the plain versions here, which follow the JAX package's
``_disc_fwd_kernel`` / ``_disc_bwd_kernel`` / ``_prop_fwd_kernel`` /
``_prop_bwd_kernel`` step by step (elu' read off the output, 1 at 0, as its
``_delu``).  ``launches["fused_disc"]``, ``launches["fused_disc_bwd"]``,
``launches["fused_prop"]`` and ``launches["fused_prop_bwd"]`` count the
calls that launched a kernel, in the counter of ``ops/fused.py``.

The model takes these paths only when ``SQAIR_FUSE_CELLS`` is set
(``enabled``) and the JAX package's gates are met (``models/discover.py``,
``models/propagate.py``).
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Tuple

import torch

from . import fused as _fused
from .fused import (_cdiv, _check, _empty, _ints, _needs_grad, _on_cuda, _ptrs, _raise_on,
                    _stream, launches)
from .fused_glimpse import MIN_STD, _delu, _elu, _softplus, crop_plain, crop_plain_bwd


def enabled() -> bool:
    """The JAX package's switch: any non-empty ``SQAIR_FUSE_CELLS``."""
    return bool(os.environ.get("SQAIR_FUSE_CELLS"))


class PropParams(NamedTuple):
    """The propagation core's raw weights, as the JAX package's PropParams."""
    wb: Tuple  # ((W, b), (W, b)) where-bias MLP, elu id
    mask: Tuple  # ((W, b), (W, b)) glimpse mask MLP, elu sigmoid
    ge_enc: Tuple  # ((W, b), (W, b)) glimpse encoder, elu elu; W_1 [gh gw, U]
    ge_head: Tuple  # (W, b) Gaussian head
    rnn: Tuple  # (W, U, b) VanillaRNN
    stp: Tuple  # ((W, b), (W, b), (W, b)) transform estimator, elu elu id
    stp_offset: torch.Tensor  # scalar scale offset
    tril: torch.Tensor  # [4, 4] lower-triangular AffineDiagNormal matrix
    gru: Tuple  # (Wg, Ug, bg, Wc, Uc, bc) temporal GRU
    td: Tuple  # (W, b) temporal what-distribution Dense
    gates: Tuple  # (W, b) 3-gate sigmoid head
    sp: Tuple  # ((W, b), (W, b)) steps predictor, elu id


OUT_FIELDS = ("what", "what_loc", "what_scale", "where", "where_loc", "where_scale",
              "presence_prob", "presence", "presence_logit", "temporal_h")
# the weights in the kernels' order (``weights_flat``)
WEIGHT_NAMES = ("wb1w", "wb1b", "wb2w", "wb2b", "m1w", "m1b", "m2w", "m2b", "we1", "be1", "we2",
                "be2", "wh", "bh", "rw", "ru", "rb", "s1w", "s1b", "s2w", "s2b", "s3w", "s3b",
                "tril", "gwg", "gug", "gbg", "gwc", "guc", "gbc", "tdw", "tdb", "gaw", "gab",
                "sp1w", "sp1b", "sp2w", "sp2b")
N_WEIGHTS = len(WEIGHT_NAMES)


def residual_layout(dims) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """({field: (start, end)}, R) of one slot's residual row, for ``dims``
    (S, gh, gw, n_what, U, SP, WB, MH)."""
    S, gh, gw, NW, U, SP, WB, MH = dims
    fields = (("wbh", WB), ("maskh", MH), ("mask", gh * gw), ("e11", U), ("e12", U),
              ("g1loc", NW), ("h", U), ("a1", U), ("a2", U), ("e21", U), ("e22", U),
              ("g2loc", NW), ("g2sc", NW), ("zr", 2 * U), ("c", U), ("tloc", NW),
              ("tsc", NW), ("gates", 3 * NW), ("s1", SP), ("lraw", 1), ("gwl", 4))
    off, out = 0, {}
    for name, d in fields:
        out[name] = (off, off + d)
        off += d
    return out, off


def weights_flat(p: PropParams):
    """The 38 weights in the kernels' order (the JAX package's
    ``_prop_weights_flat``)."""
    (wb1w, wb1b), (wb2w, wb2b) = p.wb
    (m1w, m1b), (m2w, m2b) = p.mask
    (we1, be1), (we2, be2) = p.ge_enc
    wh, bh = p.ge_head
    rw, ru, rb = p.rnn
    (s1w, s1b), (s2w, s2b), (s3w, s3b) = p.stp
    gwg, gug, gbg, gwc, guc, gbc = p.gru
    tdw, tdb = p.td
    gaw, gab = p.gates
    (sp1w, sp1b), (sp2w, sp2b) = p.sp
    return (wb1w, wb1b, wb2w, wb2b, m1w, m1b, m2w, m2b, we1, be1, we2, be2, wh, bh, rw, ru,
            rb, s1w, s1b, s2w, s2b, s3w, s3b, p.tril, gwg, gug, gbg, gwc, guc, gbc, tdw, tdb,
            gaw, gab, sp1w, sp1b, sp2w, sp2b)


# ------------------------------------------------------------ plain versions
def prop_plain_fwd(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, dims):
    """The forward in the kernel's order: the ten outputs of ``OUT_FIELDS``,
    each [S, B, d], and the residual blob [S, B, R].

    :param wt1, wh1, p1, th: what, where, presence and temporal state of
        the previous frame, slot-major [S, B, d]
    :param h0b: [B, U] initial transition state
    :param weights: ``weights_flat`` with the scale offset folded
    :param dims: (S, gh, gw, n_what, U, SP, WB, MH)
    """
    S, gh, gw, nw, U = dims[:5]
    (wb1w, wb1b, wb2w, wb2b, m1w, m1b, m2w, m2b, we1, be1, we2, be2, wh, bh, rw, ru, rb,
     s1w, s1b, s2w, s2b, s3w, s3b, tril, gwg, gug, gbg, gwc, guc, gbc, tdw, tdb, gaw, gab,
     sp1w, sp1b, sp2w, sp2b) = weights
    B = img.shape[0]
    sw, swh, sp_, h = img.new_zeros(B, nw), img.new_zeros(B, 4), img.new_zeros(B, 1), h0b
    outs = [[] for _ in OUT_FIELDS]
    res = []
    for k in range(S):
        wt, whk, pk, ht = wt1[k], wh1[k], p1[k], th[k]
        wbh = _elu(ht @ wb1w + wb1b)
        gwl = whk + (wbh @ wb2w + wb2b) * 0.1
        maskh = _elu(ht @ m1w + m1b)
        mask = torch.sigmoid(maskh @ m2w + m2b)

        def encode(wl):
            g = crop_plain(img, wl, gh, gw).reshape(B, gh * gw) * mask
            e1 = _elu(g @ we1 + be1)
            e2 = _elu(e1 @ we2 + be2)
            return e1, e2, e2 @ wh + bh

        e11, e12, hp1 = encode(gwl)
        g1loc = hp1[:, :nw]
        rnn_in = torch.cat([g1loc, sw, swh, sp_, wt, whk, pk, ht], -1)
        h = torch.tanh(rnn_in @ rw + h @ ru + rb)
        a1 = _elu(torch.cat([h, whk, ht], -1) @ s1w + s1b)
        a2 = _elu(a1 @ s2w + s2b)
        stp8 = a2 @ s3w + s3b
        wloc = whk + stp8[:, :4]
        wscale = _softplus(stp8[:, 4:]) + MIN_STD
        ew = eps_w[k]
        where = wloc + wscale * (ew @ tril.T + ew)

        e21, e22, hp2 = encode(where)
        g2loc = hp2[:, :nw]
        g2sc = _softplus(hp2[:, nw:]) + MIN_STD
        tin = torch.cat([h, where, g2loc, g2sc], -1)
        zr = torch.sigmoid(tin @ gwg + ht @ gug + gbg)
        z_g, r_g = zr[:, :U], zr[:, U:]
        c = torch.tanh(tin @ gwc + (r_g * ht) @ guc + gbc)
        ht_new = (1.0 - z_g) * ht + z_g * c
        td = ht_new @ tdw + tdb
        tloc, tsc = td[:, :nw], _softplus(td[:, nw:]) + MIN_STD
        gates = torch.sigmoid(ht_new @ gaw + gab) * 0.9999
        f_g, i_g, t_g = gates[:, :nw], gates[:, nw:2 * nw], gates[:, 2 * nw:]
        what_loc = f_g * wt + (1.0 - i_g) * g2loc + (1.0 - t_g) * tloc
        what_scale = (1.0 - i_g) * g2sc + (1.0 - t_g) * tsc
        what = what_loc + what_scale * eps_x[k]

        # the steps predictor reads the OLD temporal state
        sp1 = _elu(torch.cat([h, ht, what], -1) @ sp1w + sp1b)
        lraw = sp1 @ sp2w + sp2b
        logit = pk * lraw + (pk - 1.0) * 88.0
        prob = torch.sigmoid(logit)
        pres = (u[k] < prob).to(img.dtype) * pk

        for lst, v in zip(outs, (what, what_loc, what_scale, where, wloc, wscale, prob, pres,
                                 logit, ht_new)):
            lst.append(v)
        res.append(torch.cat([wbh, maskh, mask, e11, e12, g1loc, h, a1, a2, e21, e22, g2loc,
                              g2sc, zr, c, tloc, tsc, gates, sp1, lraw, gwl], -1))
        sw, swh, sp_ = what, where, pres
    return tuple(torch.stack(v, 0) for v in outs) + (torch.stack(res, 0),)


def prop_plain_bwd(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, saved, res, cots,
                   dims, crop_keep=None):
    """The JAX package's ``_prop_bwd_kernel`` as tensor ops: (dwt1, dwh1, dp1,
    dth, dh0b) and the 38 weights' gradients in ``weights_flat`` order (the
    biases of the layers whose gradient is the same as their pre-activation's
    included; dtril is the full [4, 4] product).

    :param saved: (what, what_scale, where, where_scale, prob, presence,
        temporal_h) of the forward
    :param cots: the ten outputs' gradients, in ``OUT_FIELDS`` order
    :param crop_keep: None, or [S, B] factors on each row-slot's
        where-gradients through its two crops (0 cuts a kink of the step's
        gradient out when two runs are compared)
    """
    S, gh, gw, nw, U, SP, WB, MH = dims
    (wb1w, _, wb2w, _, m1w, _, m2w, _, we1, _, we2, _, wh, _, rw, ru, _,
     s1w, _, s2w, _, s3w, _, tril, gwg, gug, _, gwc, guc, _, tdw, _, gaw, _,
     sp1w, _, sp2w, _) = weights
    what_o, whatsc_o, where_o, wheresc_o, prob_o, pres_o, tnew_o = saved
    (dwhat_c, dwhatloc_c, dwhatsc_c, dwhere_c, dwhereloc_c, dwheresc_c, dprob_c, dpres_c,
     dlogit_c, dtnew_c) = cots
    B = img.shape[0]
    G = gh * gw
    offs, _ = residual_layout(dims)
    acc = {}

    def add(name, val):
        acc[name] = val if name not in acc else acc[name] + val

    def r(name, k):
        a, b = offs[name]
        return res[k, :, a:b]

    def glimpse_bwd(k, wl, e1, e2, dhp, mask):
        """The head, encoder and crop backward of one glimpse: (dwl, dmask)."""
        add("dwh", e2.T @ dhp)
        add("dbh", torch.sum(dhp, 0))
        dz2 = (dhp @ wh.T) * _delu(e2)
        add("dwe2", e1.T @ dz2)
        add("dbe2", torch.sum(dz2, 0))
        dz1 = (dz2 @ we2.T) * _delu(e1)
        g0 = crop_plain(img, wl, gh, gw).reshape(B, G)
        add("dwe1", (g0 * mask).T @ dz1)
        add("dbe1", torch.sum(dz1, 0))
        dg = dz1 @ we1.T
        return crop_plain_bwd(img, wl, (dg * mask).reshape(B, gh, gw)), dg * g0

    zeros = img.new_zeros
    d_sw, d_swh, d_sp, d_h_c = zeros(B, nw), zeros(B, 4), zeros(B, 1), zeros(B, U)
    dwt1, dwh1, dp1, dth = [None] * S, [None] * S, [None] * S, [None] * S
    for k in range(S - 1, -1, -1):
        wt, whk, pk, ht = wt1[k], wh1[k], p1[k], th[k]
        h, mask, gwl = r("h", k), r("mask", k), r("gwl", k)
        prob, what, where = prob_o[k], what_o[k], where_o[k]
        wscale, ht_new = wheresc_o[k], tnew_o[k]
        g2loc, g2sc, tloc, tsc = r("g2loc", k), r("g2sc", k), r("tloc", k), r("tsc", k)
        gates, lraw = r("gates", k), r("lraw", k)

        # presence
        d_pres_tot = dpres_c[k] + d_sp
        dlogit = dlogit_c[k] + dprob_c[k] * prob * (1.0 - prob)
        dlraw = dlogit * pk
        psamp = (u[k] < prob).to(img.dtype)
        d_p1 = d_pres_tot * psamp + dlogit * (lraw + 88.0)

        # steps predictor on [h, ht (old), what]
        sp1 = r("s1", k)
        dsp1z = (dlraw @ sp2w.T) * _delu(sp1)
        add("dsp2w", sp1.T @ dlraw)
        add("dsp2b", torch.sum(dlraw, 0))
        add("dsp1w", torch.cat([h, ht, what], -1).T @ dsp1z)
        add("dsp1b", torch.sum(dsp1z, 0))
        dspfeat = dsp1z @ sp1w.T
        dh_acc = dspfeat[:, :U]
        d_ht = dspfeat[:, U:2 * U]
        dwhat_sp = dspfeat[:, 2 * U:]

        # what fusion and gates
        d_what_tot = dwhat_c[k] + d_sw + dwhat_sp
        dwl_tot = d_what_tot + dwhatloc_c[k]
        dws_tot = d_what_tot * eps_x[k] + dwhatsc_c[k]
        f_g, i_g, t_g = gates[:, :nw], gates[:, nw:2 * nw], gates[:, 2 * nw:]
        d_f = dwl_tot * wt
        d_i = -(dwl_tot * g2loc + dws_tot * g2sc)
        d_t = -(dwl_tot * tloc + dws_tot * tsc)
        d_wt1 = dwl_tot * f_g
        d_g2loc = dwl_tot * (1.0 - i_g)
        d_g2sc = dws_tot * (1.0 - i_g)
        d_tloc = dwl_tot * (1.0 - t_g)
        d_tsc = dws_tot * (1.0 - t_g)
        sg = gates * (1.0 / 0.9999)
        dz_gates = torch.cat([d_f, d_i, d_t], -1) * 0.9999 * sg * (1.0 - sg)
        add("dgaw", ht_new.T @ dz_gates)
        add("dgab", torch.sum(dz_gates, 0))
        d_ht_new = dtnew_c[k] + dz_gates @ gaw.T
        dtd = torch.cat([d_tloc, d_tsc * (1.0 - torch.exp(-(tsc - MIN_STD)))], -1)
        add("dtdw", ht_new.T @ dtd)
        add("dtdb", torch.sum(dtd, 0))
        d_ht_new = d_ht_new + dtd @ tdw.T

        # temporal GRU
        zr, c = r("zr", k), r("c", k)
        z_g, r_g = zr[:, :U], zr[:, U:]
        tin = torch.cat([h, where, g2loc, g2sc], -1)
        dz_g = d_ht_new * (c - ht)
        dc_in = (d_ht_new * z_g) * (1.0 - c * c)
        drh = dc_in @ guc.T
        da = torch.cat([dz_g, drh * ht], -1) * zr * (1.0 - zr)
        add("dgwc", tin.T @ dc_in)
        add("dguc", (r_g * ht).T @ dc_in)
        add("dgbc", torch.sum(dc_in, 0))
        add("dgwg", tin.T @ da)
        add("dgug", ht.T @ da)
        add("dgbg", torch.sum(da, 0))
        dtin = dc_in @ gwc.T + da @ gwg.T
        d_ht = d_ht + d_ht_new * (1.0 - z_g) + drh * r_g + da @ gug.T
        dh_acc = dh_acc + dtin[:, :U]
        d_where_tin = dtin[:, U:U + 4]
        d_g2loc = d_g2loc + dtin[:, U + 4:U + 4 + nw]
        d_g2sc = d_g2sc + dtin[:, U + 4 + nw:]

        # glimpse 2
        dhp2 = torch.cat([d_g2loc, d_g2sc * (1.0 - torch.exp(-(g2sc - MIN_STD)))], -1)
        dwl2, dmask = glimpse_bwd(k, where, r("e21", k), r("e22", k), dhp2, mask)
        if crop_keep is not None:
            dwl2 = dwl2 * crop_keep[k][:, None]

        # where sample and the transform estimator
        d_where_tot = dwhere_c[k] + d_swh + d_where_tin + dwl2
        dwloc = d_where_tot + dwhereloc_c[k]
        ew = eps_w[k]
        dwscale = d_where_tot * (ew @ tril.T + ew) + dwheresc_c[k]
        add("dtril", (d_where_tot * wscale).T @ ew)
        d_wh1 = dwloc
        a1, a2 = r("a1", k), r("a2", k)
        dstp8 = torch.cat([dwloc, dwscale * (1.0 - torch.exp(-(wscale - MIN_STD)))], -1)
        add("ds3w", a2.T @ dstp8)
        add("ds3b", torch.sum(dstp8, 0))
        dz_a2 = (dstp8 @ s3w.T) * _delu(a2)
        add("ds2w", a1.T @ dz_a2)
        add("ds2b", torch.sum(dz_a2, 0))
        dz_a1 = (dz_a2 @ s2w.T) * _delu(a1)
        add("ds1w", torch.cat([h, whk, ht], -1).T @ dz_a1)
        add("ds1b", torch.sum(dz_a1, 0))
        dstp_in = dz_a1 @ s1w.T
        dh_acc = dh_acc + dstp_in[:, :U]
        d_wh1 = d_wh1 + dstp_in[:, U:U + 4]
        d_ht = d_ht + dstp_in[:, U + 4:]

        # transition RNN
        dz = (dh_acc + d_h_c) * (1.0 - h * h)
        if k > 0:
            sw_p, swh_p, sp_p, h_p = what_o[k - 1], where_o[k - 1], pres_o[k - 1], r("h", k - 1)
        else:
            sw_p, swh_p, sp_p, h_p = zeros(B, nw), zeros(B, 4), zeros(B, 1), h0b
        rnn_in = torch.cat([r("g1loc", k), sw_p, swh_p, sp_p, wt, whk, pk, ht], -1)
        add("drw", rnn_in.T @ dz)
        add("dru", h_p.T @ dz)
        add("drb", torch.sum(dz, 0))
        drnn_in = dz @ rw.T
        d_h_c = dz @ ru.T
        d_g1loc = drnn_in[:, :nw]
        d_sw = drnn_in[:, nw:2 * nw]
        d_swh = drnn_in[:, 2 * nw:2 * nw + 4]
        d_sp = drnn_in[:, 2 * nw + 4:2 * nw + 5]
        d_wt1 = d_wt1 + drnn_in[:, 2 * nw + 5:3 * nw + 5]
        d_wh1 = d_wh1 + drnn_in[:, 3 * nw + 5:3 * nw + 9]
        d_p1 = d_p1 + drnn_in[:, 3 * nw + 9:3 * nw + 10]
        d_ht = d_ht + drnn_in[:, 3 * nw + 10:]

        # glimpse 1 (its scale feeds nothing)
        dhp1 = torch.cat([d_g1loc, zeros(B, nw)], -1)
        dwl1, dmask1 = glimpse_bwd(k, gwl, r("e11", k), r("e12", k), dhp1, mask)
        if crop_keep is not None:
            dwl1 = dwl1 * crop_keep[k][:, None]
        dmask = dmask + dmask1
        d_wh1 = d_wh1 + dwl1
        d_wb = dwl1 * 0.1

        # where-bias MLP
        wbh = r("wbh", k)
        add("dwb2w", wbh.T @ d_wb)
        add("dwb2b", torch.sum(d_wb, 0))
        dwbh = (d_wb @ wb2w.T) * _delu(wbh)
        add("dwb1w", ht.T @ dwbh)
        add("dwb1b", torch.sum(dwbh, 0))
        d_ht = d_ht + dwbh @ wb1w.T

        # mask MLP (both glimpses' uses)
        maskh = r("maskh", k)
        dmz2 = dmask * mask * (1.0 - mask)
        add("dm2w", maskh.T @ dmz2)
        add("dm2b", torch.sum(dmz2, 0))
        dmaskh = (dmz2 @ m2w.T) * _delu(maskh)
        add("dm1w", ht.T @ dmaskh)
        add("dm1b", torch.sum(dmaskh, 0))
        d_ht = d_ht + dmaskh @ m1w.T

        dwt1[k], dwh1[k], dp1[k], dth[k] = d_wt1, d_wh1, d_p1, d_ht

    return ((torch.stack(dwt1), torch.stack(dwh1), torch.stack(dp1), torch.stack(dth), d_h_c)
            + tuple(acc["d" + n] for n in WEIGHT_NAMES))


# ------------------------------------------------------------------ kernels
def _out_widths(nw, U):
    """The widths of ``OUT_FIELDS``."""
    return (nw, nw, nw, 4, 4, 4, 1, 1, 1, U)


def _kernel_dims(inputs, weights, dims, saved=(), res=None, cots=()):
    """[B, S, H, W, gh, gw, n_what, U, SP, WB, MH] of a call; raises on
    shapes that do not fit together.

    :param inputs: (img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u)
    :param saved, res, cots: the backward's (see ``prop_plain_bwd``)
    """
    S, gh, gw, nw, U, SP, WB, MH = dims
    img = inputs[0]
    if img.ndim != 3:
        raise ValueError(f"fused_prop: img {tuple(img.shape)}")
    B, H, W = img.shape
    G, d_rnn, d_tin = gh * gw, 3 * nw + 10 + U, U + 4 + 2 * nw
    outs = [(S, B, d) for d in _out_widths(nw, U)]
    want = [(U, WB), (WB,), (WB, 4), (4,), (U, MH), (MH,), (MH, G), (G,), (G, U), (U,), (U, U),
            (U,), (U, 2 * nw), (2 * nw,), (d_rnn, U), (U, U), (U,), (2 * U + 4, U), (U,),
            (U, U), (U,), (U, 8), (8,), (4, 4), (d_tin, 2 * U), (U, 2 * U), (2 * U,),
            (d_tin, U), (U, U), (U,), (U, 2 * nw), (2 * nw,), (U, 3 * nw), (3 * nw,),
            (2 * U + nw, SP), (SP,), (SP, 1), (1,)]
    want += [(S, B, nw), (S, B, 4), (S, B, 1), (S, B, U), (B, U), (S, B, 4), (S, B, nw),
             (S, B, 1)]
    got = list(weights) + list(inputs[1:])
    if saved:
        want += [outs[i] for i in (0, 2, 3, 5, 6, 7, 9)] + [(S, B, residual_layout(dims)[1])]
        want += outs
        got += list(saved) + [res] + list(cots)
    if len(weights) != N_WEIGHTS or len(got) != len(want):
        raise ValueError(f"fused_prop: {len(weights)} weights, {len(got)} tensors; expected "
                         f"{N_WEIGHTS} and {len(want)}")
    for i, (t, shape) in enumerate(zip(got, want)):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_prop: tensor {i} is {tuple(t.shape)}, expected {shape}")
    return [B, S, H, W, gh, gw, nw, U, SP, WB, MH]


def _fwd_cuda(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, dims):
    from .build import library

    inputs = [img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u]
    kd = _kernel_dims(inputs, weights, dims)
    B, S, _, _, _, _, nw, U = kd[:8]
    _check("fused_prop", inputs + list(weights), img.device)
    outs = [_empty(S, B, d, like=img) for d in _out_widths(nw, U)]
    res = _empty(S, B, residual_layout(dims)[1], like=img)
    if B > 0:
        geom = prop_fwd_geometry(kd)
        code = library().sqair_fused_prop(_ptrs(inputs + list(weights) + outs + [res]),
                                          _ints(kd), _ints([geom["tile_rows"], geom["cluster"],
                                                            geom["blocks"]]),
                                          _stream(img.device))
        _raise_on("fused_prop", code)
        launches["fused_prop"] += 1
    return tuple(outs) + (res,)


def prop_fwd_geometry(dims):
    """The launch of the propagation forward (csrc/fused_prop.cu
    prop_fwd_kernel), as the host picks it for the kernel dims [B, S, H, W,
    gh, gw, n_what, U, SP, WB, MH]: a cluster of ``cluster`` blocks shares a
    tile of ``tile_rows`` rows, every block holding the tile's forward state
    (the kernel's fwd_smem, which the C entry works out and holds to 227
    KB): ``fused.tile_state_geometry`` of the B rows."""
    return _fused.tile_state_geometry(dims[0])


def prop_bwd_geometry(dims):
    """The launch of the propagation backward's phase A (csrc/fused_prop.cu),
    as the host picks it for the kernel dims [B, S, H, W, gh, gw, n_what, U,
    SP, WB, MH].

    A cluster of ``cluster`` blocks shares a tile of ``tile_rows`` rows,
    every block holding the tile's whole backward state in its shared
    memory (the kernel's bwd_smem, which the C entry works out and holds to
    227 KB): ``fused.tile_state_geometry`` of the B rows.  Phase B, the
    weight-gradient reducer, plans its own launch.
    """
    return _fused.tile_state_geometry(dims[0])


def _crop_keep(name, crop_keep, S, B):
    """[crop_keep] after checking its shape [S, B], or [] for None."""
    if crop_keep is None:
        return []
    if tuple(crop_keep.shape) != (S, B):
        raise ValueError(f"{name}: crop_keep {tuple(crop_keep.shape)}, expected {(S, B)}")
    return [crop_keep]


def _bwd_cuda(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, saved, res, cots, dims,
              crop_keep=None):
    from .build import library

    inputs = [img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u]
    kd = _kernel_dims(inputs, weights, dims, saved, res, cots)
    B, S = kd[:2]
    _check("fused_prop_bwd", inputs + list(weights) + list(saved) + [res] + list(cots)
           + _crop_keep("fused_prop_bwd", crop_keep, S, B), img.device)
    outs = [_empty(*t.shape, like=img) for t in (wt1, wh1, p1, th, h0b)]
    outs += [_empty(*w.shape, like=img) for w in weights]
    if B == 0:
        for t in outs:
            t.zero_()
        return tuple(outs)
    Z = library().sqair_fused_prop_scratch_floats(_ints(kd))
    if Z < 0:
        raise ValueError(f"fused_prop_bwd: dims {kd} refused")
    scratch = _empty(S * B * Z, like=img)
    geom = prop_bwd_geometry(kd)
    code = library().sqair_fused_prop_bwd(
        _ptrs(inputs + list(weights) + list(saved) + [res] + list(cots) + outs
              + [scratch, crop_keep]), _ints(kd),
        _ints([geom["tile_rows"], geom["cluster"], geom["blocks"]]), _stream(img.device))
    _raise_on("fused_prop_bwd", code)
    launches["fused_prop_bwd"] += 1
    return tuple(outs)


def prop_fwd(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, dims):
    """The forward of one call, as ``prop_plain_fwd`` returns it: on CUDA the
    kernel, on the CPU the plain version."""
    if not _on_cuda("fused_prop", img):
        return prop_plain_fwd(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, dims)
    return _fwd_cuda(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, dims)


def prop_bwd(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, saved, res, cots, dims,
             crop_keep=None):
    """The backward of one call, as ``prop_plain_bwd`` returns it: on CUDA the
    kernels, on the CPU the plain version."""
    args = (img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, saved, res, cots, dims)
    if not _on_cuda("fused_prop_bwd", img):
        return prop_plain_bwd(*args, crop_keep=crop_keep)
    return _bwd_cuda(*args, crop_keep=crop_keep)


class _PropFunction(torch.autograd.Function):
    """The propagation unroll with its backward kernel; saves the inputs, the
    weights, (what, what_scale, where, where_scale, prob, presence,
    temporal_h) and the residual blob, as the JAX package's
    ``_fused_prop_fwd``."""

    @staticmethod
    def forward(ctx, dims, img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, *weights):
        out = prop_fwd(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, weights, dims)
        what, _, whatsc, where, _, wheresc, prob, pres, _, tnew, res = out
        ctx.dims = dims
        ctx.save_for_backward(img, wt1, wh1, p1, th, h0b, eps_w, eps_x, u, *weights, what,
                              whatsc, where, wheresc, prob, pres, tnew, res)
        return out[:10]

    @staticmethod
    def backward(ctx, *cots):
        saved = ctx.saved_tensors
        inputs, weights = saved[:9], saved[9:9 + N_WEIGHTS]
        outs, res = saved[9 + N_WEIGHTS:-1], saved[-1]
        grads = prop_bwd(*inputs, weights, outs, res, tuple(c.contiguous() for c in cots),
                         ctx.dims)
        return (None, None) + tuple(grads[:5]) + (None, None, None) + tuple(grads[5:])


def fused_prop_ssm(img, z_tm1, temporal_h, h0, eps_where, eps_what, u_pres, p: PropParams,
                   glimpse_size) -> Dict[str, torch.Tensor]:
    """All S propagation slots of one frame as one kernel forward and one
    backward.

    The contract of the JAX package's ``fused_prop_ssm``: z_tm1 (what, where,
    presence[, presence logit]), temporal_h and the noise are slot-major
    [S, B, d]; h0 [1, U] or [B, U].  Returns ``OUT_FIELDS`` [S, B, d], with
    ``what_sample`` / ``where_sample`` the same tensors as ``what`` /
    ``where``.
    """
    S, B = eps_where.shape[0], img.shape[0]
    gh, gw = int(glimpse_size[0]), int(glimpse_size[1])
    n_what, U = eps_what.shape[-1], p.rnn[1].shape[0]
    dims = (S, gh, gw, n_what, U, p.sp[0][0].shape[1], p.wb[0][0].shape[1],
            p.mask[0][0].shape[1])
    # (scale_offset - 1) folded into the estimator's scale bias: the core's
    # softplus(x + offset - 1)
    s3w, s3b = p.stp[2]
    fold = torch.cat([s3b.new_zeros(4), s3b.new_ones(4)]) * (p.stp_offset - 1.0)
    p = p._replace(stp=(p.stp[0], p.stp[1], (s3w, s3b + fold)))
    h0b = h0.expand(B, U).contiguous()
    args = [t.contiguous() for t in (img, *z_tm1[:3], temporal_h, h0b, eps_where, eps_what,
                                     u_pres)]
    weights = tuple(t.contiguous() for t in weights_flat(p))
    if _needs_grad(*args, *weights):
        out = _PropFunction.apply(dims, *args, *weights)
    else:
        out = prop_fwd(*args, weights, dims)[:10]
    d = dict(zip(OUT_FIELDS, out))
    d["what_sample"], d["where_sample"] = d["what"], d["where"]
    return d


# ==================================================================== discovery
class DiscParams(NamedTuple):
    """The discovery core's raw weights, as the JAX package's DiscParams."""
    enc_in: Tuple  # ((W, b), (W, b)) input encoder, elu elu
    rnn: Tuple  # (W, U, b) VanillaRNN
    stp: Tuple  # ((W, b), (W, b), (W, b)) transform estimator, elu elu id
    stp_offset: torch.Tensor  # scalar scale offset
    ge_enc: Tuple  # ((W, b), (W, b)) glimpse encoder, elu elu; W_1 [gh gw, U]
    ge_head: Tuple  # (W, b) Gaussian head
    sp: Tuple  # ((W, b), (W, b)) steps predictor, elu id


DISC_OUT_FIELDS = OUT_FIELDS[:9]
# the weights in the kernels' order (``disc_weights_flat``)
DISC_WEIGHT_NAMES = ("wi1", "bi1", "wi2", "bi2", "rw", "ru", "rb", "s1w", "s1b", "s2w", "s2b",
                     "s3w", "s3b", "we1", "be1", "we2", "be2", "wh", "bh", "sp1w", "sp1b",
                     "sp2w", "sp2b")
N_DISC_WEIGHTS = len(DISC_WEIGHT_NAMES)


def disc_residual_layout(dims) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """({field: (start, end)}, R) of one slot's residual row, for ``dims``
    (S, gh, gw, n_what, U, SP)."""
    U, SP = dims[4], dims[5]
    off, out = 0, {}
    for name, d in (("h", U), ("a1", U), ("a2", U), ("e1", U), ("e2", U), ("s1", SP),
                    ("lraw", 1)):
        out[name] = (off, off + d)
        off += d
    return out, off


def disc_weights_flat(p: DiscParams):
    """The 23 weights in the kernels' order (the JAX package's
    ``_disc_weights_flat``)."""
    (wi1, bi1), (wi2, bi2) = p.enc_in
    rw, ru, rb = p.rnn
    (s1w, s1b), (s2w, s2b), (s3w, s3b) = p.stp
    (we1, be1), (we2, be2) = p.ge_enc
    wh, bh = p.ge_head
    (sp1w, sp1b), (sp2w, sp2b) = p.sp
    return (wi1, bi1, wi2, bi2, rw, ru, rb, s1w, s1b, s2w, s2b, s3w, s3b, we1, be1, we2, be2,
            wh, bh, sp1w, sp1b, sp2w, sp2b)


def disc_plain_fwd(img, imgf, cond, h0b, eps_w, eps_x, u, weights, dims):
    """The forward in the kernel's order: the nine outputs of
    ``DISC_OUT_FIELDS``, each [S, B, d], the residual blob [S, B, R], the
    glimpses [S, B, gh gw] and the input encoder's layers [B, 2U].

    :param imgf: the frames flat [B, H W]
    :param cond: [B, C] conditioning
    :param h0b: [B, U] initial transition state
    :param weights: ``disc_weights_flat`` with the scale offset folded
    :param dims: (S, gh, gw, n_what, U, SP)
    """
    S, gh, gw, nw = dims[:4]
    (wi1, bi1, wi2, bi2, rw, ru, rb, s1w, s1b, s2w, s2b, s3w, s3b, we1, be1, we2, be2, wh, bh,
     sp1w, sp1b, sp2w, sp2b) = weights
    B = img.shape[0]
    ench1 = _elu(imgf @ wi1 + bi1)
    enc = _elu(ench1 @ wi2 + bi2)
    what, where, pres, h = img.new_zeros(B, nw), img.new_zeros(B, 4), img.new_ones(B, 1), h0b
    outs = [[] for _ in DISC_OUT_FIELDS]
    res, g0s = [], []
    for k in range(S):
        h = torch.tanh(torch.cat([enc, cond, what, where, pres], -1) @ rw + h @ ru + rb)
        a1 = _elu(h @ s1w + s1b)
        a2 = _elu(a1 @ s2w + s2b)
        stp8 = a2 @ s3w + s3b
        wloc = stp8[:, :4]
        wscale = _softplus(stp8[:, 4:]) + MIN_STD
        where = wloc + wscale * eps_w[k]
        g0 = crop_plain(img, where, gh, gw).reshape(B, gh * gw)
        e1 = _elu(g0 @ we1 + be1)
        e2 = _elu(e1 @ we2 + be2)
        hp = e2 @ wh + bh
        gloc = hp[:, :nw]
        gscale = _softplus(hp[:, nw:]) + MIN_STD
        what = gloc + gscale * eps_x[k]
        sp1 = _elu(torch.cat([h, what], -1) @ sp1w + sp1b)
        lraw = sp1 @ sp2w + sp2b
        logit = pres * lraw + (pres - 1.0) * 88.0
        prob = torch.sigmoid(logit)
        pres = (u[k] < prob).to(img.dtype) * pres
        for lst, v in zip(outs, (what, gloc, gscale, where, wloc, wscale, prob, pres, logit)):
            lst.append(v)
        res.append(torch.cat([h, a1, a2, e1, e2, sp1, lraw], -1))
        g0s.append(g0)
    return (tuple(torch.stack(v, 0) for v in outs)
            + (torch.stack(res, 0), torch.stack(g0s, 0), torch.cat([ench1, enc], -1)))


def disc_plain_bwd(img, imgf, cond, h0b, eps_w, eps_x, u, weights, saved, res, g0s, fres,
                   cots, dims, crop_keep=None):
    """The JAX package's ``_disc_bwd_kernel`` as tensor ops: (dcond, dh0b)
    and the 23 weights' gradients in ``disc_weights_flat`` order.

    :param saved: (what, what_scale, where, where_scale, prob, presence) of
        the forward
    :param res, g0s, fres: the forward's residual blob, glimpses and input
        encoder layers
    :param cots: the nine outputs' gradients, in ``DISC_OUT_FIELDS`` order
    :param crop_keep: None, or [S, B] factors on each row-slot's
        where-gradient through the crop (as ``prop_plain_bwd``'s)
    """
    S, gh, gw, nw, U, SP = dims
    (_, _, wi2, _, rw, ru, _, s1w, _, s2w, _, s3w, _, we1, _, we2, _, wh, _, sp1w, _, sp2w,
     _) = weights
    what_o, whatsc_o, where_o, wheresc_o, prob_o, pres_o = saved
    (dwhat_c, dwhatloc_c, dwhatsc_c, dwhere_c, dwhereloc_c, dwheresc_c, dprob_c, dpres_c,
     dlogit_c) = cots
    B, C = img.shape[0], cond.shape[-1]
    offs, _ = disc_residual_layout(dims)
    acc = {}

    def add(name, val):
        acc[name] = val if name not in acc else acc[name] + val

    def r(name, k):
        a, b = offs[name]
        return res[k, :, a:b]

    ench1, enc = fres[:, :U], fres[:, U:]
    zeros = img.new_zeros
    d_enc, d_cond = zeros(B, U), zeros(B, C)
    d_what_c, d_where_c, d_pres_c, d_h_c = zeros(B, nw), zeros(B, 4), zeros(B, 1), zeros(B, U)
    for k in range(S - 1, -1, -1):
        h, a1, a2, e1, e2, sp1, lraw = (r(n, k) for n in ("h", "a1", "a2", "e1", "e2", "s1",
                                                           "lraw"))
        what, gscale, where, wscale, prob = (what_o[k], whatsc_o[k], where_o[k], wheresc_o[k],
                                             prob_o[k])
        if k > 0:
            pres_prev, what_prev, where_prev = pres_o[k - 1], what_o[k - 1], where_o[k - 1]
        else:
            pres_prev, what_prev, where_prev = img.new_ones(B, 1), zeros(B, nw), zeros(B, 4)

        # presence
        d_pres_tot = dpres_c[k] + d_pres_c
        dlogit = dlogit_c[k] + dprob_c[k] * prob * (1.0 - prob)
        dlraw = dlogit * pres_prev
        psamp = (u[k] < prob).to(img.dtype)

        # steps predictor on [h, what]
        dsp1z = (dlraw @ sp2w.T) * _delu(sp1)
        add("dsp2w", sp1.T @ dlraw)
        add("dsp2b", torch.sum(dlraw, 0))
        add("dsp1w", torch.cat([h, what], -1).T @ dsp1z)
        add("dsp1b", torch.sum(dsp1z, 0))
        dspfeat = dsp1z @ sp1w.T
        dh_acc, dwhat_sp = dspfeat[:, :U], dspfeat[:, U:]

        # the what sample, the head and the glimpse encoder
        d_what_tot = dwhat_c[k] + d_what_c + dwhat_sp
        dgloc = d_what_tot + dwhatloc_c[k]
        dgscale = d_what_tot * eps_x[k] + dwhatsc_c[k]
        dhp = torch.cat([dgloc, dgscale * (1.0 - torch.exp(-(gscale - MIN_STD)))], -1)
        add("dwh", e2.T @ dhp)
        add("dbh", torch.sum(dhp, 0))
        dz2 = (dhp @ wh.T) * _delu(e2)
        add("dwe2", e1.T @ dz2)
        add("dbe2", torch.sum(dz2, 0))
        dz1 = (dz2 @ we2.T) * _delu(e1)
        add("dwe1", g0s[k].T @ dz1)
        add("dbe1", torch.sum(dz1, 0))
        dwl_crop = crop_plain_bwd(img, where, (dz1 @ we1.T).reshape(B, gh, gw))
        if crop_keep is not None:
            dwl_crop = dwl_crop * crop_keep[k][:, None]

        # the where sample and the transform estimator
        d_where_tot = dwhere_c[k] + d_where_c + dwl_crop
        dwloc = d_where_tot + dwhereloc_c[k]
        dwscale = d_where_tot * eps_w[k] + dwheresc_c[k]
        dstp8 = torch.cat([dwloc, dwscale * (1.0 - torch.exp(-(wscale - MIN_STD)))], -1)
        add("ds3w", a2.T @ dstp8)
        add("ds3b", torch.sum(dstp8, 0))
        dz_a2 = (dstp8 @ s3w.T) * _delu(a2)
        add("ds2w", a1.T @ dz_a2)
        add("ds2b", torch.sum(dz_a2, 0))
        dz_a1 = (dz_a2 @ s2w.T) * _delu(a1)
        add("ds1w", h.T @ dz_a1)
        add("ds1b", torch.sum(dz_a1, 0))
        dh_acc = dh_acc + dz_a1 @ s1w.T

        # the transition
        dz = (dh_acc + d_h_c) * (1.0 - h * h)
        h_prev = r("h", k - 1) if k > 0 else h0b
        add("drw", torch.cat([enc, cond, what_prev, where_prev, pres_prev], -1).T @ dz)
        add("dru", h_prev.T @ dz)
        add("drb", torch.sum(dz, 0))
        drnn_in = dz @ rw.T
        d_h_c = dz @ ru.T
        d_enc = d_enc + drnn_in[:, :U]
        d_cond = d_cond + drnn_in[:, U:U + C]
        d_what_c = drnn_in[:, U + C:U + C + nw]
        d_where_c = drnn_in[:, U + C + nw:U + C + nw + 4]
        d_pres_c = d_pres_tot * psamp + dlogit * (lraw + 88.0) + drnn_in[:, U + C + nw + 4:]

    # the input encoder
    dz2 = d_enc * _delu(enc)
    dz1 = (dz2 @ wi2.T) * _delu(ench1)
    grads = dict(dwi1=imgf.T @ dz1, dbi1=torch.sum(dz1, 0), dwi2=ench1.T @ dz2,
                 dbi2=torch.sum(dz2, 0), **acc)
    return (d_cond, d_h_c) + tuple(grads["d" + n] for n in DISC_WEIGHT_NAMES)


def _disc_kernel_dims(inputs, weights, dims, saved=(), res=None, g0s=None, fres=None,
                      cots=()):
    """[B, S, H, W, gh, gw, n_what, U, SP, C] of a call; raises on shapes
    that do not fit together.

    :param inputs: (img, imgf, cond, h0b, eps_w, eps_x, u)
    :param saved, res, g0s, fres, cots: the backward's (see ``disc_plain_bwd``)
    """
    S, gh, gw, nw, U, SP = dims
    img, cond = inputs[0], inputs[2]
    if img.ndim != 3 or cond.ndim != 2:
        raise ValueError(f"fused_disc: img {tuple(img.shape)}, cond {tuple(cond.shape)}")
    (B, H, W), C = img.shape, cond.shape[1]
    G, d_rnn = gh * gw, U + C + nw + 5
    want = [(H * W, U), (U,), (U, U), (U,), (d_rnn, U), (U, U), (U,), (U, U), (U,), (U, U),
            (U,), (U, 8), (8,), (G, U), (U,), (U, U), (U,), (U, 2 * nw), (2 * nw,),
            (U + nw, SP), (SP,), (SP, 1), (1,)]
    want += [(B, H * W), (B, C), (B, U), (S, B, 4), (S, B, nw), (S, B, 1)]
    got = list(weights) + list(inputs[1:])
    if saved:
        want += [(S, B, d) for d in (nw, nw, 4, 4, 1, 1)]
        want += [(S, B, disc_residual_layout(dims)[1]), (S, B, G), (B, 2 * U)]
        want += [(S, B, d) for d in (nw, nw, nw, 4, 4, 4, 1, 1, 1)]
        got += list(saved) + [res, g0s, fres] + list(cots)
    if len(weights) != N_DISC_WEIGHTS or len(got) != len(want):
        raise ValueError(f"fused_disc: {len(weights)} weights, {len(got)} tensors; expected "
                         f"{N_DISC_WEIGHTS} and {len(want)}")
    for i, (t, shape) in enumerate(zip(got, want)):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_disc: tensor {i} is {tuple(t.shape)}, expected {shape}")
    return [B, S, H, W, gh, gw, nw, U, SP, C]


def _disc_fwd_cuda(img, imgf, cond, h0b, eps_w, eps_x, u, weights, dims):
    from .build import library

    inputs = [img, imgf, cond, h0b, eps_w, eps_x, u]
    kd = _disc_kernel_dims(inputs, weights, dims)
    B, S, _, _, gh, gw, nw, U = kd[:8]
    _check("fused_disc", inputs + list(weights), img.device)
    outs = [_empty(S, B, d, like=img) for d in (nw, nw, nw, 4, 4, 4, 1, 1, 1)]
    outs += [_empty(S, B, disc_residual_layout(dims)[1], like=img),
             _empty(S, B, gh * gw, like=img), _empty(B, 2 * U, like=img)]
    if B > 0:
        geom = disc_fwd_geometry(kd)
        enc = geom["encoder"]
        code = library().sqair_fused_disc(
            _ptrs(inputs + list(weights) + outs), _ints(kd),
            _ints([geom["tile_rows"], geom["cluster"], geom["blocks"], enc["tile_rows"],
                   enc["cluster"], enc["blocks"], enc["smem"], *enc["wk"]]),
            _stream(img.device))
        _raise_on("fused_disc", code)
        launches["fused_disc"] += 1
    return tuple(outs)


def disc_fwd_geometry(dims):
    """The launches of the discovery forward (csrc/fused_disc.cu), as the
    host picks them for the kernel dims [B, S, H, W, gh, gw, n_what, U, SP,
    C]: the slots' clusters of ``cluster`` blocks share a tile of
    ``tile_rows`` rows, every block holding the tile's forward state (the
    kernel's disc_fwd_smem, which the C entry works out and holds to 227
    KB), ``fused.tile_state_geometry`` of the B rows; ``encoder`` is the
    input encoder's launch before them, ``fused.mlp_fwd_geometry`` of the B
    rows and the widths [H W, U, U]."""
    B, H, W, U = dims[0], dims[2], dims[3], dims[7]
    return dict(_fused.tile_state_geometry(B), encoder=_fused.mlp_fwd_geometry(B, [H * W, U, U]))


def disc_bwd_geometry(dims):
    """The launch of the discovery backward's phase A (csrc/fused_disc.cu
    disc_bwd_kernel), as the host picks it for the kernel dims [B, S, H, W,
    gh, gw, n_what, U, SP, C].

    A cluster of ``cluster`` blocks shares a tile of ``tile_rows`` rows,
    every block holding the tile's backward state in its shared memory (the
    kernel's disc_bwd_smem, which the C entry works out and holds to 227
    KB): ``fused.tile_state_geometry`` of the B rows.  Phase B, the
    weight-gradient reducer, plans its own launches.
    """
    return _fused.tile_state_geometry(dims[0])


def _disc_bwd_cuda(img, imgf, cond, h0b, eps_w, eps_x, u, weights, saved, res, g0s, fres,
                   cots, dims, crop_keep=None):
    from .build import library

    inputs = [img, imgf, cond, h0b, eps_w, eps_x, u]
    kd = _disc_kernel_dims(inputs, weights, dims, saved, res, g0s, fres, cots)
    _check("fused_disc_bwd", inputs + list(weights) + list(saved) + [res, g0s, fres]
           + list(cots) + _crop_keep("fused_disc_bwd", crop_keep, kd[1], kd[0]), img.device)
    outs = [_empty(*cond.shape, like=img), _empty(*h0b.shape, like=img)]
    outs += [_empty(*w.shape, like=img) for w in weights]
    if kd[0] == 0:
        for t in outs:
            t.zero_()
        return tuple(outs)
    n_scratch = library().sqair_fused_disc_scratch_floats(_ints(kd))
    if n_scratch < 0:
        raise ValueError(f"fused_disc_bwd: dims {kd} refused")
    scratch = _empty(n_scratch, like=img)
    geom = disc_bwd_geometry(kd)
    code = library().sqair_fused_disc_bwd(
        _ptrs(inputs + list(weights) + list(saved) + [res, g0s, fres] + list(cots) + outs
              + [scratch, crop_keep]), _ints(kd),
        _ints([geom["tile_rows"], geom["cluster"], geom["blocks"]]), _stream(img.device))
    _raise_on("fused_disc_bwd", code)
    launches["fused_disc_bwd"] += 1
    return tuple(outs)


def disc_fwd(img, imgf, cond, h0b, eps_w, eps_x, u, weights, dims):
    """The forward of one call, as ``disc_plain_fwd`` returns it: on CUDA the
    kernel, on the CPU the plain version."""
    if not _on_cuda("fused_disc", img):
        return disc_plain_fwd(img, imgf, cond, h0b, eps_w, eps_x, u, weights, dims)
    return _disc_fwd_cuda(img, imgf, cond, h0b, eps_w, eps_x, u, weights, dims)


def disc_bwd(img, imgf, cond, h0b, eps_w, eps_x, u, weights, saved, res, g0s, fres, cots,
             dims, crop_keep=None):
    """The backward of one call, as ``disc_plain_bwd`` returns it: on CUDA the
    kernels, on the CPU the plain version."""
    args = (img, imgf, cond, h0b, eps_w, eps_x, u, weights, saved, res, g0s, fres, cots, dims)
    if not _on_cuda("fused_disc_bwd", img):
        return disc_plain_bwd(*args, crop_keep=crop_keep)
    return _disc_bwd_cuda(*args, crop_keep=crop_keep)


class _DiscFunction(torch.autograd.Function):
    """The discovery unroll with its backward kernel; saves the inputs, the
    weights, (what, what_scale, where, where_scale, prob, presence), the
    residual blob, the glimpses and the input encoder's layers, as the JAX
    package's ``_fused_disc_fwd``."""

    @staticmethod
    def forward(ctx, dims, img, imgf, cond, h0b, eps_w, eps_x, u, *weights):
        out = disc_fwd(img, imgf, cond, h0b, eps_w, eps_x, u, weights, dims)
        what, _, whatsc, where, _, wheresc, prob, pres = out[:8]
        ctx.dims = dims
        ctx.save_for_backward(img, imgf, cond, h0b, eps_w, eps_x, u, *weights, what, whatsc,
                              where, wheresc, prob, pres, *out[9:])
        return out[:9]

    @staticmethod
    def backward(ctx, *cots):
        saved = ctx.saved_tensors
        inputs, weights = saved[:7], saved[7:7 + N_DISC_WEIGHTS]
        outs, (res, g0s, fres) = saved[7 + N_DISC_WEIGHTS:-3], saved[-3:]
        grads = disc_bwd(*inputs, weights, outs, res, g0s, fres,
                         tuple(c.contiguous() for c in cots), ctx.dims)
        return (None, None, None) + tuple(grads[:2]) + (None, None, None) + tuple(grads[2:])


def fused_disc_ssm(img, img_flat, conditioning, h0, eps_where, eps_what, u_pres,
                   p: DiscParams, glimpse_size) -> Dict[str, torch.Tensor]:
    """All S discovery slots of one frame as one kernel forward and one
    backward.

    The contract of the JAX package's ``fused_disc_ssm``: img [B, H, W],
    img_flat [B, H W], conditioning [B, C], h0 [1, U] or [B, U], the noise
    slot-major [S, B, d].  Returns ``DISC_OUT_FIELDS`` [S, B, d].
    """
    S, B = eps_where.shape[0], img.shape[0]
    gh, gw = int(glimpse_size[0]), int(glimpse_size[1])
    n_what, U = eps_what.shape[-1], p.rnn[1].shape[0]
    dims = (S, gh, gw, n_what, U, p.sp[0][0].shape[1])
    # the scale offset folded into the estimator's scale bias: the core's
    # softplus(x + offset)
    s3w, s3b = p.stp[2]
    fold = torch.cat([s3b.new_zeros(4), s3b.new_ones(4)]) * p.stp_offset
    p = p._replace(stp=(p.stp[0], p.stp[1], (s3w, s3b + fold)))
    h0b = h0.expand(B, U).contiguous()
    args = [t.contiguous() for t in (img, img_flat, conditioning, h0b, eps_where, eps_what,
                                     u_pres)]
    weights = tuple(t.contiguous() for t in disc_weights_flat(p))
    if _needs_grad(*args, *weights):
        out = _DiscFunction.apply(dims, *args, *weights)
    else:
        out = disc_fwd(*args, weights, dims)[:9]
    return dict(zip(DISC_OUT_FIELDS, out))
