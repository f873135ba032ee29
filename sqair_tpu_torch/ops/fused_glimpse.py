"""The fused glimpse encoder, forward and backward, with its plain versions.

The port of ``sqair_tpu/ops/fused_glimpse.py``: the block of SQAIR that
runs most often, a crop at ``where`` encoded to a what-posterior, as one
kernel forward and one backward (``csrc/fused_glimpse.cu``):

  s = sigmoid(wl[:, :2]); t = tanh(wl[:, 2:])          # to_coords
  s = max(s, 1e-4), straight-through in the gradient   # clip_preserve
  wy[b, i, p] = relu(1 - |(s_y t_i + t_y + 1)(H - 1)/2 - p|), wx alike
  g = wy @ img @ wx^T                                  # separable bilinear
  g *= sigmoid(MLP(mask_inpt))                         # when masked
  h = elu-MLP(g); loc, z = split(h W_h + b_h)
  scale = softplus(z) + 1e-2

The backward gives every weight, ``mask_inpt`` and ``where`` (through the
interpolation weights) its gradient; ``img`` is observed data and gets
none.  On a CUDA tensor the wrapper launches the kernels or raises; on a
CPU tensor it runs the plain versions here, which follow the JAX package's
``_fwd_kernel`` / ``_bwd_kernel`` step by step (elu' read off the output,
1 at 0, as ``_delu``).  ``launches["fused_glimpse"]`` and
``launches["fused_glimpse_bwd"]`` count the calls that launched a kernel,
in the counter of ``ops/fused.py``.

The model takes this path only when ``SQAIR_FUSE_GLIMPSE`` is set
(``enabled``), as the JAX package does.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from . import fused as _fused
from .fused import (_check, _empty, _ints, _needs_grad, _on_cuda, _ptrs, _raise_on, _stream,
                    launches)

MIN_SCALE = 1e-4  # stn.SCALE_EPS
MIN_STD = 1e-2


def enabled() -> bool:
    """The JAX package's switch: any non-empty ``SQAIR_FUSE_GLIMPSE``."""
    return bool(os.environ.get("SQAIR_FUSE_GLIMPSE"))


def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log(1.0 + torch.exp(-torch.abs(x)))


def _elu(z):
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def _delu(a):
    return torch.where(a > 0, torch.ones_like(a), a + 1.0)


def coords_and_interp(wl, H, W, gh, gw):
    """((sx, sy, tx, ty), (wy, uy, ti_y), (wx, ux, ti_x)) of the where logits
    wl [B, 4], in the JAX package's order of operations (``_coords_and_interp``)."""
    s = torch.sigmoid(wl[:, :2])
    t = torch.tanh(wl[:, 2:])
    sx, sy, tx, ty = s[:, 0], s[:, 1], t[:, 0], t[:, 1]
    sxc, syc = torch.clamp(sx, min=MIN_SCALE), torch.clamp(sy, min=MIN_SCALE)

    def interp(scale, shift, src, dst):
        ti = torch.arange(dst, dtype=wl.dtype, device=wl.device) * (2.0 / (dst - 1)) - 1.0
        u = (scale[:, None] * ti[None, :] + shift[:, None] + 1.0) * (src - 1) / 2.0
        p = torch.arange(src, dtype=wl.dtype, device=wl.device)
        return torch.clamp(1.0 - torch.abs(u[:, :, None] - p), min=0.0), u, ti

    return (sx, sy, tx, ty), interp(syc, ty, H, gh), interp(sxc, tx, W, gw)


def crop_plain(img, wl, gh, gw):
    """The separable bilinear crop g0 = wy (img wx^T) [B, gh, gw] at the where
    logits wl [B, 4]."""
    _, (wy, _, _), (wx, _, _) = coords_and_interp(wl, img.shape[1], img.shape[2], gh, gw)
    return wy @ (img @ wx.transpose(1, 2))


def crop_plain_bwd(img, wl, dg0):
    """The where logits' gradient [B, 4] of ``crop_plain`` for dg0 [B, gh, gw]:
    through the interpolation weights, the clip straight-through, then the
    sigmoid / tanh derivatives.  img gets none."""
    (B, H, W), (gh, gw) = img.shape, dg0.shape[1:]
    (sx, sy, tx, ty), (wy, uy, ti_y), (wx, ux, ti_x) = coords_and_interp(wl, H, W, gh, gw)
    A = img @ wx.transpose(1, 2)
    dwy = dg0 @ A.transpose(1, 2)
    dA = wy.transpose(1, 2) @ dg0
    dwx = dA.transpose(1, 2) @ img

    def d_interp(dw, w_mat, u, src, ti):
        p = torch.arange(src, dtype=wl.dtype, device=wl.device)
        du_dp = torch.where(w_mat > 0.0, -torch.sign(u[:, :, None] - p),
                            torch.zeros_like(w_mat))
        du = torch.sum(dw * du_dp, 2)
        return (torch.sum(du * ti[None, :], 1) * (src - 1) / 2.0,
                torch.sum(du, 1) * (src - 1) / 2.0)

    dsyc, dty = d_interp(dwy, wy, uy, H, ti_y)
    dsxc, dtx = d_interp(dwx, wx, ux, W, ti_x)
    return torch.stack([dsxc * sx * (1.0 - sx), dsyc * sy * (1.0 - sy),
                        dtx * (1.0 - tx * tx), dty * (1.0 - ty * ty)], -1)


# ------------------------------------------------------------ plain versions
def glimpse_plain_fwd(img, wl, mi, mask_params, enc_params, head_w, head_b, dims):
    """What the JAX package's ``_run_fwd`` returns: (loc, scale, g0 [B, gh, gw],
    h1, h2) and, when masked (``mi`` given), (mask [B, gh gw], mhid)."""
    gh, gw, n_what = dims
    B = img.shape[0]
    g0 = crop_plain(img, wl, gh, gw)
    flat = g0.reshape(B, gh * gw)
    extra = ()
    if mi is not None:
        (wm1, bm1), (wm2, bm2) = mask_params
        mhid = _elu(mi @ wm1 + bm1)
        mask = torch.sigmoid(mhid @ wm2 + bm2)
        flat = flat * mask
        extra = (mask, mhid)
    (we1, be1), (we2, be2) = enc_params
    h1 = _elu(flat @ we1 + be1)
    h2 = _elu(h1 @ we2 + be2)
    hp = h2 @ head_w + head_b
    scale = _softplus(hp[:, n_what:]) + MIN_STD
    return (hp[:, :n_what], scale, g0, h1, h2) + extra


def glimpse_plain_bwd(img, wl, mi, mask_params, enc_params, head_w, saved, dloc, dscale,
                      dims):
    """The JAX package's ``_bwd_kernel`` as tensor ops; returns what its
    ``_run_bwd`` returns: dwl, then (dmi, dWm1, dbm1, dWm2, dbm2) when masked,
    then dWe1, dbe1, dWe2, dbe2, dWh, dbh.

    :param saved: (g0, h1, h2, scale) and, when masked, (mask, mhid)
    """
    gh, gw, _ = dims
    B = img.shape[0]
    masked = mi is not None
    g0, h1, h2, scale = saved[:4]
    g0_flat = g0.reshape(B, gh * gw)
    mask = saved[4] if masked else None
    gflat = g0_flat * mask if masked else g0_flat

    dsp = 1.0 - torch.exp(-(scale - MIN_STD))  # softplus' from the saved value
    dhp = torch.cat([dloc, dscale * dsp], -1)
    dwh, dbh = h2.T @ dhp, torch.sum(dhp, 0)
    dz2 = (dhp @ head_w.T) * _delu(h2)
    (we1, _), (we2, _) = enc_params
    dwe2, dbe2 = h1.T @ dz2, torch.sum(dz2, 0)
    dz1 = (dz2 @ we2.T) * _delu(h1)
    dwe1, dbe1 = gflat.T @ dz1, torch.sum(dz1, 0)
    dgflat = dz1 @ we1.T

    mask_grads = ()
    if masked:
        (wm1, _), (wm2, _) = mask_params
        mhid = saved[5]
        dmask = dgflat * g0_flat
        dg0 = dgflat * mask
        dmz2 = dmask * mask * (1.0 - mask)
        dmz1 = (dmz2 @ wm2.T) * _delu(mhid)
        mask_grads = (dmz1 @ wm1.T, mi.T @ dmz1, torch.sum(dmz1, 0), mhid.T @ dmz2,
                      torch.sum(dmz2, 0))
    else:
        dg0 = dgflat
    dwl = crop_plain_bwd(img, wl, dg0.reshape(B, gh, gw))
    return (dwl,) + mask_grads + (dwe1, dbe1, dwe2, dbe2, dwh, dbh)


# ------------------------------------------------------------------ kernels
def _kernel_dims(img, wl, mi, mask_params, enc_params, head_w, dims):
    """[n, H, W, gh, gw, d_mi, d_m, d1, d2, n_what] of a call; raises on
    shapes that do not fit together."""
    gh, gw, n_what = dims
    if img.ndim != 3 or wl.shape != (img.shape[0], 4):
        raise ValueError(f"fused_glimpse: img {tuple(img.shape)}, where {tuple(wl.shape)}")
    n, H, W = img.shape
    (we1, be1), (we2, be2) = enc_params
    d1, d2 = we1.shape[1], we2.shape[1]
    shapes = [(we1, (gh * gw, d1)), (be1, (d1,)), (we2, (d1, d2)), (be2, (d2,)),
              (head_w, (d2, 2 * n_what))]
    d_mi = d_m = 0
    if mi is not None:
        (wm1, bm1), (wm2, bm2) = mask_params
        d_mi, d_m = mi.shape[1], wm1.shape[1]
        shapes += [(mi, (n, d_mi)), (wm1, (d_mi, d_m)), (bm1, (d_m,)), (wm2, (d_m, gh * gw)),
                   (bm2, (gh * gw,))]
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_glimpse: expected {shape}, got {tuple(t.shape)}")
    return [n, H, W, gh, gw, d_mi, d_m, d1, d2, n_what]


def _flat_params(mask_params, enc_params, head_w, head_b):
    masks = [t for wb in mask_params for t in wb] if mask_params is not None else []
    return masks + [t for wb in enc_params for t in wb] + [head_w, head_b]


def _unflat_params(flat, masked):
    """(mask_params or None, enc_params, head_w, head_b) of ``_flat_params``."""
    mask_params = None
    if masked:
        mask_params, flat = ((flat[0], flat[1]), (flat[2], flat[3])), flat[4:]
    return mask_params, ((flat[0], flat[1]), (flat[2], flat[3])), flat[4], flat[5]


def _fwd_cuda(img, wl, mi, mask_params, enc_params, head_w, head_b, dims, save):
    """The forward kernel; the saved tensors are None unless ``save``."""
    from .build import library

    kd = _kernel_dims(img, wl, mi, mask_params, enc_params, head_w, dims)
    n, _, _, gh, gw, _, d_m, d1, d2, n_what = kd
    if tuple(head_b.shape) != (2 * n_what,):
        raise ValueError(f"fused_glimpse: head bias {tuple(head_b.shape)}")
    masked = mi is not None
    params = _flat_params(mask_params, enc_params, head_w, head_b)
    _check("fused_glimpse", [img, wl] + ([mi] if masked else []) + params, img.device)
    loc, scale = _empty(n, n_what, like=img), _empty(n, n_what, like=img)
    saved = []
    if save:
        saved = [_empty(n, gh, gw, like=img), _empty(n, d1, like=img), _empty(n, d2, like=img)]
        if masked:
            saved += [_empty(n, gh * gw, like=img), _empty(n, d_m, like=img)]
    if n > 0:
        mp = params[:4] if masked else [None] * 4
        ptrs = [img, wl, mi, *mp, *params[-6:], loc, scale] + saved + [None] * (5 - len(saved))
        geom = glimpse_fwd_geometry(kd)
        code = library().sqair_fused_glimpse(
            _ptrs(ptrs), _ints(kd), _ints([geom["tile_rows"], geom["cluster"], geom["blocks"]]),
            _stream(img.device))
        _raise_on("fused_glimpse", code)
        launches["fused_glimpse"] += 1
    return (loc, scale) + tuple(saved)


def glimpse_fwd_geometry(dims):
    """The launch of the glimpse forward (csrc/fused_glimpse.cu
    glimpse_fwd_kernel), as the host picks it for the kernel dims [n, H, W,
    gh, gw, d_mi, d_m, d1, d2, n_what]: a cluster of ``cluster`` blocks
    shares a tile of ``tile_rows`` rows, every block holding the tile's
    state (the kernel's fwd_smem, which the C entry works out and holds to
    227 KB): ``fused.tile_state_geometry`` of the n rows."""
    return _fused.tile_state_geometry(dims[0])


def glimpse_bwd_geometry(dims):
    """The launch of the glimpse backward's phase A (csrc/fused_glimpse.cu),
    as the host picks it for the kernel dims [n, H, W, gh, gw, d_mi, d_m,
    d1, d2, n_what].

    A cluster of ``cluster`` blocks shares a tile of ``tile_rows`` rows,
    every block holding the tile's row gradients in its shared memory (the
    kernel's bwd_smem, which the C entry works out and holds to 227 KB):
    ``fused.tile_state_geometry`` of the n rows.  Phase B, the
    weight-gradient reducer, plans its own launch.
    """
    return _fused.tile_state_geometry(dims[0])


def _bwd_cuda(img, wl, mi, mask_params, enc_params, head_w, saved, dloc, dscale, dims):
    """The backward kernels (phase A rows, phase B weight reductions)."""
    from .build import library

    kd = _kernel_dims(img, wl, mi, mask_params, enc_params, head_w, dims)
    n, _, _, gh, gw, d_mi, d_m, d1, d2, n_what = kd
    masked = mi is not None
    g = gh * gw
    (we1, _), (we2, _) = enc_params
    weights = ([mask_params[0][0], mask_params[1][0]] if masked else []) + [we1, we2, head_w]
    _check("fused_glimpse_bwd", [img, wl, *weights, *saved, dloc, dscale]
           + ([mi] if masked else []), img.device)
    outs = [_empty(n, 4, like=img)]
    if masked:
        outs += [_empty(n, d_mi, like=img), _empty(d_mi, d_m, like=img), _empty(d_m, like=img),
                 _empty(d_m, g, like=img), _empty(g, like=img)]
    outs += [_empty(g, d1, like=img), _empty(d1, like=img), _empty(d1, d2, like=img),
             _empty(d2, like=img), _empty(d2, 2 * n_what, like=img),
             _empty(2 * n_what, like=img)]
    if n == 0:
        for t in outs:
            t.zero_()
        return tuple(outs)
    # phase A's per-row results that phase B reduces: dhp, dz2, dz1 and,
    # when masked, the masked glimpse, dmz2 and dmz1
    scratch = _empty(n * (2 * n_what + d2 + d1 + ((2 * g + d_m) if masked else 0)), like=img)
    mask_w = [mask_params[0][0], mask_params[1][0]] if masked else [None, None]
    mask_saved = list(saved[4:6]) if masked else [None, None]
    mask_outs = outs[1:6] if masked else [None] * 5
    ptrs = [img, wl, mi, *mask_w, we1, we2, head_w, *saved[:4], *mask_saved, dloc, dscale,
            outs[0], *mask_outs, *outs[-6:], scratch]
    geom = glimpse_bwd_geometry(kd)
    code = library().sqair_fused_glimpse_bwd(
        _ptrs(ptrs), _ints(kd), _ints([geom["tile_rows"], geom["cluster"], geom["blocks"]]),
        _stream(img.device))
    _raise_on("fused_glimpse_bwd", code)
    launches["fused_glimpse_bwd"] += 1
    return tuple(outs)


def fused_glimpse_bwd(img, wl, mi, mask_params, enc_params, head_w, saved, dloc, dscale,
                      dims):
    """The backward of one call, as ``glimpse_plain_bwd`` returns it: on CUDA
    the kernels, on the CPU the plain version."""
    if not _on_cuda("fused_glimpse_bwd", img):
        return glimpse_plain_bwd(img, wl, mi, mask_params, enc_params, head_w, saved, dloc,
                                 dscale, dims)
    return _bwd_cuda(img, wl, mi, mask_params, enc_params, head_w, saved, dloc, dscale, dims)


class _GlimpseFunction(torch.autograd.Function):
    """The fused glimpse encoder with its backward kernel; saves img, where,
    mask_inpt, the weights and (g0, h1, h2, scale[, mask, mhid]), as the
    JAX package's ``_fused_ge_fwd``."""

    @staticmethod
    def forward(ctx, img, wl, mi, dims, *flat):
        mask_params, enc_params, head_w, head_b = _unflat_params(flat, mi is not None)
        args = (img, wl, mi, mask_params, enc_params, head_w, head_b, dims)
        if img.device.type == "cuda":
            res = _fwd_cuda(*args, save=True)
        else:
            res = glimpse_plain_fwd(*args)
        loc, scale, g0, h1, h2 = res[:5]
        ctx.dims, ctx.masked = dims, mi is not None
        ctx.save_for_backward(img, wl, mi, *flat, g0, h1, h2, scale, *res[5:])
        return loc, scale

    @staticmethod
    def backward(ctx, dloc, dscale):
        saved = ctx.saved_tensors
        n_flat = 10 if ctx.masked else 6
        img, wl, mi, flat = saved[0], saved[1], saved[2], saved[3:3 + n_flat]
        mask_params, enc_params, head_w, _ = _unflat_params(flat, ctx.masked)
        grads = fused_glimpse_bwd(img, wl, mi, mask_params, enc_params, head_w,
                                  saved[3 + n_flat:], dloc.contiguous(), dscale.contiguous(),
                                  ctx.dims)
        dwl, rest = grads[0], grads[1:]
        dmi = None
        if ctx.masked:
            dmi, rest = rest[0], rest[1:]
        return (None, dwl, dmi, None, *rest)


def fused_glimpse_encoder(img: torch.Tensor, where_logits: torch.Tensor,
                          mask_inpt: Optional[torch.Tensor], mask_params, enc_params,
                          head_w: torch.Tensor, head_b: torch.Tensor,
                          glimpse_size: Tuple[int, int], n_what: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop, mask, encode and the Gaussian head as one kernel.

    :param img: [B, H, W]; where_logits: [B, 4]; mask_inpt: [B, d] or None
    :param mask_params: ((Wm1, bm1), (Wm2, bm2)), read only with mask_inpt
    :param enc_params: ((We1, be1), (We2, be2)), We1 [gh gw, d1]
    :return: (loc [B, n_what], scale [B, n_what])
    """
    dims = (int(glimpse_size[0]), int(glimpse_size[1]), int(n_what))
    if mask_inpt is None:
        mask_params = None
    img, where_logits = img.contiguous(), where_logits.contiguous()
    if mask_inpt is not None:
        mask_inpt = mask_inpt.contiguous()
    flat = _flat_params(mask_params, enc_params, head_w, head_b)
    cuda = _on_cuda("fused_glimpse", img)
    if _needs_grad(where_logits, *([mask_inpt] if mask_inpt is not None else []), *flat):
        return _GlimpseFunction.apply(img, where_logits, mask_inpt, dims, *flat)
    args = (img, where_logits, mask_inpt, mask_params, enc_params, head_w, head_b, dims)
    if cuda:
        return _fwd_cuda(*args, save=False)
    return glimpse_plain_fwd(*args)[:2]
