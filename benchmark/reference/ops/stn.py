"""Spatial transformer as separable bilinear matrix products (the port of
sqair_tpu/ops/stn.py).

The affine warp has no shear, so bilinear resampling factorises:

    crop  = W_y @ img @ W_x^T      W_y: [gh, H], W_x: [gw, W]
    paste = U_y @ glimpse @ U_x^T  U_y: [H, gh], U_x: [W, gw]

with interpolation matrices built from the ST coords [sx, sy, tx, ty];
source coordinates out of range interpolate against zeros.  The products
run in the precision that ``reference.train.precision`` sets.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .math import clip_preserve

SCALE_EPS = 1e-4


def to_coords(logits: torch.Tensor) -> torch.Tensor:
    """where logits -> ST coords: scale = sigmoid, shift = tanh."""
    scale_logit, shift_logit = torch.chunk(logits, 2, -1)
    return torch.cat([torch.sigmoid(scale_logit), torch.tanh(shift_logit)], -1)


def to_logits(coords: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Inverse of to_coords."""
    scale, shift = torch.chunk(coords, 2, -1)
    scale = torch.clamp(scale, eps, 1.0 - eps)
    scale_logit = torch.log(scale / (1.0 - scale))
    shift = torch.clamp(shift, eps - 1.0, 1.0 - eps)
    shift_logit = 0.5 * (torch.log1p(shift) - torch.log1p(-shift))
    return torch.cat([scale_logit, shift_logit], -1)


def stn_to_pixel_coords(stn_coords: torch.Tensor, img_size: Sequence[int]) -> torch.Tensor:
    """ST coords [..., 4] -> pixel (y, x, h, w) boxes [..., 4], with the
    reference's (length + 1) size convention."""
    sx, sy, tx, ty = torch.chunk(stn_coords, 4, -1)

    def one(scale, translation, length):
        size = (length + 1.0) * scale
        shift = 0.5 * (length - 1.0) * (translation - scale + 1.0)
        return shift, size

    y, h = one(sy, ty, img_size[0])
    x, w = one(sx, tx, img_size[1])
    return torch.cat([y, x, h, w], -1)


def pixel_to_stn_coords(yxhw: torch.Tensor, img_size: Sequence[int]) -> torch.Tensor:
    """Pixel (y, x, h, w) boxes [..., 4] -> ST coords [..., 4] (float32), the
    inverse of ``stn_to_pixel_coords``."""
    yxhw = torch.as_tensor(yxhw, dtype=torch.float32)
    size = torch.tensor([float(v) for v in img_size], dtype=torch.float32, device=yxhw.device)
    scale = yxhw[..., 2:] / (size + 1.0)
    shift = 2.0 * yxhw[..., :2] / (size - 1.0) + scale - 1.0
    sy, sx = torch.chunk(scale, 2, -1)
    ty, tx = torch.chunk(shift, 2, -1)
    return torch.cat([sx, sy, tx, ty], -1)


def _interp_coords(scale, shift, src_len: int, dst_len: int) -> torch.Tensor:
    """u_i = (scale t_i + shift + 1) (src_len - 1) / 2, t_i = linspace(-1, 1):
    the source coordinate of each of the dst_len outputs."""
    t = torch.linspace(-1.0, 1.0, dst_len, dtype=scale.dtype, device=scale.device)
    return (scale[..., None] * t + shift[..., None] + 1.0) * (src_len - 1) / 2.0


def _interp_weights(u, src_len: int) -> torch.Tensor:
    """M[..., i, p] = max(0, 1 - |u_i - p|)."""
    p = torch.arange(src_len, dtype=u.dtype, device=u.device)
    return torch.clamp(1.0 - torch.abs(u[..., :, None] - p), min=0.0)


def _split_coords(coords):
    sx, sy, tx, ty = (coords[..., i] for i in range(4))
    sx = clip_preserve(sx, SCALE_EPS, float("inf"))
    sy = clip_preserve(sy, SCALE_EPS, float("inf"))
    return sx, sy, tx, ty


def crop_coords(coords: torch.Tensor, glimpse_size: Sequence[int],
                img_size: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_y [..., gh], u_x [..., gw]): the image coordinates that a crop at
    coords [..., 4] interpolates at.  The crop's gradient with respect to
    coords jumps where one of them crosses an integer."""
    gh, gw = glimpse_size
    H, W = img_size
    sx, sy, tx, ty = _split_coords(coords)
    return _interp_coords(sy, ty, H, gh), _interp_coords(sx, tx, W, gw)


def paste_coords(coords: torch.Tensor, glimpse_size: Sequence[int],
                 img_size: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_y [..., H], u_x [..., W]): the glimpse coordinates that a paste at
    coords interpolates at, one per image row and column."""
    gh, gw = glimpse_size
    H, W = img_size
    sx, sy, tx, ty = _split_coords(coords)
    return _interp_coords(1.0 / sy, -ty / sy, gh, H), _interp_coords(1.0 / sx, -tx / sx, gw, W)


def extract_glimpse(img: torch.Tensor, coords: torch.Tensor,
                    glimpse_size: Sequence[int]) -> torch.Tensor:
    """Crops a [..., gh, gw] glimpse of img [..., H, W] at coords [..., 4]
    (batch dims broadcast)."""
    H, W = img.shape[-2], img.shape[-1]
    uy, ux = crop_coords(coords, glimpse_size, (H, W))
    wy = _interp_weights(uy, H)  # [..., gh, H]
    wx = _interp_weights(ux, W)  # [..., gw, W]
    return wy @ img @ wx.transpose(-1, -2)


def paste_matrices(coords: torch.Tensor, glimpse_size: Sequence[int],
                   img_size: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uy [..., H, gh], ux [..., W, gw]) of the inverse-ST paste, so that
    paste = uy @ glimpse @ ux^T."""
    gh, gw = glimpse_size
    uy, ux = paste_coords(coords, glimpse_size, img_size)
    return _interp_weights(uy, gh), _interp_weights(ux, gw)


def paste_glimpse(glimpse: torch.Tensor, coords: torch.Tensor,
                  img_size: Sequence[int]) -> torch.Tensor:
    """Pastes glimpse [..., gh, gw] into a zero [..., H, W] canvas."""
    uy, ux = paste_matrices(coords, glimpse.shape[-2:], img_size)
    return uy @ glimpse @ ux.transpose(-1, -2)
