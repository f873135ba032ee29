"""AIR glimpse encoder and decoder (the port of sqair_tpu/models/air.py)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..nn.layers import MLP, Decoder, Module, SubpixelDecoder, const
from ..nn.stochastic import GaussianFromParamVec
from ..ops import distributions as D
from ..ops import stn


class AIREncoder(Module):
    """ST crop at ``where`` (logit space), an optional soft mask from
    ``mask_inpt``, and an MLP -> what posterior.

    :param glimpse_encoder: Encoder or ConvEncoder over the flattened
        glimpse (``d_out`` wide)
    """

    def __init__(self, img_size, glimpse_size, n_what, glimpse_encoder, d_mask=0,
                 masked_glimpse=False):
        super().__init__()
        self.img_size, self.glimpse_size = tuple(img_size), tuple(glimpse_size)
        self.masked_glimpse = masked_glimpse
        self.glimpse_encoder = glimpse_encoder
        self._what_distrib = GaussianFromParamVec(glimpse_encoder.d_out, n_what)
        if masked_glimpse:
            self._mask_mlp = MLP(d_mask, [128], n_out=math.prod(self.glimpse_size),
                                 transfer="sigmoid", output_bias_init=const(1.0))

    def forward(self, img, where=None, mask_inpt=None
                ) -> Tuple[D.Normal, Optional[torch.Tensor]]:
        """:param img: [B, H, W]
        :param where: [B, 4] or [B, S, 4] where logits
        :return: (what Normal [..., n_what], glimpse [..., gh, gw])"""
        if where is not None:
            coords = stn.to_coords(where)
            src = img[:, None] if coords.ndim == 3 else img
            glimpse = stn.extract_glimpse(src, coords, self.glimpse_size)
        else:
            glimpse = img
        if self.masked_glimpse and mask_inpt is not None:
            glimpse = glimpse * self._mask_mlp(mask_inpt).reshape(glimpse.shape)
        flat = glimpse.reshape(glimpse.shape[:-2] + (-1,))
        return self._what_distrib(self.glimpse_encoder(flat)), glimpse


class AIRDecoder(Module):
    """Per-object glimpse decode, inverse-ST paste and a mean-image
    background.  One pair of paste matrices serves the glimpse paste and
    the written-to mask, whose all-ones paste is the rank-1 outer product
    of the matrices' row sums.

    The glimpse decoder is the MLP ``Decoder`` (``decoder_type`` "mlp") or
    the ``SubpixelDecoder`` (``"subpixel"``: channels [16, 16], the glimpse
    size, ``glimpse_output_scale``).

    The stds, the JAX package's machinery: each is a parameter under its
    flax name (``output_std``, ``background_std``) holding sqrt(std) with a
    ``min_std`` lower bound reparametrised as std = raw^2 + offset
    (raw = sqrt(value - min_std), offset = 2 value min_std - min_std^2);
    the background's value is ``bg_std`` or else ``output_std``.  A std gets
    a gradient only where it is learnable (``learn_std``,
    ``learn_bg_std``); ``bg_bigger_than_fg_std`` keeps the background's std
    at least the foreground's + 1e-4.
    """

    def __init__(self, img_size, glimpse_size, n_what, glimpse_n_hiddens,
                 glimpse_output_scale=0.25, mean_img: Optional[np.ndarray] = None,
                 output_std=0.3, learn_std=False, bg_std: Optional[float] = None,
                 learn_bg_std=False, min_std=0.0, bg_bigger_than_fg_std=False,
                 decoder_type="mlp"):
        super().__init__()
        if decoder_type not in ("mlp", "subpixel"):
            raise ValueError(f"Unknown decoder_type '{decoder_type}'")
        self.img_size, self.glimpse_size = tuple(img_size), tuple(glimpse_size)
        if decoder_type == "subpixel":
            self._glimpse_decoder = SubpixelDecoder(n_what, [16, 16], self.glimpse_size,
                                                    glimpse_output_scale)
        else:
            self._glimpse_decoder = Decoder(n_what, glimpse_n_hiddens, self.glimpse_size,
                                            glimpse_output_scale)
        if mean_img is not None:
            mean = torch.as_tensor(np.asarray(mean_img, np.float32))
            self.add_param("mean_img", mean.shape, lambda t, g: t.copy_(mean))
        self.has_mean_img = mean_img is not None
        self.learn_std, self.learn_bg_std = learn_std, learn_bg_std
        self.bg_bigger_than_fg_std = bg_bigger_than_fg_std
        self._fg_offset = self._std_param("output_std", output_std, min_std)
        self._bg_offset = self._std_param("background_std",
                                          output_std if bg_std is None else bg_std, min_std)

    def _std_param(self, name, value, min_std) -> float:
        """Adds the std parameter ``name`` (sqrt reparametrisation); returns
        its offset."""
        offset = 0.0
        if min_std != 0.0:
            if not 0.0 < min_std <= value:
                raise ValueError(f"min_std {min_std} must lie in (0, {name} {value}]")
            offset = 2 * value * min_std - min_std**2
            value = value - min_std
        self.add_param(name, (), const(math.sqrt(value)))
        return offset

    def stds(self):
        """(foreground std, background std)."""
        fg_raw = self.output_std if self.learn_std else self.output_std.detach()
        bg_raw = self.background_std if self.learn_bg_std else self.background_std.detach()
        fg = fg_raw**2 + self._fg_offset
        bg = bg_raw**2 + self._bg_offset
        if self.bg_bigger_than_fg_std:
            bg = torch.maximum(bg, fg + 1e-4)
        return fg, bg

    def forward(self, what, where, presence=None):
        """:param what: [B, S, n_what]; where: [B, S, 4]; presence: [B, S, 1]
        :return: (Normal over [B, H, W], glimpse [B, S, gh, gw])"""
        glimpse = self._glimpse_decoder(what)
        coords = stn.to_coords(where)
        uy, ux = stn.paste_matrices(coords, self.glimpse_size, self.img_size)
        pasted = uy @ glimpse @ ux.transpose(-1, -2)
        ones_paste = uy.sum(-1)[..., :, None] * ux.sum(-1)[..., None, :]
        if presence is not None:
            pasted = pasted * presence[..., None]
            ones_paste = ones_paste * presence[..., None]
        canvas = torch.sum(pasted, 1)
        written_to_mask = torch.sigmoid(-10.0 + torch.sum(ones_paste, 1) * 20.0)
        if self.has_mean_img:
            canvas = canvas + self.mean_img[None] * written_to_mask
        fg, bg = self.stds()
        std = written_to_mask * fg + (1.0 - written_to_mask) * bg
        return D.Normal(canvas, std), glimpse
