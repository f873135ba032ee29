"""AIR glimpse encoder and decoder (the port of sqair_tpu/models/air.py)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..nn.layers import MLP, Decoder, Module, const
from ..nn.stochastic import GaussianFromParamVec
from ..ops import distributions as D
from ..ops import fused_glimpse, stn


class AIREncoder(Module):
    """ST crop at ``where`` (logit space), an optional soft mask from
    ``mask_inpt``, and an MLP -> what posterior.

    :param glimpse_encoder: Encoder over the flattened glimpse
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

    def _fused_params(self):
        """(mask_params, enc_params, head_w, head_b) for the fused glimpse
        kernel, or None where the JAX package's ``_fused_param_tree`` gives
        None: a glimpse encoder of other than two layers, or no head."""
        mlp = self.glimpse_encoder.MLP_0
        if mlp.n_layers != 2 or not hasattr(self._what_distrib, "Dense_0"):
            return None
        head = self._what_distrib.Dense_0
        mask_params = self._mask_mlp.layer_params() if self.masked_glimpse else None
        return mask_params, mlp.layer_params(), head.kernel, head.bias

    def forward(self, img, where=None, mask_inpt=None
                ) -> Tuple[D.Normal, Optional[torch.Tensor]]:
        """:param img: [B, H, W]
        :param where: [B, 4] or [B, S, 4] where logits
        :return: (what Normal [..., n_what], glimpse [..., gh, gw]); the
            glimpse is None on the fused path (no caller reads it)"""
        # the JAX package's gate (sqair_tpu/models/air.py): the switch, a
        # per-object [B, 4] where and the standard two-layer encoder
        fused = (fused_glimpse.enabled() and where is not None and where.ndim == 2
                 and self._fused_params())
        if fused:
            mask_params, enc_params, head_w, head_b = fused
            mi = mask_inpt if (self.masked_glimpse and mask_inpt is not None) else None
            loc, scale = fused_glimpse.fused_glimpse_encoder(
                img, where, mi, mask_params, enc_params, head_w, head_b, self.glimpse_size,
                self._what_distrib.n_dim)
            return D.Normal(loc, scale), None
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

    The fg / bg stds are parameters (kept in the state_dict under their flax
    names) that receive no gradient: as in the JAX package with ``learn_std``
    and ``learn_bg_std`` False, their defaults and the only setting any
    config uses.  Learnable stds are not ported and raise.
    """

    def __init__(self, img_size, glimpse_size, n_what, glimpse_n_hiddens,
                 glimpse_output_scale=0.25, mean_img: Optional[np.ndarray] = None,
                 output_std=0.3, learn_std=False, learn_bg_std=False):
        super().__init__()
        if learn_std or learn_bg_std:
            raise ValueError("learnable decoder stds (learn_std, learn_bg_std) are not "
                             "ported yet")
        self.img_size, self.glimpse_size = tuple(img_size), tuple(glimpse_size)
        self._glimpse_decoder = Decoder(n_what, glimpse_n_hiddens, self.glimpse_size,
                                        glimpse_output_scale)
        if mean_img is not None:
            mean = torch.as_tensor(np.asarray(mean_img, np.float32))
            self.add_param("mean_img", mean.shape, lambda t, g: t.copy_(mean))
        self.has_mean_img = mean_img is not None
        # sqrt reparametrisation of the stds (learn_std and min_std are off)
        self.add_param("output_std", (), const(math.sqrt(output_std)))
        self.add_param("background_std", (), const(math.sqrt(output_std)))

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
        # the JAX package stops the gradient of both stds (learn_std and
        # learn_bg_std are False)
        fg, bg = self.output_std.detach()**2, self.background_std.detach()**2
        std = written_to_mask * fg + (1.0 - written_to_mask) * bg
        return D.Normal(canvas, std), glimpse
