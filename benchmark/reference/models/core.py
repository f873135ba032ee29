"""Per-object inference cores for discovery and propagation (the port of
sqair_tpu/models/core.py).  Each core runs ONE slot step; Discover and
Propagate unroll the slots."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..nn.layers import MLP, Module, state_feature
from ..nn.stochastic import AffineDiagNormal, GaussianFromParamVec
from ..ops import distributions as D
from ..ops import stn
from ..ops.math import softplus
from ..ops.noise import NoiseSource

# canonical per-slot output field order (also the merge order in the timestep)
HIDDEN_OUTPUT_FIELDS = (
    "what",
    "what_loc",
    "what_scale",
    "where",
    "where_loc",
    "where_scale",
    "presence_prob",
    "presence",
    "presence_logit",
)


def coverage_paste(coverage, coords, presence, glimpse_size):
    """Max-composites presence-weighted all-ones box pastes onto a canvas.
    The paste of a glimpse of ones is the rank-1 outer product of the paste
    matrices' row sums, so a box costs two small products.

    :param coverage: [B, H, W]
    :param coords: [B, 4] or slotted [B, S, 4] ST coords
    :param presence: [B, 1] or [B, S, 1]
    :return: [B, H, W] canvas in [0, 1]
    """
    uy, ux = stn.paste_matrices(coords, glimpse_size, tuple(coverage.shape[-2:]))
    ones = torch.ones((), dtype=coverage.dtype, device=coverage.device)
    box = torch.minimum(uy.sum(-1)[..., :, None] * ux.sum(-1)[..., None, :], ones)
    box = box * presence[..., None]
    if box.ndim == coverage.ndim + 1:  # slotted: compose over S
        # amax, as jnp.max, splits the gradient evenly between ties
        box = torch.amax(box, -3)
    return torch.maximum(coverage, box)


class DiscoveryCore(Module):
    """One discovery step for one new object.

    ``input_encoder`` and ``glimpse_encoder`` are shared with propagation and
    owned by the timestep; this core holds them without registering them.

    With ``coverage_signal`` the steps predictor also reads a COVERAGE_RES x
    COVERAGE_RES crop, at the candidate box, of a canvas of the boxes
    claimed so far in the frame (the propagated objects' and this frame's
    earlier discoveries'); the core then carries the canvas in its state and
    pastes each discovery's box onto it, weighted by its presence.
    """

    COVERAGE_RES = 4

    def __init__(self, img_size, glimpse_size, n_what, transition, input_encoder,
                 glimpse_encoder, transform_estimator, steps_predictor, coverage_signal=False):
        super().__init__()
        self.img_size, self.glimpse_size, self.n_what = img_size, glimpse_size, n_what
        self.coverage_signal = coverage_signal
        self.transition = transition
        self.transform_estimator = transform_estimator
        self.steps_predictor = steps_predictor
        self.share("input_encoder", input_encoder)
        self.share("glimpse_encoder", glimpse_encoder)

    def encode_img(self, img):
        return self.input_encoder(img.reshape(img.shape[0], -1))

    def initial_state(self, img, encoded_img, coverage=None):
        """:param coverage: [B, H, W] starting canvas of the coverage signal
            (zeros if None)"""
        B = img.shape[0]
        state = dict(
            img=img, encoded_img=encoded_img,
            what=img.new_zeros((B, self.n_what)), where=img.new_zeros((B, 4)),
            presence=img.new_ones((B, 1)),  # discovery starts "present"
            rnn_state=self.transition.initial_state(B),
        )
        if self.coverage_signal:
            state["coverage"] = torch.zeros_like(img) if coverage is None else coverage
        return state

    def forward(self, state, conditioning, noise: NoiseSource, extra_steps_logit=0.0,
                steps_logit_scale=1.0, steps_logit_clamp=None) -> Tuple[Dict, Dict]:
        """:param conditioning: [B, d] summary of the propagated latents
        :param noise: source scoped to this slot ("where", "what", "presence")
        :return: (outputs with HIDDEN_OUTPUT_FIELDS, new state)"""
        img, encoded_img = state["img"], state["encoded_img"]
        rnn_inpt = torch.cat([encoded_img, conditioning, state["what"], state["where"],
                              state["presence"]], -1)
        rnn_state, hidden_output = self.transition(state["rnn_state"], rnn_inpt)

        where_loc, where_scale_logit = self.transform_estimator(hidden_output)
        where_scale = softplus(where_scale_logit) + 1e-2
        where = D.Normal(where_loc, where_scale).sample(
            noise.normal("where", where_loc.shape))

        what_distrib, _ = self.glimpse_encoder(img, where)
        what = what_distrib.sample(noise.normal("what", what_distrib.shape))

        cov_feats = ()
        if self.coverage_signal:
            # the canvas resampled over the candidate box: the low output
            # resolution is the pooling
            coords = stn.to_coords(where)
            res = self.COVERAGE_RES
            cov = stn.extract_glimpse(state["coverage"], coords, (res, res))
            cov_feats = (cov.reshape(cov.shape[0], -1),)

        pres_distrib = self.steps_predictor(
            state["presence"], None, hidden_output, what, *cov_feats,
            extra_logit=extra_steps_logit, logit_scale=steps_logit_scale,
            logit_clamp=steps_logit_clamp)
        presence = pres_distrib.sample(
            noise.uniform("presence", pres_distrib.logits.shape)) * state["presence"]

        outputs = dict(
            what=what, what_loc=what_distrib.loc, what_scale=what_distrib.scale,
            where=where, where_loc=where_loc, where_scale=where_scale,
            presence_prob=pres_distrib.probs, presence=presence,
            presence_logit=pres_distrib.logits,
        )
        new_state = dict(img=img, encoded_img=encoded_img, what=what, where=where,
                         presence=presence, rnn_state=rnn_state)
        if self.coverage_signal:
            new_state["coverage"] = coverage_paste(state["coverage"], coords, presence,
                                                   self.glimpse_size)
        return outputs, new_state


class PropagationCore(Module):
    """One propagation step for one existing object.

    ``glimpse_encoder`` and ``temporal_cell`` are shared and owned by the
    timestep, as in DiscoveryCore.
    """

    def __init__(self, img_size, glimpse_size, n_what, transition, glimpse_encoder,
                 transform_estimator, steps_predictor, temporal_cell):
        super().__init__()
        self.img_size, self.glimpse_size, self.n_what = img_size, glimpse_size, n_what
        self.transition = transition
        self.transform_estimator = transform_estimator
        self.steps_predictor = steps_predictor
        self.share("glimpse_encoder", glimpse_encoder)
        self.share("temporal_cell", temporal_cell)
        u = temporal_cell.units
        self._where_bias_mlp = MLP(u, [128], n_out=4)
        self._where_distrib = AffineDiagNormal(4)
        self._temporal_what_distrib = GaussianFromParamVec(u, n_what)
        self._gates = MLP(u, [], n_out=3 * n_what, transfer="sigmoid",
                          output_bias_init=lambda t, g: t.fill_(1.0))

    def initial_state(self, img):
        B = img.shape[0]
        return dict(
            img=img, what=img.new_zeros((B, self.n_what)), where=img.new_zeros((B, 4)),
            presence=img.new_zeros((B, 1)),  # propagation starts "absent"
            rnn_state=self.transition.initial_state(B),
        )

    def forward(self, state, z_tm1, temporal_hidden_state, noise: NoiseSource):
        """:param z_tm1: (what, where, presence, presence_logit) of this
            object at the previous frame, each [B, d]
        :param temporal_hidden_state: temporal cell state of this object
        :param noise: source scoped to this slot
        :return: (outputs incl. what_sample / where_sample, new state,
            new temporal state)"""
        what_tm1, where_tm1, presence_tm1, presence_logit_tm1 = z_tm1
        temporal_state = state_feature(temporal_hidden_state)
        img = state["img"]

        where_bias = self._where_bias_mlp(temporal_state) * 0.1
        glimpse_distrib, _ = self.glimpse_encoder(img, where_tm1 + where_bias,
                                                  mask_inpt=temporal_state)
        rnn_inpt = torch.cat([
            glimpse_distrib.loc,
            state["what"], state["where"], state["presence"],
            what_tm1, where_tm1, presence_tm1, temporal_state,
        ], -1)
        rnn_state, hidden_output = self.transition(state["rnn_state"], rnn_inpt)

        inpt = torch.cat([hidden_output, where_tm1, temporal_state], -1)
        loc_update, scale_logit = self.transform_estimator(inpt)
        where_loc = where_tm1 + loc_update
        where_scale = softplus(scale_logit - 1.0) + 1e-2
        where_posterior = self._where_distrib(where_loc, where_scale)
        where = where_posterior.sample(noise.normal("where", where_loc.shape))

        what_distrib_glimpse, _ = self.glimpse_encoder(img, where, mask_inpt=temporal_state)
        g_loc, g_scale = what_distrib_glimpse.loc, what_distrib_glimpse.scale

        temporal_inpt = torch.cat([hidden_output, where, g_loc, g_scale], -1)
        temporal_hidden_state, temporal_output = self.temporal_cell(
            temporal_hidden_state, temporal_inpt)
        temporal_distrib = self._temporal_what_distrib(temporal_output)

        gates = self._gates(temporal_output) * 0.9999
        forget_gate, input_gate, temporal_gate = torch.chunk(gates, 3, -1)
        what_loc = (forget_gate * what_tm1 + (1.0 - input_gate) * g_loc
                    + (1.0 - temporal_gate) * temporal_distrib.loc)
        what_scale = ((1.0 - input_gate) * g_scale
                      + (1.0 - temporal_gate) * temporal_distrib.scale)
        what = D.Normal(what_loc, what_scale).sample(noise.normal("what", what_loc.shape))

        pres_distrib = self.steps_predictor(presence_tm1, presence_logit_tm1,
                                            hidden_output, temporal_state, what)
        presence = pres_distrib.sample(
            noise.uniform("presence", pres_distrib.logits.shape)) * presence_tm1

        outputs = dict(
            what=what, what_sample=what, what_loc=what_loc, what_scale=what_scale,
            where=where, where_sample=where, where_loc=where_loc, where_scale=where_scale,
            presence_prob=pres_distrib.probs, presence=presence,
            presence_logit=pres_distrib.logits,
        )
        new_state = dict(img=img, what=what, where=where, presence=presence,
                         rnn_state=rnn_state)
        return outputs, new_state, temporal_hidden_state

    def make_where_posterior(self, loc, scale):
        return self._where_distrib(loc, scale)
