"""SQAIRTimestep: one Propagate-then-Discover step and the latent merge
(the port of sqair_tpu/models/timestep.py).  It owns the modules that
discovery and propagation share: the input and glimpse encoders and the
temporal cell.  The encoders are MLPs (``encoder_type`` "mlp") or
ConvEncoders (``"conv"``, ``conv_channels`` and ``conv_kernel``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..nn.layers import MLP, ConvEncoder, Encoder, Module, make_cell
from ..nn.stochastic import StepsPredictor, StochasticTransformParam
from ..ops import indexing
from ..ops.noise import NoiseSource
from .air import AIREncoder
from .core import HIDDEN_OUTPUT_FIELDS, DiscoveryCore, PropagationCore
from .discover import Discover
from .propagate import Propagate, PropagatePrior


class SQAIRTimestep(Module):
    """One time step of the full model.

    :param disc_coverage_signal: the discovery steps predictor also reads a
        COVERAGE_RES^2 crop of a canvas of the boxes claimed so far in the
        frame (``DiscoveryCore``), seeded with the propagated objects' boxes
    """

    def __init__(self, n_steps: int, img_size: Sequence[int], glimpse_size: Sequence[int],
                 n_what: int, n_hidden: int = 256, n_layers: int = 2,
                 steps_pred_hidden: Optional[Sequence[int]] = None,
                 transition="VanillaRNN", time_transition="GRU", prior_transition="GRU",
                 transform_var_bias=-3.0, disc_step_bias=1.0, prop_step_bias=5.0,
                 prop_prior_step_bias=10.0, prop_prior_type="rnn", step_success_prob=0.75,
                 disc_prior_type="cat", rec_where_prior=True, early_disc_step_bias=0.0,
                 early_disc_horizon=2, early_disc_logit_bias=0.0,
                 early_disc_logit_scale=1.0, early_disc_logit_clamp=0.0,
                 disc_coverage_signal=False, scale_prior: Sequence[float] = (-2.0, -2.0),
                 masked_glimpse=True, encoder_type="mlp", conv_channels=(32, 64),
                 conv_kernel=3):
        super().__init__()
        self.n_steps, self.n_what, self.n_hidden = n_steps, n_what, n_hidden
        img_size, glimpse_size = tuple(img_size), tuple(glimpse_size)
        n_hiddens = [n_hidden] * n_layers
        steps_hidden = list(steps_pred_hidden or [n_hidden // 2])
        n_img = img_size[0] * img_size[1]
        n_glimpse = glimpse_size[0] * glimpse_size[1]

        if encoder_type == "conv":
            self._input_encoder = ConvEncoder(img_size, list(conv_channels), n_features=n_hidden,
                                              kernel_shape=conv_kernel)
            glimpse_enc = ConvEncoder(glimpse_size, list(conv_channels), n_features=n_hidden,
                                      kernel_shape=conv_kernel)
        elif encoder_type == "mlp":
            self._input_encoder = Encoder(n_img, n_hiddens)
            glimpse_enc = Encoder(n_glimpse, n_hiddens)
        else:
            raise ValueError(f"Unknown encoder_type '{encoder_type}'")
        self._glimpse_encoder = AIREncoder(img_size, glimpse_size, n_what, glimpse_enc,
                                           d_mask=n_hidden, masked_glimpse=masked_glimpse)
        d_enc = self._input_encoder.d_out
        d_cov = DiscoveryCore.COVERAGE_RES**2 if disc_coverage_signal else 0

        # discovery RNN input: [image code, propagation summary, what, where, presence]
        disc_cell = DiscoveryCore(
            img_size, glimpse_size, n_what,
            transition=make_cell(transition, d_enc + n_hidden + n_what + 5, n_hidden),
            input_encoder=self._input_encoder,
            glimpse_encoder=self._glimpse_encoder,
            transform_estimator=StochasticTransformParam(n_hidden, n_hiddens,
                                                         transform_var_bias),
            steps_predictor=StepsPredictor(n_hidden + n_what + d_cov, steps_hidden,
                                           disc_step_bias),
            coverage_signal=disc_coverage_signal,
        )
        self.discover = Discover(
            n_steps, disc_cell, d_cond=n_hidden, step_success_prob=step_success_prob,
            where_mean=tuple(scale_prior) + (0.0, 0.0), disc_prior_type=disc_prior_type,
            rec_where_prior=rec_where_prior, early_disc_step_bias=early_disc_step_bias,
            early_disc_horizon=early_disc_horizon,
            early_disc_logit_bias=early_disc_logit_bias,
            early_disc_logit_scale=early_disc_logit_scale,
            early_disc_logit_clamp=early_disc_logit_clamp,
        )

        # temporal cell input: [hidden, where, glimpse what loc, glimpse what scale]
        self._temporal_cell = make_cell(time_transition, n_hidden + 4 + 2 * n_what, n_hidden)
        # propagation RNN input: [glimpse what loc, explaining-away what/where/
        # presence, previous what/where/presence, temporal state]
        prop_cell = PropagationCore(
            img_size, glimpse_size, n_what,
            transition=make_cell(transition, 3 * n_what + 10 + n_hidden, n_hidden),
            glimpse_encoder=self._glimpse_encoder,
            transform_estimator=StochasticTransformParam(2 * n_hidden + 4, n_hiddens,
                                                         transform_var_bias),
            steps_predictor=StepsPredictor(2 * n_hidden + n_what, steps_hidden,
                                           prop_step_bias),
            temporal_cell=self._temporal_cell,
        )
        prior = PropagatePrior(n_what, cell=make_cell(prior_transition, n_what + 4, n_hidden),
                               prop_logit_bias=prop_prior_step_bias, mode=prop_prior_type)
        self.propagate = Propagate(ssm_cell=prop_cell, prior=prior)

        # DeepSet summary of the propagated latents
        self._latent_encoder = MLP(n_what + 4, [n_hidden, n_hidden])

    # ------------------------------------------------------------- carry
    def initial_carry(self, batch_size: int, device, dtype=torch.float32) -> Dict:
        S = self.n_steps
        z0 = tuple(torch.zeros((batch_size, S, d), device=device, dtype=dtype)
                   for d in (self.n_what, 4, 1, 1))
        return dict(
            z=z0, time_state=self.initial_temporal_state(batch_size),
            prior_state=self.initial_prior_state(batch_size),
            prev_ids=-torch.ones((batch_size, S, 1), device=device, dtype=dtype),
            last_used_id=-torch.ones((batch_size, 1), device=device, dtype=dtype),
        )

    def _tile_slots(self, state):
        return tuple(s[:, None].expand(-1, self.n_steps, -1) for s in state)

    def initial_temporal_state(self, batch_size: int):
        return self._tile_slots(self._temporal_cell.initial_state(batch_size))

    def initial_prior_state(self, batch_size: int):
        return self._tile_slots(self.propagate.prior_init_state(batch_size))

    # -------------------------------------------------------------- step
    def forward(self, img, z_tm1, temporal_hidden_state, prop_prior_state,
                highest_used_ids, prev_ids, time_step: int, noise: NoiseSource,
                compute_log_probs: bool = True, sample_from_prior: bool = False,
                do_generate: float = 0.0) -> Dict:
        """:param noise: source scoped to this frame
        :param compute_log_probs: False returns the samples and stats only,
            with the conditioning that ``batched_log_probs`` needs to
            evaluate the log-probs later, batched over time (they never feed
            the recurrence)
        :param sample_from_prior: both modules also draw from their priors
        :param do_generate: 1 puts the prior samples in place of the
            posterior's (generation), 0 keeps the posterior's"""
        prop_output = self.propagate(img, z_tm1, temporal_hidden_state, prop_prior_state,
                                     noise.scope("prop"), compute_log_probs,
                                     sample_from_prior, do_generate)
        conditioning_from_prop = self._encode_latents(
            prop_output["what"], prop_output["where"], prop_output["presence"])

        # expected number of objects under the propagation prior conditions
        # the discovery prior
        prop_prior_step_logits = prop_output["prior_stats"][-1][..., 0]
        prop_prior_step_probs = (torch.sigmoid(prop_prior_step_logits) - 0.5) / self.n_steps
        expected_prop_prior_num_step = torch.sum(prop_prior_step_probs, -1, keepdim=True)

        disc_output = self.discover(
            img, conditioning_from_prop, time_step, expected_prop_prior_num_step,
            noise.scope("disc"), compute_log_probs, sample_from_prior, do_generate,
            prop_boxes=(prop_output["where"], prop_output["presence"]))

        (hidden_outputs, z_t, obj_ids, prop_prior_state, temporal_hidden_state,
         highest_used_ids) = self._choose_latents(prop_output, disc_output,
                                                  highest_used_ids, prev_ids)
        outputs = dict(
            hidden_outputs=hidden_outputs, obj_ids=obj_ids, z_t=z_t,
            prop_prior_state=prop_prior_state, ids=obj_ids,
            highest_used_ids=highest_used_ids, prop=prop_output, disc=disc_output,
            temporal_hidden_state=temporal_hidden_state,
        )
        if compute_log_probs:
            outputs.update(
                presence_log_prob=(prop_output["prop_log_prob"]
                                   + disc_output["num_step_log_prob"]),
                p_z=disc_output["p_z"] + prop_output["p_z"],
                q_z_given_x=disc_output["q_z_given_x"] + prop_output["q_z_given_x"],
            )
        else:
            outputs.update(conditioning_from_prop=conditioning_from_prop,
                           expected_prop_prior_num_step=expected_prop_prior_num_step)
        outputs.update(hidden_outputs)
        outputs["num_steps"] = torch.sum(hidden_outputs["presence"][..., 0], -1)
        return outputs

    def batched_log_probs(self, prop_hidden, prior_stats, presence_tm1, disc_hidden,
                          conditioning_from_prop, prior_conditioning, time_steps) -> Dict:
        """The deferred log-prob pass over flattened [T*B, ...] stacks: the
        log-probs the in-loop path would have computed, reduced to what the
        training target needs.

        :param time_steps: [T*B, 1] frame index of each row
        """
        prop_lp = self.propagate.log_probs_only(presence_tm1, prop_hidden, prior_stats,
                                                prop_hidden["what"], prop_hidden["where"])
        disc_num_steps = torch.sum(disc_hidden["presence"][..., 0], -1)
        disc_lp = self.discover.log_probs_only(disc_hidden, disc_num_steps, time_steps,
                                               conditioning_from_prop, prior_conditioning)
        return dict(
            q_z_given_x=disc_lp["q_z_given_x"] + prop_lp["q_z_given_x"],
            p_z=disc_lp["p_z"] + prop_lp["p_z"],
            discrete_log_prob=prop_lp["prop_log_prob"] + disc_lp["num_step_log_prob"],
            num_prop_steps=torch.sum(prop_hidden["presence"][..., 0], -1),
            num_disc_steps=disc_num_steps,
        )

    def _encode_latents(self, what, where, presence):
        features = self._latent_encoder(torch.cat([what, where], -1)) * presence
        return torch.sum(features, -2)

    def _choose_latents(self, prop_output, disc_output, highest_used_ids, prev_ids):
        """Concatenates propagated and discovered objects (propagated first),
        gives discoveries fresh IDs, reorders present-first (stable),
        truncates to n_steps slots and splices fresh temporal and prior
        states in for the discoveries."""
        batch_size = prev_ids.shape[0]
        temporal = tuple(torch.cat([p, f], 1) for p, f in zip(
            prop_output["temporal_state"], self.initial_temporal_state(batch_size)))
        prior_state = tuple(torch.cat([p, f], 1) for p, f in zip(
            prop_output["prior_state"], self.initial_prior_state(batch_size)))
        hidden_outputs = {
            k: torch.cat([prop_output["hidden_outputs"][k],
                          disc_output["hidden_outputs"][k]], 1)
            for k in HIDDEN_OUTPUT_FIELDS
        }
        highest_used_ids, new_obj_id = indexing.compute_object_ids(
            highest_used_ids, prev_ids, prop_output["hidden_outputs"]["presence"],
            disc_output["hidden_outputs"]["presence"])

        to_partition = dict(hidden_outputs, obj_id=new_obj_id, prior_state=prior_state,
                            temporal_state=temporal)
        partitioned = indexing.select_present(
            to_partition, hidden_outputs["presence"][..., 0], top_k=self.n_steps)
        obj_ids = partitioned.pop("obj_id")
        prior_state = partitioned.pop("prior_state")
        temporal = partitioned.pop("temporal_state")
        hidden_outputs = partitioned
        z_t = (hidden_outputs["what"], hidden_outputs["where"], hidden_outputs["presence"],
               hidden_outputs["presence_logit"])
        return hidden_outputs, z_t, obj_ids, prior_state, temporal, highest_used_ids
