"""Propagation: the per-object prior and the Propagate module (the port of
sqair_tpu/models/propagate.py)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..nn.layers import GRU, Dense, Module, VanillaRNN
from ..ops import distributions as D
from ..ops.math import softplus
from ..ops.noise import NoiseSource
from .core import HIDDEN_OUTPUT_FIELDS, PropagationCore


PRIOR_MODES = ("rnn", "rw", "guided")


class PropagatePrior(Module):
    """Per-object RNN prior: (what_tm1, where_tm1) -> cell -> Dense ->
    (where loc/scale, what loc/scale, propagation logit).  Dead objects
    stay dead through the -88 logit lock.

    ``mode`` "rw" (random walk) centres what and where on their previous
    values and takes the previous presence logit + 0.1 the readout's;
    "guided" adds 0.1 the readout's locs to the previous values, with the
    same presence logit."""

    def __init__(self, n_what: int, cell, prop_logit_bias=10.0, mode="rnn"):
        super().__init__()
        if mode not in PRIOR_MODES:
            raise ValueError(f"propagation prior mode '{mode}': choose from {PRIOR_MODES}")
        self.n_what, self.prop_logit_bias, self.mode = n_what, prop_logit_bias, mode
        self.cell = cell
        self._readout = Dense(cell.units, 2 * (4 + n_what) + 1)

    def initial_state(self, batch_size: int):
        return self.cell.initial_state(batch_size)

    def forward(self, z_tm1, prior_rnn_hidden_state):
        """:param z_tm1: (what [B,S,n], where [B,S,4], presence [B,S,1],
            presence_logit [B,S,1])
        :param prior_rnn_hidden_state: state tuple of [B,S,U]
        :return: (prior stats 5-tuple, new state)"""
        what_tm1, where_tm1, presence_tm1, presence_logit_tm1 = z_tm1
        B, S = what_tm1.shape[:2]
        flat_inpt = torch.cat([what_tm1, where_tm1], -1).reshape(B * S, -1)
        flat_state = tuple(s.reshape(B * S, -1) for s in prior_rnn_hidden_state)
        flat_state, outputs = self.cell(flat_state, flat_inpt)
        new_state = tuple(s.reshape(B, S, -1) for s in flat_state)

        stats = self._readout(outputs.reshape(B, S, -1))
        prop_logit, stats = stats[..., :1], stats[..., 1:]
        prop_logit = prop_logit + self.prop_logit_bias
        prop_logit = presence_tm1 * prop_logit + (presence_tm1 - 1.0) * 88.0

        locs, scales = torch.chunk(stats, 2, -1)
        where_loc, what_loc = locs[..., :4], locs[..., 4:]
        where_scale = softplus(scales[..., :4]) + 1e-2
        what_scale = softplus(scales[..., 4:]) + 1e-2
        if self.mode == "rw":
            where_loc, what_loc = where_tm1, what_tm1
            prop_logit = presence_logit_tm1 + 0.1 * prop_logit
        elif self.mode == "guided":
            where_loc = where_tm1 + 0.1 * where_loc
            what_loc = what_tm1 + 0.1 * what_loc
            prop_logit = presence_logit_tm1 + 0.1 * prop_logit
        return (where_loc, where_scale, what_loc, what_scale, prop_logit), new_state

    @staticmethod
    def make_distribs(prior_stats):
        where_loc, where_scale, what_loc, what_scale, prop_logit = prior_stats
        return (D.Normal(what_loc, what_scale), D.Normal(where_loc, where_scale),
                D.Bernoulli(logits=prop_logit[..., 0]))


class Propagate(Module):
    """Propagates the existing objects through one frame."""

    def __init__(self, ssm_cell: PropagationCore, prior: PropagatePrior):
        super().__init__()
        self.ssm_cell, self.prior = ssm_cell, prior

    def prior_init_state(self, batch_size):
        return self.prior.initial_state(batch_size)

    def log_probs_only(self, presence_tm1, hidden_outputs, prior_stats, delta_what,
                       delta_where) -> Dict:
        """Posterior and prior log-probs of recorded samples and prior stats:
        the deferred pass of the train record, over [T*B, ...] stacks, with
        the same math as the in-loop path."""
        return self._compute_log_probs(presence_tm1, hidden_outputs, prior_stats,
                                       delta_what, delta_where)[1]

    def forward(self, img, z_tm1, temporal_state, prior_state, noise: NoiseSource,
                compute_log_probs: bool = True, sample_from_prior: bool = False,
                do_generate: float = 0.0) -> Dict:
        """:param img: [B, H, W]
        :param z_tm1: (what, where, presence, presence_logit), each [B, S, d]
        :param temporal_state, prior_state: state tuples of [B, S, U]
        :param noise: source scoped to this frame's propagation
        :param compute_log_probs: False leaves the log-probs to
            ``log_probs_only``
        :param sample_from_prior: also draw what, where and presence from
            the prior (noise under "prior"), and take the posterior's
            log-probs at those samples
        :param do_generate: 1 puts the prior samples in place of the
            posterior's (0 keeps the posterior's)"""
        presence_tm1 = z_tm1[2]
        prior_stats, prior_state = self.prior(z_tm1, prior_state)
        hidden_outputs, num_steps, delta_what, delta_where, temporal_state = self._ssm(
            img, z_tm1, temporal_state, noise)
        log_probs = {}
        if compute_log_probs:
            hidden_outputs, log_probs = self._compute_log_probs(
                presence_tm1, hidden_outputs, prior_stats, delta_what, delta_where,
                noise.scope("prior") if sample_from_prior else None, do_generate)
        elif sample_from_prior:
            raise ValueError("sampling from the prior needs the in-loop log-probs")
        outputs = dict(prior_stats=prior_stats, prior_state=prior_state,
                       hidden_outputs=hidden_outputs, num_steps=num_steps,
                       temporal_state=temporal_state)
        outputs.update(hidden_outputs)
        outputs.update(log_probs)
        return outputs

    def _ssm(self, img, z_tm1, temporal_state, noise):
        """Slot unroll of the propagation core, slot by slot."""
        S = z_tm1[0].shape[1]
        state = self.ssm_cell.initial_state(img)
        per_slot, new_temporal = [], []
        for k in range(S):
            z_slot = tuple(z[:, k] for z in z_tm1)
            t_slot = tuple(t[:, k] for t in temporal_state)
            outputs, state, t_new = self.ssm_cell(state, z_slot, t_slot, noise.scope(k))
            per_slot.append(outputs)
            new_temporal.append(t_new)
        stacked = {f: torch.stack([o[f] for o in per_slot], 1) for f in per_slot[0]}
        temporal_state = tuple(torch.stack([t[i] for t in new_temporal], 1)
                               for i in range(len(new_temporal[0])))
        delta_what = stacked.pop("what_sample")
        delta_where = stacked.pop("where_sample")
        num_steps = torch.sum(stacked["presence"][..., 0], -1)
        return stacked, num_steps, delta_what, delta_where, temporal_state

    def _compute_log_probs(self, presence_tm1, hidden_outputs, prior_stats, delta_what,
                           delta_where, prior_noise: Optional[NoiseSource] = None,
                           do_generate: float = 0.0):
        """(hidden outputs, log-probs).  With ``prior_noise`` the prior's
        samples are drawn and blended in by ``do_generate``; as in the JAX
        package the posterior's log-probs are then taken at the prior's
        samples, and the masks keep the posterior's presence."""
        presence = hidden_outputs["presence"][..., 0]  # [B, S]
        presence_tm1 = presence_tm1[..., 0]

        what_post = D.Normal(hidden_outputs["what_loc"], hidden_outputs["what_scale"])
        where_post = self.ssm_cell.make_where_posterior(hidden_outputs["where_loc"],
                                                        hidden_outputs["where_scale"])
        pres_post = D.Bernoulli(logits=hidden_outputs["presence_logit"][..., 0])
        what_prior, where_prior, pres_prior = PropagatePrior.make_distribs(prior_stats)

        samples = (delta_what, delta_where, presence)
        if prior_noise is not None:
            samples = (what_prior.sample(prior_noise.normal("what", what_prior.shape)),
                       where_prior.sample(prior_noise.normal("where", where_prior.shape)),
                       pres_prior.sample(prior_noise.uniform("presence",
                                                             pres_prior.logits.shape)))
            dg, ndg = do_generate, 1.0 - do_generate
            hidden_outputs = dict(hidden_outputs)
            hidden_outputs["what"] = dg * samples[0] + ndg * hidden_outputs["what"]
            hidden_outputs["where"] = dg * samples[1] + ndg * hidden_outputs["where"]
            hidden_outputs["presence"] = (dg * samples[2][..., None]
                                          + ndg * hidden_outputs["presence"])
        delta_what, delta_where, pres_sample = samples

        what_lp = torch.sum(what_post.log_prob(delta_what), -1)
        where_lp = where_post.log_prob(delta_where)  # event already reduced
        pres_lp = pres_post.log_prob(pres_sample)

        prop_prob = torch.exp(pres_lp) * presence_tm1
        mask = presence_tm1 * presence
        what_lp = what_lp * mask
        where_lp = where_lp * mask
        pres_lp = torch.sum(pres_lp * presence_tm1, -1)

        what_prior_lp = torch.sum(what_prior.log_prob(hidden_outputs["what"]), -1) * mask
        where_prior_lp = torch.sum(where_prior.log_prob(hidden_outputs["where"]), -1) * mask
        pres_prior_lp = torch.sum(pres_prior.log_prob(presence) * presence_tm1, -1)

        return hidden_outputs, dict(
            prop_prob=prop_prob,
            q_z_given_x=torch.sum(what_lp + where_lp, -1) + pres_lp,
            p_z=torch.sum(what_prior_lp + where_prior_lp, -1) + pres_prior_lp,
            what_log_prob=what_lp,
            where_log_prob=where_lp,
            prop_log_prob=pres_lp,
            what_prior_log_prob=what_prior_lp,
            where_prior_log_prob=where_prior_lp,
            prop_prior_log_prob=pres_prior_lp,
        )
