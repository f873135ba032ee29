"""Discovery module (the port of sqair_tpu/models/discover.py)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..nn.layers import MLP, Module, VanillaRNN, zeros
from ..nn.stochastic import ConditionedNormalAdaptor, RecurrentNormal, RecurrentNormalImpl
from ..ops import distributions as D
from ..ops import stn
from ..ops.noise import NoiseSource
from .core import HIDDEN_OUTPUT_FIELDS, DiscoveryCore, coverage_paste


class Discover(Module):
    """Discovers up to n_steps new objects in a frame, and evaluates the
    posterior and prior log-probs of what it found (in the loop, or later in
    one batched pass over every frame: ``log_probs_only``).

    The early-frame levers act for t < early_disc_horizon:
    ``early_disc_step_bias`` charges each discovery that many nats of prior
    cost (cat prior only), ``early_disc_logit_bias`` is subtracted from the
    presence logit, ``early_disc_logit_scale`` multiplies it and
    ``early_disc_logit_clamp`` caps it straight-through.

    With the cell's ``coverage_signal``, each frame's coverage canvas starts
    from the propagated objects' boxes (``prop_boxes``), and the cell adds
    this frame's discoveries slot by slot.
    """

    def __init__(self, n_steps: int, cell: DiscoveryCore, d_cond: int,
                 step_success_prob=0.75, where_mean: Sequence[float] = (-2.0, -2.0, 0.0, 0.0),
                 where_std: Sequence[float] = (1.0, 1.0, 1.0, 1.0), disc_prior_type="geom",
                 rec_where_prior=False, early_disc_step_bias=0.0, early_disc_horizon=2,
                 early_disc_logit_bias=0.0, early_disc_logit_scale=1.0,
                 early_disc_logit_clamp=0.0):
        super().__init__()
        if early_disc_step_bias and disc_prior_type != "cat":
            raise ValueError("early_disc_step_bias requires disc_prior_type='cat'")
        if disc_prior_type not in ("cat", "geom"):
            raise ValueError(f"Invalid prior type: {disc_prior_type}")
        self.n_steps, self.cell = n_steps, cell
        self.step_success_prob = step_success_prob
        self.where_mean, self.where_std = tuple(where_mean), tuple(where_std)
        self.disc_prior_type, self.rec_where_prior = disc_prior_type, rec_where_prior
        self.early_disc_step_bias = early_disc_step_bias
        self.early_disc_horizon = early_disc_horizon
        self.early_disc_logit_bias = early_disc_logit_bias
        self.early_disc_logit_scale = early_disc_logit_scale
        self.early_disc_logit_clamp = early_disc_logit_clamp
        self.coverage_signal = cell.coverage_signal
        if rec_where_prior:
            bias = torch.tensor(list(where_mean) + list(where_std))
            # the where prior is conditioned on [propagation summary, expected
            # propagated count]
            self._where_prior = RecurrentNormalImpl(
                4, 128, d_cond=d_cond + 1, output_bias_init=lambda t, g: t.copy_(bias))
        # the per-frame constants, made once on the model's device (no host
        # copy inside a step: a captured CUDA graph cannot take one); not
        # in the state_dict.  Each is cast to the type of the step's tensors
        # where it is used, to the value it had when it was made from a
        # python float there; the geometric prior's stop probability is
        # float32 whatever the model's type
        self.register_buffer("_one", torch.tensor(1.0), persistent=False)
        self.register_buffer("_zero", torch.tensor(0.0), persistent=False)
        self.register_buffer("_where_mean", torch.tensor(self.where_mean, dtype=torch.float64),
                             persistent=False)
        self.register_buffer("_where_std", torch.tensor(self.where_std, dtype=torch.float64),
                             persistent=False)
        self.register_buffer("_geom_probs", torch.tensor(1.0 - step_success_prob),
                             persistent=False)
        if disc_prior_type == "cat":
            self.add_param("step_prior_bias", (n_steps + 1,), zeros)
            init = torch.tensor([10.0] + [0.0] * n_steps)
            self.add_param("step_prior_timestep_bias", (n_steps + 1,),
                           lambda t, g: t.copy_(init))
            self._step_cond_mlp = MLP(1, [10], n_out=n_steps + 1)

    def log_probs_only(self, hidden_outputs, num_steps, time_step, conditioning_from_prop,
                       prior_conditioning) -> Dict:
        """Posterior and prior log-probs of recorded samples: the deferred
        pass of the train record, over [T*B, ...] stacks, with the same
        math as the in-loop path.

        :param time_step: [T*B, 1] frame index of each row
        """
        return self._compute_log_probs(hidden_outputs, num_steps, time_step,
                                       conditioning_from_prop, prior_conditioning)[1]

    def forward(self, img, conditioning_from_prop, time_step: int, prior_conditioning,
                noise: NoiseSource, compute_log_probs: bool = True,
                sample_from_prior: bool = False, do_generate: float = 0.0,
                prop_boxes=None) -> Dict:
        """Runs discovery for one frame.

        :param img: [B, H, W]
        :param conditioning_from_prop: [B, d] summary of the propagated objects
        :param time_step: frame index t
        :param prior_conditioning: [B, 1] expected propagated count
        :param noise: source scoped to this frame's discovery
        :param compute_log_probs: False leaves the log-probs to
            ``log_probs_only`` (the draws are the same either way)
        :param sample_from_prior: also draw what and where from the prior
            (noise under "prior"); the prior's presence is 0
        :param do_generate: 1 puts the prior's samples in place of the
            posterior's (0 keeps the posterior's)
        :param prop_boxes: (where [B, S, 4], presence [B, S, 1]) of the
            propagated objects: they seed the coverage signal's canvas
        """
        extra_steps_logit, steps_logit_scale, steps_logit_clamp = 0.0, 1.0, None
        if (self.early_disc_logit_bias or self.early_disc_logit_clamp
                or self.early_disc_logit_scale != 1.0):
            # a tensor of the frames' type (f32, as in the JAX package), so
            # that the blends below round the same way
            is_early = self._indicator(time_step < self.early_disc_horizon, img.dtype)
            if self.early_disc_logit_bias:
                extra_steps_logit = -self.early_disc_logit_bias * is_early
            if self.early_disc_logit_scale != 1.0:
                steps_logit_scale = 1.0 + is_early * (self.early_disc_logit_scale - 1.0)
            if self.early_disc_logit_clamp:
                steps_logit_clamp = self.early_disc_logit_clamp + (1.0 - is_early) * 1e4

        coverage = None
        if self.coverage_signal:
            coverage = torch.zeros_like(img)
            if prop_boxes is not None:
                where, presence = prop_boxes
                coverage = coverage_paste(coverage, stn.to_coords(where), presence,
                                          self.cell.glimpse_size)
        hidden_outputs, num_steps = self._discover(
            img, conditioning_from_prop, noise, extra_steps_logit, steps_logit_scale,
            steps_logit_clamp, coverage)
        log_probs = {}
        if compute_log_probs:
            hidden_outputs, log_probs = self._compute_log_probs(
                hidden_outputs, num_steps, time_step, conditioning_from_prop,
                prior_conditioning, noise.scope("prior") if sample_from_prior else None,
                do_generate)
        elif sample_from_prior:
            raise ValueError("sampling from the prior needs the in-loop log-probs")
        outputs = dict(hidden_outputs=hidden_outputs, num_steps=num_steps)
        outputs.update(hidden_outputs)
        outputs.update(log_probs)
        return outputs

    def _indicator(self, cond: bool, dtype) -> torch.Tensor:
        """1.0 or 0.0 as a 0-dim tensor of ``dtype`` on the model's device."""
        return (self._one if cond else self._zero).to(dtype)

    def _discover(self, img, conditioning, noise, extra_steps_logit=0.0,
                  steps_logit_scale=1.0, steps_logit_clamp=None, coverage=None):
        """Unrolls the discovery core over the object slots, slot by slot."""
        state = self.cell.initial_state(img, self.cell.encode_img(img), coverage)
        per_slot = []
        for k in range(self.n_steps):
            outputs, state = self.cell(state, conditioning, noise.scope(k),
                                       extra_steps_logit, steps_logit_scale,
                                       steps_logit_clamp)
            per_slot.append(outputs)
        hidden_outputs = {f: torch.stack([o[f] for o in per_slot], 1)
                          for f in HIDDEN_OUTPUT_FIELDS}
        num_steps = torch.sum(hidden_outputs["presence"][..., 0], -1)
        return hidden_outputs, num_steps

    def _make_steps_prior(self, time_step, prior_conditioning):
        """Geometric or learned-categorical prior of the discovery count.

        :param time_step: the frame index (in the loop) or a [N, 1] tensor of
            them (the deferred pass); both give the same logits
        """
        if self.disc_prior_type == "geom":
            return D.Geometric(probs=self._geom_probs.float())
        dtype = prior_conditioning.dtype
        in_loop = not isinstance(time_step, torch.Tensor)
        is_first = (self._indicator(time_step == 0, dtype) if in_loop
                    else (time_step == 0).to(dtype))
        step_logits = self.step_prior_bias + (1.0 - is_first) * self.step_prior_timestep_bias
        if step_logits.ndim == 1:
            step_logits = step_logits[None]
        step_logits = F.elu(step_logits + self._step_cond_mlp(prior_conditioning))
        if self.early_disc_step_bias:
            # after the elu, so that the ramp keeps its full size
            is_early = (self._indicator(time_step < self.early_disc_horizon, dtype) if in_loop
                        else (time_step < self.early_disc_horizon).to(dtype))
            ramp = -self.early_disc_step_bias * torch.arange(
                self.n_steps + 1, dtype=step_logits.dtype, device=step_logits.device)
            step_logits = step_logits + is_early * ramp
        return D.Categorical(logits=step_logits)

    def _where_prior_dist(self, dtype):
        """The where prior behind one interface: the recurrent prior, or
        N(where_mean, where_std) that ignores the conditioning."""
        if self.rec_where_prior:
            return RecurrentNormal(self._where_prior)
        return ConditionedNormalAdaptor(self._where_mean.to(dtype), self._where_std.to(dtype))

    def _where_prior_log_prob(self, where, conditioning):
        return self._where_prior_dist(where.dtype).log_prob(where, conditioning)

    def _where_prior_sample(self, noise: NoiseSource, batch_size, conditioning):
        """[B, S, 4] where samples of the prior: the recurrent prior's (step
        i's noise under ("where", i)), else one draw under "where"."""
        return self._where_prior_dist(conditioning.dtype).sample(
            noise, "where", (batch_size, self.n_steps), conditioning)

    def _compute_log_probs(self, hidden_outputs, num_steps, time_step,
                           conditioning_from_prop, prior_conditioning,
                           prior_noise: Optional[NoiseSource] = None,
                           do_generate: float = 0.0):
        """(hidden outputs, log-probs).  With ``prior_noise`` what ~ N(0, 1)
        and where from the where prior are drawn, the presence is 0, and
        ``do_generate`` blends them in; as in the JAX package the counts'
        log-probs keep the posterior's ``num_steps``, and the masks take the
        blended presence."""
        where_conditioning = torch.cat([conditioning_from_prop, prior_conditioning], -1)
        steps_prior = self._make_steps_prior(time_step, prior_conditioning)
        if prior_noise is not None:
            B, S = hidden_outputs["what"].shape[:2]
            dtype = where_conditioning.dtype
            what_p = D.Normal(self._zero.to(dtype), self._one.to(dtype)).sample(
                prior_noise.normal("what", (B, S, self.cell.n_what)))
            where_p = self._where_prior_sample(prior_noise, B, where_conditioning)
            dg, ndg = do_generate, 1.0 - do_generate
            hidden_outputs = dict(hidden_outputs)
            hidden_outputs["what"] = dg * what_p + ndg * hidden_outputs["what"]
            hidden_outputs["where"] = dg * where_p + ndg * hidden_outputs["where"]
            hidden_outputs["presence"] = dg * 0.0 + ndg * hidden_outputs["presence"]
        presence = hidden_outputs["presence"][..., 0]  # [B, S]

        what_post = D.Normal(hidden_outputs["what_loc"], hidden_outputs["what_scale"])
        where_post = D.Normal(hidden_outputs["where_loc"], hidden_outputs["where_scale"])
        steps_post = D.NumStepsDistribution(logits=hidden_outputs["presence_logit"][..., 0])

        what_lp = torch.sum(what_post.log_prob(hidden_outputs["what"]), -1) * presence
        where_lp = torch.sum(where_post.log_prob(hidden_outputs["where"]), -1) * presence
        steps_lp = steps_post.log_prob(num_steps)

        std_normal = D.Normal(self._zero.to(presence.dtype), self._one.to(presence.dtype))
        what_prior_lp = torch.sum(std_normal.log_prob(hidden_outputs["what"]), -1) * presence
        where_prior_lp = torch.sum(
            self._where_prior_log_prob(hidden_outputs["where"], where_conditioning),
            -1) * presence
        steps_prior_lp = steps_prior.log_prob(num_steps)

        return hidden_outputs, dict(
            q_z_given_x=torch.sum(what_lp + where_lp, -1) + steps_lp,
            p_z=torch.sum(what_prior_lp + where_prior_lp, -1) + steps_prior_lp,
            what_log_prob=what_lp,
            where_log_prob=where_lp,
            num_step_log_prob=steps_lp,
            what_prior_log_prob=what_prior_lp,
            where_prior_log_prob=where_prior_lp,
            num_step_prior_log_prob=steps_prior_lp,
            num_steps_prob=steps_post.probs,
        )
