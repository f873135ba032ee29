"""SequentialAIR: the timestep and the decoder unrolled over time (the port
of sqair_tpu/models/seq.py, record_mode="full").  The JAX package's
lax.scan becomes a Python loop over T; its stacked record is the same."""
from __future__ import annotations

from typing import Dict

import torch

from ..nn.layers import Module
from ..ops import stn
from ..ops.noise import NoiseSource
from .air import AIRDecoder
from .timestep import SQAIRTimestep


def _squeeze_last(x):
    return x[..., 0] if (x.ndim > 0 and x.shape[-1] == 1) else x


class SequentialAIR(Module):
    """Owns the two parameter trees of the JAX package, ``timestep`` and
    ``decoder``; its state_dict keys are the flax paths (convert.py)."""

    def __init__(self, timestep: SQAIRTimestep, decoder: AIRDecoder):
        super().__init__()
        stn.full_fp32_matmul()
        self.timestep, self.decoder = timestep, decoder

    def forward(self, obs, noise: NoiseSource) -> Dict:
        """:param obs: [T, B, H, W]
        :param noise: source of every draw, keyed (t, "prop"|"disc", slot, name)
        :return: dict of stacked per-frame records [T, ...]"""
        T, B = obs.shape[0], obs.shape[1]
        carry = self.timestep.initial_carry(B, obs.device)
        records = []
        for t in range(T):
            img = obs[t]
            out = self.timestep(img, carry["z"], carry["time_state"], carry["prior_state"],
                                carry["last_used_id"], carry["prev_ids"], t, noise.scope(t))
            z_t = out["z_t"]
            prop, disc = out["prop"], out["disc"]
            p_x_given_z, glimpse = self.decoder(z_t[0], z_t[1], z_t[2])

            data_ll = torch.sum(p_x_given_z.log_prob(img), dim=(1, 2))
            kl = out["q_z_given_x"] - out["p_z"]
            record = dict(
                what=out["what"], what_loc=out["what_loc"], what_scale=out["what_scale"],
                where=out["where"], where_loc=out["where_loc"],
                where_scale=out["where_scale"], presence_prob=out["presence_prob"],
                presence=out["presence"], presence_logit=out["presence_logit"],
                obj_id=out["obj_ids"],
                step_log_prob=out["presence_log_prob"],
                canvas=p_x_given_z.mean,
                glimpse=glimpse,
                disc_what_log_prob=disc["what_log_prob"],
                disc_where_log_prob=disc["where_log_prob"],
                disc_what_prior_log_prob=disc["what_prior_log_prob"],
                disc_where_prior_log_prob=disc["where_prior_log_prob"],
                disc_log_prob=disc["num_step_log_prob"],
                disc_prior_log_prob=disc["num_step_prior_log_prob"],
                disc_prob=disc["num_steps_prob"],
                prop_what_log_prob=prop["what_log_prob"],
                prop_where_log_prob=prop["where_log_prob"],
                prop_what_prior_log_prob=prop["what_prior_log_prob"],
                prop_where_prior_log_prob=prop["where_prior_log_prob"],
                prop_log_prob=prop["prop_log_prob"],
                prop_prior_log_prob=prop["prop_prior_log_prob"],
                prop_prob=prop["prop_prob"],
                discrete_log_prob=prop["prop_log_prob"] + disc["num_step_log_prob"],
                num_prop_steps_per_sample=prop["num_steps"],
                num_disc_steps_per_sample=disc["num_steps"],
                num_steps_per_sample=out["num_steps"],
                prop_pres=prop["hidden_outputs"]["presence"],
                disc_pres=disc["hidden_outputs"]["presence"],
                data_ll_per_sample=data_ll,
                kl_per_sample=kl,
                log_q_z_given_x_per_sample=out["q_z_given_x"],
                log_p_z_per_sample=out["p_z"],
                log_weights_per_timestep=data_ll - kl,
            )
            records.append({k: _squeeze_last(v) for k, v in record.items()})
            carry = dict(z=z_t, time_state=out["temporal_hidden_state"],
                         prior_state=out["prop_prior_state"], prev_ids=out["ids"],
                         last_used_id=out["highest_used_ids"])
        return {k: torch.stack([r[k] for r in records], 0) for k in records[0]}
