"""SequentialAIR: the timestep and the decoder unrolled over time (the port
of sqair_tpu/models/seq.py).  The JAX package's lax.scan becomes a Python
loop over T; its stacked records are the same.

Two record modes, as in the JAX package:
  "full"   decodes and evaluates every log-prob inside the loop and stacks
           the complete per-frame record (canvas and glimpses included);
  "train"  keeps in the loop only what feeds the recurrence and the loss,
           then runs one decode over all [T*B] frames and one batched
           log-prob pass (the decode, the discovery where prior and the
           count prior leave the loop).  The target and the metrics are the
           same as "full"'s.  Under ``sample_from_prior`` the log-probs and
           the decode stay in the loop and the record keeps the fields the
           loss and the metrics read.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..nn.layers import Module
from ..ops import stn
from ..ops.noise import NoiseSource
from .air import AIRDecoder
from .timestep import SQAIRTimestep

RECORD_MODES = ("full", "train")


def _squeeze_last(x):
    return x[..., 0] if (x.ndim > 0 and x.shape[-1] == 1) else x


def _stack(items):
    """Stacks a list of equal nests (dicts, tuples, tensors) along a new
    leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([it[i] for it in items]) for i in range(len(first)))
    return torch.stack(items, 0)


def _flatten_time(nest):
    """[T, B, ...] -> [T*B, ...] for every leaf of a nest."""
    if isinstance(nest, dict):
        return {k: _flatten_time(v) for k, v in nest.items()}
    if isinstance(nest, tuple):
        return tuple(_flatten_time(v) for v in nest)
    return nest.reshape((-1,) + nest.shape[2:])


class SequentialAIR(Module):
    """Owns the two parameter trees of the JAX package, ``timestep`` and
    ``decoder``; its state_dict keys are the flax paths (convert.py).

    :param sample_from_prior: every frame also draws its latents from the
        priors (generation); the "train" record then keeps its log-probs and
        decode in the loop, as the JAX package does
    :param generate_after: from frame ``generate_after + 1`` on, the prior
        samples take the posterior's place (if >= 0)
    """

    def __init__(self, timestep: SQAIRTimestep, decoder: AIRDecoder,
                 sample_from_prior: bool = False, generate_after: int = -1):
        super().__init__()
        self.timestep, self.decoder = timestep, decoder
        self.sample_from_prior, self.generate_after = sample_from_prior, generate_after

    def forward(self, obs, noise: NoiseSource, record_mode: str = "full") -> Dict:
        """:param obs: [T, B, H, W]
        :param noise: source of every draw, keyed (t, "prop"|"disc", slot, name),
            and under sample_from_prior (t, "prop"|"disc", "prior", ...); both
            record modes draw the same keys
        :param record_mode: "full" or "train" (see the module's docstring)
        :return: dict of stacked per-frame records [T, ...]"""
        if record_mode not in RECORD_MODES:
            raise ValueError(f"record_mode must be one of {RECORD_MODES}, got {record_mode!r}")
        deferred = record_mode == "train" and not self.sample_from_prior
        T, B = obs.shape[0], obs.shape[1]
        carry = self.timestep.initial_carry(B, obs.device, obs.dtype)
        records = []
        for t in range(T):
            img = obs[t]
            do_generate = (float(t > self.generate_after) if self.generate_after >= 0
                           else 0.0)
            out = self.timestep(img, carry["z"], carry["time_state"], carry["prior_state"],
                                carry["last_used_id"], carry["prev_ids"], t, noise.scope(t),
                                compute_log_probs=not deferred,
                                sample_from_prior=self.sample_from_prior,
                                do_generate=do_generate)
            z_t = out["z_t"]
            prop, disc = out["prop"], out["disc"]
            if deferred:
                # neither the decode nor the log-probs feed the carry: both
                # run after the loop, batched over [T*B]
                records.append(dict(
                    z_what=z_t[0], z_where=z_t[1], z_presence=z_t[2],
                    z_presence_logit=z_t[3], prop_h=prop["hidden_outputs"],
                    disc_h=disc["hidden_outputs"], prior_stats=prop["prior_stats"],
                    presence_tm1=carry["z"][2], cond_prop=out["conditioning_from_prop"],
                    prior_cond=out["expected_prop_prior_num_step"]))
            else:
                records.append(self._record(img, out, z_t, prop, disc, record_mode))
            carry = dict(z=z_t, time_state=out["temporal_hidden_state"],
                         prior_state=out["prop_prior_state"], prev_ids=out["ids"],
                         last_used_id=out["highest_used_ids"])
        if deferred:
            return self._deferred(obs, _stack(records))
        return {k: torch.stack([r[k] for r in records], 0) for k in records[0]}

    def _record(self, img, out, z_t, prop, disc, record_mode) -> Dict:
        """One frame's record, decoded in the loop: the whole record, or
        under "train" (sample_from_prior) the fields the loss and the
        metrics read."""
        p_x_given_z, glimpse = self.decoder(z_t[0], z_t[1], z_t[2])
        data_ll = torch.sum(p_x_given_z.log_prob(img), dim=(1, 2))
        kl = out["q_z_given_x"] - out["p_z"]
        common = dict(
            discrete_log_prob=prop["prop_log_prob"] + disc["num_step_log_prob"],
            num_prop_steps_per_sample=prop["num_steps"],
            num_disc_steps_per_sample=disc["num_steps"],
            num_steps_per_sample=out["num_steps"],
            data_ll_per_sample=data_ll,
            kl_per_sample=kl,
            log_q_z_given_x_per_sample=out["q_z_given_x"],
            log_p_z_per_sample=out["p_z"],
            log_weights_per_timestep=data_ll - kl,
        )
        if record_mode == "train":
            record = dict(where=z_t[1], presence=z_t[2], presence_logit=z_t[3],
                          mse_per_timestep=torch.mean((img - p_x_given_z.mean) ** 2,
                                                      dim=(1, 2)), **common)
        else:
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
                prop_pres=prop["hidden_outputs"]["presence"],
                disc_pres=disc["hidden_outputs"]["presence"],
                **common,
            )
        return {k: _squeeze_last(v) for k, v in record.items()}

    def _deferred(self, obs, rec) -> Dict:
        """The train record's batched decode and log-prob pass over the
        stacked loop record ``rec`` ([T, B, ...] leaves)."""
        T, B = obs.shape[0], obs.shape[1]
        zw, zwh, zp = rec["z_what"], rec["z_where"], rec["z_presence"]
        outputs = dict(where=zwh, presence=zp[..., 0],
                       presence_logit=rec["z_presence_logit"][..., 0])
        time_steps = torch.arange(T, dtype=obs.dtype, device=obs.device)
        time_steps = time_steps[:, None, None].expand(T, B, 1).reshape(T * B, 1)
        flat = _flatten_time
        lp = self.timestep.batched_log_probs(
            flat(rec["prop_h"]), flat(rec["prior_stats"]), flat(rec["presence_tm1"]),
            flat(rec["disc_h"]), flat(rec["cond_prop"]), flat(rec["prior_cond"]), time_steps)

        def unflat(x):
            return x.reshape(T, B)

        outputs.update(
            log_q_z_given_x_per_sample=unflat(lp["q_z_given_x"]),
            log_p_z_per_sample=unflat(lp["p_z"]),
            discrete_log_prob=unflat(lp["discrete_log_prob"]),
            num_prop_steps_per_sample=unflat(lp["num_prop_steps"]),
            num_disc_steps_per_sample=unflat(lp["num_disc_steps"]),
            num_steps_per_sample=torch.sum(zp[..., 0], -1),
        )
        p_x_given_z, _ = self.decoder(flat(zw), flat(zwh), flat(zp))
        obs_flat = flat(obs)
        data_ll = unflat(torch.sum(p_x_given_z.log_prob(obs_flat), dim=(1, 2)))
        kl = outputs["log_q_z_given_x_per_sample"] - outputs["log_p_z_per_sample"]
        outputs.update(
            data_ll_per_sample=data_ll, kl_per_sample=kl,
            mse_per_timestep=unflat(torch.mean((obs_flat - p_x_given_z.mean) ** 2,
                                               dim=(1, 2))),
            log_weights_per_timestep=data_ll - kl,
        )
        return outputs
