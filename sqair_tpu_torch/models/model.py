"""Model: IWAE particles, bounds, importance-weighted metrics and the VIMCO
target (the port of sqair_tpu/models/model.py)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops import indexing, targets
from ..ops import math as ops_math
from ..ops.noise import NoiseSource
from .seq import SequentialAIR


# the record's fields that the figures read, one particle an example
RENDERED = ("obj_id", "canvas", "glimpse", "presence_prob", "presence", "presence_logit",
            "where")


def resampling_index(importance_weights, noise: NoiseSource) -> torch.Tensor:
    """[B] particle index drawn from the [B, k] normalised importance
    weights: the Gumbel-max draw of the JAX package's
    ``jax.random.categorical(fold_in(rng, 0x5e5a), log(w + 1e-38))``, its
    uniform [B, k] under the key "resample" (as JAX's gumbel takes it, in
    [tiny, 1))."""
    tiny = torch.finfo(importance_weights.dtype).tiny
    u = torch.clamp(noise.uniform("resample", importance_weights.shape), min=tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + torch.log(importance_weights + 1e-38), -1)


class Model:
    """IWAE/VIMCO wrapper around SequentialAIR.

    :param transient_horizon: frames [0, H) are compared with frame H in the
        ``transient_excess`` metric
    """

    def __init__(self, sequence: SequentialAIR, k_particles: int = 5,
                 aspect_penalty: float = 0.0, transient_penalty: float = 0.0,
                 transient_horizon: int = 2, transient_temp: float = 1.0):
        self.sequence = sequence
        self.k_particles = k_particles
        self.aspect_penalty = aspect_penalty
        self.transient_penalty = transient_penalty
        self.transient_horizon = transient_horizon
        self.transient_temp = transient_temp

    @property
    def device(self):
        return next(self.sequence.parameters()).device

    @property
    def dtype(self):
        return next(self.sequence.parameters()).dtype

    @staticmethod
    def finalize_metrics(metrics):
        """Turns the aspect ratio's parts into the ratio."""
        m = dict(metrics)
        if "aspect_sq_sum" in m:
            m["aspect"] = m.pop("aspect_sq_sum") / torch.clamp(m.pop("aspect_n"), min=1.0)
        return m

    def forward(self, obs, noise: NoiseSource, record_mode: str = "full") -> Dict:
        """:param obs: [T, B, H, W] -> outputs with [T, B*k, ...] leaves"""
        tiled_obs = indexing.tile_input_for_iwae(obs, self.k_particles, with_time=True)
        outputs = self.sequence(tiled_obs, noise, record_mode=record_mode)
        outputs["tiled_obs"] = tiled_obs
        return outputs

    def loss_and_metrics(self, obs, noise: NoiseSource, gt_presence=None,
                         l2_weight: float = 0.0, record_mode: str = "full",
                         render: bool = False, group=None) -> Tuple[torch.Tensor, Dict]:
        """The VIMCO target and the JAX package's metric set.

        :param obs: [T, B, H, W]
        :param gt_presence: [T, B, C] cumulative one-hot object counts
        :param l2_weight: weight of an L2 penalty on every parameter
        :param record_mode: "full", or "train" (the same target and metrics,
            without the per-frame count metrics ``num_step_acc_per_t`` and
            ``num_steps_per_t``)
        :param render: (record_mode "full") also draw one particle of each
            example by its importance weight (``resampling_index``) and
            return the figures' tensors under "render"
        :param group: when the step runs on one shard of a batch split over
            processes (``parallel.make_parallel_train_step``), their
            ``parallel.Mesh``: the aspect PENALTY is then
            the global batch's ratio, the local numerator over the count of
            present objects summed over every process, times the number of
            processes, so that the mean of the processes' gradients is the
            gradient of the global ratio (JAX's ``axis_name``).  The metrics
            keep the ratio's parts, for ``finalize_metrics`` after the
            reduction.
        :return: (target, dict(metrics=..., log_weights=[B, k][, render=...]))
        """
        k = self.k_particles
        T, B = obs.shape[0], obs.shape[1]
        outputs = self.forward(obs, noise, record_mode)

        log_weights = torch.sum(outputs["log_weights_per_timestep"], 0).reshape(B, k)
        elbo_vae = torch.mean(log_weights)
        elbo_iwae_per_example = targets.iwae(log_weights)
        elbo_iwae = torch.mean(elbo_iwae_per_example)
        metrics = dict(vae=elbo_vae, iwae=elbo_iwae, normalised_vae=elbo_vae / T,
                       normalised_iwae=elbo_iwae / T)

        importance_weights = F.softmax(log_weights, -1).detach()
        metrics["ess"] = ops_math.ess(importance_weights, average=True)

        def imp_weighted_mean(tensor):
            t = torch.mean(tensor.reshape(-1, B, k), 0)
            return torch.mean(importance_weights * t * k)

        for name, key in (
            ("data_ll", "data_ll_per_sample"),
            ("log_p_z", "log_p_z_per_sample"),
            ("log_q_z_given_x", "log_q_z_given_x_per_sample"),
            ("kl", "kl_per_sample"),
            ("num_steps", "num_steps_per_sample"),
            ("num_disc_steps", "num_disc_steps_per_sample"),
            ("num_prop_steps", "num_prop_steps_per_sample"),
        ):
            metrics[name] = imp_weighted_mean(outputs[key])

        if record_mode == "train":
            mse_per_sample = torch.mean(outputs["mse_per_timestep"], 0)
        else:
            mse_per_sample = torch.mean((outputs["tiled_obs"] - outputs["canvas"]) ** 2,
                                        dim=(0, 2, 3))
        metrics["mse"] = imp_weighted_mean(mse_per_sample[None])
        metrics["raw_mse"] = torch.mean(mse_per_sample)

        if gt_presence is not None:
            gt_num_steps = torch.sum(gt_presence, -1)  # [T, B]
            num_steps = outputs["num_steps_per_sample"].reshape(-1, B, k)
            acc = (gt_num_steps[..., None] == num_steps).to(num_steps.dtype)
            metrics["raw_num_step_accuracy"] = torch.mean(acc)
            metrics["num_step_accuracy"] = imp_weighted_mean(acc)
            if record_mode != "train":
                metrics["num_step_acc_per_t"] = torch.mean(
                    importance_weights[None] * acc * k, dim=(1, 2))
                metrics["num_steps_per_t"] = torch.mean(
                    importance_weights[None] * num_steps * k, dim=(1, 2))

        discrete_log_prob = torch.sum(outputs["discrete_log_prob"], 0)
        surrogate = targets.vimco if k > 1 else targets.reinforce
        target = surrogate(log_weights, discrete_log_prob, elbo_iwae_per_example) / T
        if l2_weight:
            target = target + targets.l2_reg(self.sequence.parameters(), l2_weight)

        # mean squared log-aspect of the present glimpses
        wh = outputs["where"]
        pres = outputs["presence"].detach()
        log_aspect = F.logsigmoid(wh[..., 0]) - F.logsigmoid(wh[..., 1])
        sq = torch.sum(log_aspect**2 * pres)
        n_pres = torch.sum(pres)
        aspect = sq / torch.clamp(n_pres, min=1.0)
        if self.aspect_penalty:
            if group is not None:
                # n_pres carries no gradient: the sum needs no backward
                n_global = group.all_sum(n_pres)
                penalty_aspect = sq * group.size / torch.clamp(n_global, min=1.0)
            else:
                penalty_aspect = aspect
            target = target + self.aspect_penalty * penalty_aspect
        metrics.update(aspect=aspect, aspect_sq_sum=sq, aspect_n=n_pres)

        # expected early-frame counts in excess of the count at frame H
        pl = outputs["presence_logit"]  # [T, B*k, S]
        H = self.transient_horizon
        if pl.shape[0] > H:
            def _excess(tau):
                n_hat = torch.sum(torch.sigmoid(pl / tau), -1)
                ex = F.relu(n_hat[:H] - n_hat[H].detach()[None])
                return torch.mean(torch.sum(ex, 0))

            transient = _excess(1.0)
            metrics["transient_excess"] = transient
            if self.transient_penalty:
                pen = transient if self.transient_temp == 1.0 else _excess(self.transient_temp)
                target = target + self.transient_penalty * pen
        metrics["target"] = target
        aux = dict(metrics=metrics, log_weights=log_weights)
        if render:
            if record_mode != "full":
                raise ValueError("the render tensors need record_mode='full'")
            idx = resampling_index(importance_weights, noise) + k * torch.arange(
                B, device=obs.device)
            aux["render"] = {"resampled_" + name: torch.index_select(outputs[name], 1, idx)
                             for name in RENDERED}
            aux["render"]["obs"] = obs
        return target, aux
