"""Optimisation targets: the IWAE bound, the VIMCO and REINFORCE
surrogates and the L2 penalty (the port of sqair_tpu/ops/targets.py).  Particles live on the
last axis."""
from __future__ import annotations

import math

import torch


def iwae(log_weights: torch.Tensor) -> torch.Tensor:
    """logsumexp(w) - log k."""
    k = log_weights.shape[-1]
    return torch.logsumexp(log_weights, -1) - math.log(float(k))


def vimco_control_variate(target_per_particle: torch.Tensor) -> torch.Tensor:
    """Leave-one-out baseline: particle j's log weight replaced by the mean
    of the others, then the IWAE bound."""
    k = target_per_particle.shape[-1]
    summed = torch.sum(target_per_particle, -1, keepdim=True)
    all_but_one_average = (summed - target_per_particle) / (k - 1.0)
    eye = torch.eye(k, dtype=target_per_particle.dtype,
                    device=target_per_particle.device)
    diag = eye * (all_but_one_average - target_per_particle)[..., None]
    baseline = target_per_particle[..., None] + diag
    return torch.logsumexp(baseline, -2) - math.log(float(k))


def _surrogate(log_weights, learning_signal, log_probs, elbo_iwae):
    reinforce_target = learning_signal.detach() * log_probs.reshape(log_weights.shape)
    if elbo_iwae is None:
        elbo_iwae = iwae(log_weights)
    return torch.mean(-elbo_iwae[..., None] - reinforce_target)


def vimco(log_weights, log_probs, elbo_iwae=None):
    """VIMCO surrogate loss; log_probs are those of the discrete latents."""
    return _surrogate(log_weights, log_weights - vimco_control_variate(log_weights),
                      log_probs, elbo_iwae)


def reinforce(log_weights, log_probs, elbo_iwae=None):
    """REINFORCE surrogate (the k = 1 fallback)."""
    return _surrogate(log_weights, log_weights, log_probs, elbo_iwae)


def l2_reg(params, weight: float) -> torch.Tensor:
    """0.5 weight sum ||p||^2 over the given parameters."""
    params = list(params)
    if weight == 0.0:
        return params[0].new_zeros(())
    return 0.5 * weight * sum(torch.sum(p**2) for p in params)
