"""Misc math ops (the port of sqair_tpu/ops/math.py)."""
from __future__ import annotations

import torch


def clip_preserve(expr: torch.Tensor, lo, hi) -> torch.Tensor:
    """Clips the value but keeps the unclipped gradient (straight-through)."""
    return (torch.clamp(expr, lo, hi) - expr).detach() + expr


def ess(weights: torch.Tensor, average: bool = False) -> torch.Tensor:
    """Effective sample size ``(sum w)^2 / sum w^2`` over the last axis."""
    res = torch.sum(weights, -1) ** 2 / torch.sum(weights**2, -1)
    if average:
        res = torch.mean(res)
    return res


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as jax.nn.softplus computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))
