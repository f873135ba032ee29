"""Probability distributions (the port of sqair_tpu/ops/distributions.py).

Each sampler takes its noise as an argument: standard-normal ``eps`` or
uniform ``u`` of the sample's shape, drawn by the caller from a noise
source (ops/noise.py).  Each computes in the type of its parameters
(float32 in the model).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .math import clip_preserve, softplus

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class Normal:
    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return torch.broadcast_shapes(torch.as_tensor(self.loc).shape,
                                      torch.as_tensor(self.scale).shape)

    def sample(self, eps):
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z**2 - torch.log(torch.as_tensor(self.scale)) - 0.5 * _LOG_2PI

    @property
    def mean(self):
        return self.loc


@dataclass
class Bernoulli:
    """Over {0., 1.}; log_prob in the stable logits form x l - softplus(l)."""

    logits: torch.Tensor

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, u):
        return (u < torch.sigmoid(self.logits)).to(self.logits.dtype)

    def log_prob(self, x):
        return x * self.logits - softplus(self.logits)


@dataclass
class Geometric:
    """Successes before the first failure; ``probs`` is the stop probability."""

    probs: torch.Tensor

    def log_prob(self, k):
        q = torch.as_tensor(self.probs)
        return k * torch.log1p(-q) + torch.log(q)


@dataclass
class Categorical:
    logits: torch.Tensor  # [..., K]

    @property
    def log_probs(self):
        return F.log_softmax(self.logits, -1)

    def log_prob(self, k):
        idx = torch.as_tensor(k).to(torch.int64)[..., None]
        lp = self.log_probs
        idx = idx.expand(*lp.shape[:-1], 1)
        return torch.gather(lp, -1, idx)[..., 0]


@dataclass
class MultivariateNormalTriL:
    """MVN with a lower-triangular scale; |diag| in the log-determinant."""

    loc: torch.Tensor  # [..., d]
    scale_tril: torch.Tensor  # [..., d, d]

    def sample(self, eps):
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, eps)

    def log_prob(self, x):
        d = self.loc.shape[-1]
        diff = x - self.loc
        sol = torch.linalg.solve_triangular(self.scale_tril, diff[..., None],
                                            upper=False)[..., 0]
        diag = torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)
        log_det = torch.sum(torch.log(torch.abs(diag)), -1)
        return -0.5 * torch.sum(sol**2, -1) - log_det - 0.5 * d * _LOG_2PI


def fill_triangular(vec: torch.Tensor, d: int) -> torch.Tensor:
    """Packs a d(d+1)/2 vector row by row into a lower-triangular [d, d]."""
    rows, cols = torch.tril_indices(d, d, device=vec.device)
    out = vec.new_zeros(vec.shape[:-1] + (d, d))
    out[..., rows, cols] = vec
    return out


class NumStepsDistribution:
    """Distribution of the number of present objects from per-slot presence
    logits: p(0) = 1 - p_1, p(n) = (1 - p_{n+1}) prod_{i<=n} p_i,
    p(S) = prod p_i, built in log space and renormalised."""

    def __init__(self, logits: torch.Tensor):
        self._logits = logits
        log_p = F.logsigmoid(logits)
        log_ip = F.logsigmoid(-logits)
        cum = torch.cumsum(log_p, -1)
        log_pmf = torch.cat(
            [log_ip[..., :1], log_ip[..., 1:] + cum[..., :-1], cum[..., -1:]], -1)
        self._log_pmf = log_pmf - torch.logsumexp(log_pmf, -1, keepdim=True)

    @property
    def probs(self):
        return torch.exp(self._log_pmf)

    def log_prob(self, n):
        idx = torch.as_tensor(n).to(torch.int64)[..., None]
        lp = torch.gather(self._log_pmf, -1, idx)[..., 0]
        return clip_preserve(lp, math.log(1e-16), 0.0)
