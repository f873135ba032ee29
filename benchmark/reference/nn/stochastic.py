"""Stochastic modules: parametrised distributions (the port of
sqair_tpu/nn/stochastic.py)."""
from __future__ import annotations

import math
import torch

from ..ops import distributions as D
from ..ops.math import softplus
from ..ops.noise import NoiseSource
from .layers import (MLP, Dense, Module, VanillaRNN, const, glorot_uniform,
                     truncated_normal, zeros)


class GaussianFromParamVec(Module):
    """Diagonal Gaussian from a feature vector: a Dense layer to 2 n_dim
    (unless the input has that width already), then
    scale = softplus(s) + 1e-2."""

    def __init__(self, d_in, n_dim):
        super().__init__()
        self.n_dim = n_dim
        if d_in != 2 * n_dim:
            self.Dense_0 = Dense(d_in, 2 * n_dim)

    def forward(self, x) -> D.Normal:
        if hasattr(self, "Dense_0"):
            x = self.Dense_0(x)
        loc, scale = torch.chunk(x, 2, -1)
        return D.Normal(loc, softplus(scale) + 1e-2)


class StochasticTransformParam(Module):
    """MLP -> (where loc, where scale logit + a learned offset)."""

    def __init__(self, d_in, n_hiddens, scale_offset=-2.0):
        super().__init__()
        self.MLP_0 = MLP(d_in, n_hiddens, n_out=8)
        self.add_param("scale_offset", (), const(scale_offset))

    def forward(self, x):
        params = self.MLP_0(x)
        return params[..., :4], params[..., 4:] + self.scale_offset


class StepsPredictor(Module):
    """Presence logit MLP; ``logit = prev logit + (prev - 1) 88`` keeps dead
    objects dead (sigmoid(-88) is 0 in f32 while the logit stays finite)."""

    def __init__(self, d_in, n_hiddens, steps_bias=0.0,
                 max_rel_logit_change=math.inf, max_logit_change=math.inf):
        super().__init__()
        self.MLP_0 = MLP(d_in, n_hiddens, n_out=1, output_bias_init=const(steps_bias))
        self.max_rel_logit_change = max_rel_logit_change
        self.max_logit_change = max_logit_change

    def forward(self, previous_presence, previous_logit, *features,
                extra_logit=0.0, logit_scale=1.0, logit_clamp=None) -> D.Bernoulli:
        """:param extra_logit: additive logit offset (before the dead lock)
        :param logit_scale: multiplicative logit factor
        :param logit_clamp: straight-through |logit| cap (None = off)"""
        logit = self.MLP_0(torch.cat(features, -1))
        logit = logit * logit_scale
        if logit_clamp is not None:
            clipped = torch.clamp(logit, -logit_clamp, logit_clamp)
            logit = logit + (clipped - logit).detach()
        logit = logit + extra_logit
        logit = previous_presence * logit + (previous_presence - 1.0) * 88.0
        if previous_logit is not None:
            if self.max_rel_logit_change != math.inf:
                lo = (1.0 - self.max_rel_logit_change) * previous_logit
                hi = (1.0 + self.max_rel_logit_change) * previous_logit
                logit = torch.minimum(torch.maximum(logit, lo), hi)
            elif self.max_logit_change != math.inf:
                logit = previous_logit + self.max_logit_change * torch.tanh(logit)
        return D.Bernoulli(logits=logit)


class AffineDiagNormal(Module):
    """MVN whose scale is a learned shared lower-triangular matrix with each
    row i scaled by scale_i, plus diag(scale)."""

    def __init__(self, n_dim=4):
        super().__init__()
        self.n_dim = n_dim
        self.add_param("cholesky_scale", (n_dim * (n_dim + 1) // 2, 1), glorot_uniform)

    def forward(self, loc, scale) -> D.MultivariateNormalTriL:
        tril = D.fill_triangular(self.cholesky_scale[:, 0], self.n_dim)
        batch_tril = tril * scale[..., :, None] + torch.diag_embed(scale)
        return D.MultivariateNormalTriL(loc, batch_tril)


class RecurrentNormalImpl(Module):
    """Conditional autoregressive Normal: the initial state comes from
    [h0, conditioning] through a two-layer projection back to the RNN's
    width; then a VanillaRNN over the previous sample and a Dense readout to
    (loc, softplus(scale) + 1e-2)."""

    def __init__(self, n_dim, n_hidden, d_cond, output_bias_init=zeros):
        super().__init__()
        self.n_dim = n_dim
        self._rnn = VanillaRNN(n_dim, n_dim)
        self._readout = Dense(n_dim, 2 * n_dim, bias_init=output_bias_init)
        self.add_param("init_sample", (1, n_dim), truncated_normal(1.0))
        self._cond_hidden = Dense(n_dim + d_cond, n_hidden)
        self._cond_out = Dense(n_hidden, n_dim)

    def _initial(self, batch_size, conditioning):
        sample = self.init_sample.expand(batch_size, self.n_dim)
        (state,) = self._rnn.initial_state(batch_size)
        h = torch.cat([state, conditioning], -1)
        return sample, self._cond_out(torch.nn.functional.elu(self._cond_hidden(h)))

    def _step(self, sample_m1, state):
        """(the next step's Normal, the new state)"""
        (state,), out = self._rnn((state,), sample_m1)
        loc, scale = torch.chunk(self._readout(out), 2, -1)
        return D.Normal(loc, softplus(scale) + 1e-2), state

    def log_prob(self, samples, conditioning):
        """log-probs [B, L, n_dim] of given samples [B, L, n_dim]."""
        sample, state = self._initial(samples.shape[0], conditioning)
        logps = []
        for i in range(samples.shape[-2]):
            pdf, state = self._step(sample, state)
            sample = samples[..., i, :]
            logps.append(pdf.log_prob(sample))
        return torch.stack(logps, -2)

    def sample(self, noise: NoiseSource, batch_size: int, seq_len: int, conditioning):
        """Samples [B, L, n_dim], each step's fed back into the RNN; step i
        takes its standard-normal noise from ``noise.normal(i, [B, n_dim])``
        (the JAX package draws it under ``fold_in(rng, i)``)."""
        sample, state = self._initial(batch_size, conditioning)
        samples = []
        for i in range(seq_len):
            pdf, state = self._step(sample, state)
            sample = pdf.sample(noise.normal(i, (batch_size, self.n_dim)))
            samples.append(sample)
        return torch.stack(samples, -2)


class RecurrentNormal:
    """The distribution's interface over a ``RecurrentNormalImpl``."""

    def __init__(self, impl: RecurrentNormalImpl):
        self._impl = impl

    def log_prob(self, samples, conditioning):
        return self._impl.log_prob(samples, conditioning)

    def sample(self, noise: NoiseSource, name, sample_size=(1, 1), conditioning=None):
        """Samples [n, length, n_dim]; step i's noise under (name, i)."""
        n, length = sample_size
        return self._impl.sample(noise.scope(name), n, length, conditioning)


class ConditionedNormalAdaptor(D.Normal):
    """A Normal that ignores a ``conditioning`` argument, so that it stands
    where a ``RecurrentNormal`` would."""

    def log_prob(self, x, conditioning=None):
        return super().log_prob(x)

    def sample(self, noise: NoiseSource, name, sample_size=(), conditioning=None):
        """Samples [*sample_size, *shape], one draw of noise under ``name``."""
        return super().sample(noise.normal(name, tuple(sample_size) + tuple(self.shape)))
