"""Object trajectory simulation (the port of sqair_tpu/data/trajectory.py):
``NoisyAccelerationTrajectory`` on the host (a copy of the numpy class,
the same bytes) and ``noisy_acceleration``, the same dynamics on the
device for the on-device data pipeline, with its draws
(``draw_noisy_acceleration``) taken apart from the arithmetic."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class NoisyAccelerationTrajectory:
    """2-D (pos, vel, acc) dynamics with accel noise, clamps and elastic
    bouncing (reference: trajectory.py:109-143)."""

    def __init__(self, noise_std, n_dim, pos_bounds, max_speed, max_acc, bounce=False):
        self._noise_std = noise_std
        self._n_dim = n_dim
        self._bounce = bounce
        bounds = list(pos_bounds) + [[-max_speed, max_speed]] * n_dim + [
            [-max_acc, max_acc]
        ] * n_dim
        self._bounds = np.asarray(bounds, np.float64)
        self._n_state = 3 * n_dim

    def _clip(self, state):
        return np.clip(state, self._bounds[:, 0], self._bounds[:, 1])

    def _forward(self, state, rng):
        acc_noise = rng.normal(0, self._noise_std, size=(state.shape[0], self._n_dim))
        pos, vel, acc = np.split(state.copy(), 3, -1)
        pos += vel
        vel += acc
        acc += acc_noise

        if self._bounce:
            for d in range(self._n_dim):
                lo, hi = self._bounds[d]
                too_small = pos[:, d] < lo
                too_big = pos[:, d] > hi
                pos[too_small, d] = 2 * lo - pos[too_small, d]
                pos[too_big, d] = 2 * hi - pos[too_big, d]
                flipped = np.logical_or(too_small, too_big)
                vel[flipped, d] *= -1
                acc[flipped, d] *= -1

        return np.concatenate([pos, vel, acc], -1)

    def forward(self, state, rng):
        state = self._clip(self._forward(state, rng))
        return state[:, : self._n_dim].copy(), state

    def create(self, n_timesteps, n_trajectories=1, init_from=None, seed=None):
        """:return: [n_timesteps, n_trajectories, n_dim] float32"""
        rng = np.random.RandomState(seed)
        state = rng.uniform(size=(n_trajectories, self._n_state))
        lo, hi = self._bounds[:, 0], self._bounds[:, 1]
        state = lo + state * (hi - lo)

        tjs = np.empty((n_timesteps, n_trajectories, self._n_dim), np.float32)
        tjs[0], state = self.forward(state, rng)
        if init_from is not None:
            tjs[0] = init_from
            state[:, : self._n_dim] = np.asarray(init_from, np.float64)

        for t in range(1, n_timesteps):
            tjs[t], state = self.forward(state, rng)
        return tjs


def draw_noisy_acceleration(generator: torch.Generator, n_timesteps: int, n: int,
                            max_speed: float, max_acc: float) -> Dict:
    """The random draws of ``noisy_acceleration`` for ``n`` trajectories,
    from ``generator`` on its device: vel and acc [n, 2] uniform in
    [-max_speed, max_speed] and [-max_acc, max_acc], and the acceleration
    noise [n_timesteps - 1, n, 2], standard normal."""
    device = generator.device

    def uniform(bound):
        return (2.0 * torch.rand((n, 2), generator=generator, device=device) - 1.0) * bound

    vel, acc = uniform(max_speed), uniform(max_acc)
    noise = torch.randn((n_timesteps - 1, n, 2), generator=generator, device=device)
    return dict(vel=vel, acc=acc, noise=noise)


def noisy_acceleration(init_pos: torch.Tensor, vel: torch.Tensor, acc: torch.Tensor,
                       noise: torch.Tensor, pos_bounds, max_speed: float, max_acc: float,
                       noise_std: float = 0.01) -> torch.Tensor:
    """The device trajectory (the port of the JAX package's
    ``jax_noisy_acceleration``): the same (pos, vel, acc) dynamics with
    elastic bounces and clamps, on the draws' device.

    :param init_pos: [N, 2] initial positions (y, x)
    :param vel, acc: [N, 2] initial velocity and acceleration
    :param noise: [T - 1, N, 2] standard-normal acceleration noise
    :param pos_bounds: [2, 2] per-dimension (lo, hi)
    :return: [T, N, 2] float32 positions
    """
    bounds = torch.tensor(pos_bounds, dtype=torch.float32, device=init_pos.device)
    lo, hi = bounds[:, 0], bounds[:, 1]
    pos = init_pos.to(torch.float32)
    vel, acc = vel.to(torch.float32), acc.to(torch.float32)
    out = [pos]
    for eps in noise.to(torch.float32):
        pos = pos + vel
        vel = vel + acc
        acc = acc + noise_std * eps
        # elastic bounce off the bounds
        too_small, too_big = pos < lo, pos > hi
        pos = torch.where(too_small, 2 * lo - pos, pos)
        pos = torch.where(too_big, 2 * hi - pos, pos)
        flip = too_small | too_big
        vel = torch.where(flip, -vel, vel)
        acc = torch.where(flip, -acc, acc)
        # clamps
        pos = torch.minimum(torch.maximum(pos, lo), hi)
        vel = torch.clamp(vel, -max_speed, max_speed)
        acc = torch.clamp(acc, -max_acc, max_acc)
        out.append(pos)
    return torch.stack(out, 0)
