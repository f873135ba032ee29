"""Object trajectory simulation (a copy of the numpy
``NoisyAccelerationTrajectory`` of sqair_tpu/data/trajectory.py)."""
from __future__ import annotations

import numpy as np


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
