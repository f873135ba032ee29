"""Synthetic pedestrian-proxy sequences (a copy of
sqair_tpu/data/pedestrian.py, numpy only: the same bytes).

Procedurally generated pedestrian-like silhouettes (tall figures with a
head, torso and legs) walked over a non-square canvas by the
noisy-acceleration dynamics of the moving-digit data.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .moving_mnist import create_seq_dataset


def make_pedestrian_bank(n: int, th: int = 32, tw: int = 12,
                         seed: int = 0) -> np.ndarray:
    """Generates [n, th, tw] float32 silhouettes in [0, 255]."""
    rng = np.random.RandomState(seed)
    bank = np.zeros((n, th, tw), np.float32)
    yy, xx = np.mgrid[0:th, 0:tw].astype(np.float32)
    cx = (tw - 1) / 2.0

    for i in range(n):
        head_r = rng.uniform(0.14, 0.2) * th
        torso_w = rng.uniform(0.28, 0.42) * tw
        sway = rng.uniform(-0.08, 0.08) * tw

        head = ((yy - head_r) ** 2 + (xx - cx - sway) ** 2) < head_r ** 2
        torso_top, torso_bot = 2 * head_r, 0.65 * th
        torso = (
            (yy >= torso_top) & (yy < torso_bot)
            & (np.abs(xx - cx - sway * (yy / th)) < torso_w)
        )
        leg_split = rng.uniform(0.1, 0.22) * tw
        stride = rng.uniform(0.0, 0.16) * tw
        legs = (yy >= torso_bot) & (
            (np.abs(xx - cx - leg_split - stride * (yy / th - 0.65)) < 0.14 * tw)
            | (np.abs(xx - cx + leg_split + stride * (yy / th - 0.65)) < 0.14 * tw)
        )
        body = (head | torso | legs).astype(np.float32)
        texture = rng.uniform(0.6, 1.0, size=body.shape).astype(np.float32)
        bank[i] = np.clip(body * texture * 255.0, 0, 255)
    return bank


def create_pedestrian_dataset(n_samples: int = 1000, n_timesteps: int = 10,
                              canvas_size=(64, 48), obj_size=(32, 12),
                              n_objects=(0, 2), seed: int = 0) -> Dict:
    """Full sequence dataset with the same contract as create_seq_dataset."""
    bank = make_pedestrian_bank(max(64, n_samples // 8), obj_size[0],
                                obj_size[1], seed)
    return create_seq_dataset(
        n_samples=n_samples, n_timesteps=n_timesteps, canvas_size=canvas_size,
        obj_size=obj_size, n_objects=n_objects, seed=seed, templates=bank,
    )
