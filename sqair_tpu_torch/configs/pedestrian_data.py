"""Pedestrian-sequence data config (the port of
sqair_tpu/configs/pedestrian_data.py: the same flags, the same bytes).

A non-square canvas crossed by tall ~32x12 objects; the data_dict
contract of ``data/mnist_tools.load``.  See ``data/pedestrian.py``.
"""
from __future__ import annotations

import numpy as np

from ..data.mnist_tools import load as _load
from ..data.pedestrian import create_pedestrian_dataset
from ..experiment import flags

PED_DEFAULTS = flags.define_all((
    (int, "ped_train_samples", 2048, "#train sequences"),
    (int, "ped_valid_samples", 256, "#valid sequences"),
    (int, "ped_timesteps", 10, "sequence length"),
    (int, "ped_seed", 0, "dataset seed"),
    (str, "ped_canvas", "64,48", "canvas size H,W"),
    (str, "ped_obj", "32,12", "object size h,w"),
))


def parse_hw(value: str):
    """'h,w' -> (h, w)."""
    return tuple(int(v) for v in str(value).split(","))


def load(batch_size: int, n_timesteps=None):
    F = flags.FLAGS
    canvas, obj = parse_hw(F.ped_canvas), parse_hw(F.ped_obj)
    train = create_pedestrian_dataset(
        n_samples=F.ped_train_samples, n_timesteps=F.ped_timesteps,
        canvas_size=canvas, obj_size=obj, seed=F.ped_seed,
    )
    valid = create_pedestrian_dataset(
        n_samples=F.ped_valid_samples, n_timesteps=F.ped_timesteps,
        canvas_size=canvas, obj_size=obj, seed=F.ped_seed + 1,
    )
    for d in (train, valid):
        d["imgs"] = d["imgs"].astype(np.float32) / 255.0
        d["nums"] = d["nums"].astype(np.float32)
    return _load(batch_size, n_timesteps, train_data=train, valid_data=valid)
