"""Pedestrian model config (the port of
sqair_tpu/configs/pedestrian_model.py): ``mlp_mnist_model`` with a
non-square glimpse, 32x12 by default (flag ``glimpse_hw``), in place of
the square ``glimpse_size``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from ..experiment import flags
from . import mlp_mnist_model
from .mlp_mnist_model import make_optimizer, train_settings  # noqa: F401 (config contract)
from .pedestrian_data import parse_hw

PED_MODEL_DEFAULTS = flags.define_all((
    (str, "glimpse_hw", "32,12", "Non-square glimpse size h,w."),
))


def load(flags: Mapping, img_shape: Sequence[int], mean_img: Optional[np.ndarray] = None,
         device="cuda", seed: int = 0):
    """``mlp_mnist_model.load`` with the glimpse of ``glimpse_hw``."""
    gh, gw = parse_hw(mlp_mnist_model.given(flags).get("glimpse_hw",
                                                       PED_MODEL_DEFAULTS["glimpse_hw"]))
    return mlp_mnist_model.load(flags, img_shape, mean_img, device, seed,
                                glimpse_size=[gh, gw])
