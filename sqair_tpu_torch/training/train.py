"""The eval step (the port of sqair_tpu/training/train.py:make_eval_step)."""
from __future__ import annotations

from typing import Callable

import torch

from ..models.model import Model
from ..ops.noise import NoiseSource


def make_eval_step(model: Model) -> Callable:
    """(obs [T, B, H, W], nums [T, B, C], noise) -> metrics, on the model's
    device and under ``torch.inference_mode``."""

    def eval_step(obs, nums, noise: NoiseSource):
        device = model.device
        with torch.inference_mode():
            obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
            nums = torch.as_tensor(nums, dtype=torch.float32, device=device)
            _, aux = model.loss_and_metrics(obs, noise, nums)
            return Model.finalize_metrics(aux["metrics"])

    return eval_step
