"""The plain train step: the loss, PyTorch's autograd and TF-style RMSProp
(a frozen copy of the arithmetic of the program's ``training/train.py``),
driven step by step from given weights, batches and noise.

RMSProp as TensorFlow's RMSPropOptimizer (decay 0.9, momentum 0.9, eps
1e-10, the mean square starting at ones):

    nu <- 0.9 nu + 0.1 g^2
    m  <- -lr g / sqrt(nu + eps) + 0.9 m
    p  <- p + m
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from .models import Model

DECAY, EPS, MOMENTUM = 0.9, 1e-10, 0.9


def precision(tf32: bool):
    """float32 products in full float32 (``tf32`` False, as configured) or
    in TF32 (the control one step below)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def learning_rate(F: Mapping, count: int) -> float:
    """The rate at optimizer count ``count``: ``learning_rate`` times 1/3 at
    each boundary of the piecewise ``schedule`` (cumulative proportions of
    ``train_itr``) passed."""
    lr = float(F["learning_rate"])
    if not F.get("schedule"):
        return lr
    props = [float(f) for f in str(F["schedule"]).split(",")]
    cum = np.cumsum(props)
    bounds = np.round(cum * int(F["train_itr"]) / cum[-1]).astype(np.int64)[:-1]
    return lr * (1.0 / 3.0) ** sum(count >= int(b) for b in bounds)


def follow(model: Model, F: Mapping, batches: Sequence[Dict[str, torch.Tensor]],
           noises: Sequence, step_hook: Callable = None) -> Dict:
    """Trains ``model`` from its current weights for ``len(batches)`` steps.

    :param batches: each step's dict(imgs [T, B, H, W], nums [T, B, C])
    :param noises: each step's noise source
    :param step_hook: (step index, {name: gradient}) -> gradients to apply
        (a planted fault; None applies them as they are)
    :return: dict(losses [float per step], grads {name: the first step's
        gradient}, params {name: the weights after the last step})
    """
    named = [(n, p) for n, p in model.sequence.named_parameters()]
    nu = {n: torch.ones_like(p) for n, p in named}
    trace = {n: torch.zeros_like(p) for n, p in named}
    l2 = float(F["l2"])
    losses: List[float] = []
    first = None
    for i, (batch, noise) in enumerate(zip(batches, noises)):
        for _, p in named:
            p.grad = None
        target, _ = model.loss_and_metrics(batch["imgs"], noise, batch["nums"],
                                           l2_weight=l2, record_mode="train")
        target.backward()
        losses.append(float(target.detach()))
        grads = {n: p.grad.detach().clone() for n, p in named if p.grad is not None}
        if step_hook is not None:
            grads = step_hook(i, grads)
        if first is None:
            first = grads
        lr = learning_rate(F, i)
        with torch.no_grad():
            for n, p in named:
                if n not in grads:
                    continue
                g = grads[n]
                nu[n].mul_(DECAY).add_((1.0 - DECAY) * g * g)
                trace[n].mul_(MOMENTUM).add_(-lr * g * torch.rsqrt(nu[n] + EPS))
                p.add_(trace[n])
    params = {n: p.detach().clone() for n, p in named}
    return dict(losses=losses, grads=first, params=params)
