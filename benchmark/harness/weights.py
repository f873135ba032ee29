"""The weights of a run, made on the device from the seed.

The reference model of the configuration names every leaf and its
initialiser (``reference/nn/layers.py``).  One standard-normal draw of all
the random leaves, clipped at 2, is cut into them and scaled: lecun normal
1/sqrt(fan-in) (fan-in: every axis but the last), glorot sqrt(2 / (fan-in
+ fan-out)), a truncated normal its own std.  Every other leaf takes its
initial constant; ``mean_img`` the data's mean frame.  The same names and
values go into the program's model and into the reference.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from reference.build import build_model
from reference.nn import layers


def _std(init, shape):
    if init is layers.lecun_normal:
        return 1.0 / math.sqrt(math.prod(shape[:-1]))
    if init is layers.glorot_uniform:
        return math.sqrt(2.0 / (shape[0] + shape[1]))
    return getattr(init, "stddev", None)


def make(config: Dict, mean_img: np.ndarray, generator: torch.Generator) -> "OrderedDict":
    """{leaf name: its value on the generator's device}."""
    device = generator.device
    model = build_model(config["model"], config["flags"], config["img_size"], "cpu",
                        mean_img=mean_img)
    leaves, random = OrderedDict(), []
    with torch.no_grad():
        for prefix, module in model.sequence.named_modules():
            for name, init in getattr(module, "_inits", {}).items():
                full = f"{prefix}.{name}" if prefix else name
                shape = tuple(getattr(module, name).shape)
                t = torch.empty(shape, dtype=torch.float32, device=device)
                std = _std(init, shape)
                if std is None:
                    init(t, None)
                else:
                    random.append((t, std))
                leaves[full] = t
        z = torch.randn(sum(t.numel() for t, _ in random), generator=generator,
                        device=device).clamp_(-2.0, 2.0)
        at = 0
        for t, std in random:
            n = t.numel()
            t.copy_(z[at:at + n].view(t.shape) * std)
            at += n
    names = [n for n, _ in model.sequence.named_parameters()]
    if sorted(names) != sorted(leaves):
        raise RuntimeError("the reference's leaves and its initialisers disagree")
    return OrderedDict((n, leaves[n]) for n in names)


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copies ``weights`` into ``module``'s parameters, name by name; the two
    must name the same leaves with the same shapes."""
    params = dict(module.named_parameters())
    if sorted(params) != sorted(weights):
        missing = sorted(set(weights) - set(params))
        extra = sorted(set(params) - set(weights))
        raise RuntimeError(f"leaves differ: the model lacks {missing}, has besides {extra}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise RuntimeError(f"{name}: shape {tuple(p.shape)}, "
                               f"weights {tuple(weights[name].shape)}")
        p.copy_(weights[name])
