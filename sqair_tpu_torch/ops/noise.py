"""Sources of the model's noise.

Every sample the model draws takes its standard-normal or uniform noise
from a source, under a key that names the draw, e.g.
``(t, "prop", slot, "where")``.  ``GeneratorNoise`` draws fresh noise from
a ``torch.Generator`` (and can record it); ``ReplayNoise`` hands back
noise given in advance, so that a run can be repeated exactly, or made to
use the noise another implementation drew.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch


class NoiseSource:
    prefix: tuple = ()

    def scope(self, *names) -> "NoiseSource":
        """A view of this source whose keys start with ``names``."""
        view = copy.copy(self)
        view.prefix = self.prefix + names
        return view

    def normal(self, name, shape) -> torch.Tensor:
        return self._draw("normal", self.prefix + (name,), tuple(shape))

    def uniform(self, name, shape) -> torch.Tensor:
        return self._draw("uniform", self.prefix + (name,), tuple(shape))

    def _draw(self, kind, key, shape):
        raise NotImplementedError


class GeneratorNoise(NoiseSource):
    """Fresh noise from ``generator`` on ``device``.

    :param record: keep every draw in ``table`` (for a later replay)
    """

    def __init__(self, generator: torch.Generator, device, record: bool = False):
        self.generator = generator
        self.device = torch.device(device)
        self.table: Optional[Dict] = {} if record else None

    def _draw(self, kind, key, shape):
        fn = torch.randn if kind == "normal" else torch.rand
        out = fn(shape, generator=self.generator, device=self.device)
        if self.table is not None:
            self.table[key] = out
        return out


class ReplayNoise(NoiseSource):
    """Noise given in advance: ``table[key]`` for every draw, handed back as
    ``dtype`` (float32 unless asked: float64 replays an f32 run's noise to a
    float64 model)."""

    def __init__(self, table: Dict, device, dtype=torch.float32):
        self.table = table
        self.device = torch.device(device)
        self.dtype = dtype

    def _draw(self, kind, key, shape):
        got = self.table[key]
        if tuple(got.shape) != shape:
            raise ValueError(f"noise {key}: shape {tuple(got.shape)}, expected {shape}")
        if isinstance(got, np.ndarray):
            got = torch.from_numpy(np.array(got, np.float32))
        return got.to(device=self.device, dtype=self.dtype)
