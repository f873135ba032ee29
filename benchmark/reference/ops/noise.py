"""Sources of the model's noise, by key.

Every sample the model draws takes its standard-normal or uniform noise
from a source, under a key that names the draw, e.g.
``(t, "prop", slot, "where")``.  ``TableNoise`` hands back the noise the
benchmark drew for the program's run, key by key.
"""
from __future__ import annotations

import copy
from typing import Dict

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


class TableNoise(NoiseSource):
    """``table[key]`` for every draw; a draw of another shape, or under a
    key the table lacks, raises."""

    def __init__(self, table: Dict[tuple, torch.Tensor]):
        self.table = table

    def _draw(self, kind, key, shape):
        got = self.table[key]
        if tuple(got.shape) != shape:
            raise ValueError(f"noise {key}: shape {tuple(got.shape)}, expected {shape}")
        return got
