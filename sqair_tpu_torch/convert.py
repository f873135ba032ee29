"""Weights from the JAX package: a flax parameter tree -> a state_dict.

The port keeps the flax module and parameter names, so the conversion is a
renaming: the path ``timestep/params/_glimpse_encoder/_mask_mlp/w_0``
becomes the key ``timestep._glimpse_encoder._mask_mlp.w_0`` (the ``params``
collection level is dropped) and the array is copied as it is, since the
layouts are the same.  The tree is a nest of mappings of numpy arrays, such
as ``{"timestep": ..., "decoder": ...}`` of the JAX package's
``SequentialAIR.init`` converted with ``np.asarray``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def params_from_flax(tree: Mapping, reference: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flattens ``tree`` into a state_dict.

    :param reference: if given, the module the state_dict is for: raises on
        any missing or unexpected key and on any shape that differs
    """
    flat = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(prefix if k == "params" else prefix + (str(k),), v)
        else:
            flat[".".join(prefix)] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk((), tree)
    if reference is not None:
        expected = reference.state_dict()
        missing = sorted(set(expected) - set(flat))
        unexpected = sorted(set(flat) - set(expected))
        if missing or unexpected:
            raise KeyError(f"flax tree does not match the module: missing {missing}, "
                           f"unexpected {unexpected}")
        for k, v in flat.items():
            if tuple(v.shape) != tuple(expected[k].shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)}, module has "
                                 f"{tuple(expected[k].shape)}")
    return flat


def load_flax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Loads a flax tree into ``module`` strictly."""
    module.load_state_dict(params_from_flax(tree, module), strict=True)
    return module
