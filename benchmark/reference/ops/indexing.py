"""Indexing and reordering ops (the port of sqair_tpu/ops/indexing.py).

The JAX package reorders objects with a one-hot permutation matmul, a
TPU-specific choice; here the same stable present-first order is applied
with a gather, which is exact.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def tile_input_for_iwae(x: torch.Tensor, k: int, with_time: bool = False) -> torch.Tensor:
    """Repeats each example k times along the batch axis (index b * k + j)."""
    return torch.repeat_interleave(x, k, dim=1 if with_time else 0)


def presence_order(presence: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """Indices [B, K_out] that move present objects (> 0.5) first, keeping
    the relative order inside the present and the absent groups."""
    absent = (presence <= 0.5).to(torch.int32)
    order = torch.argsort(absent, dim=1, stable=True)
    return order if top_k is None else order[:, :top_k]


def presence_sort_matrix(presence, top_k=None) -> torch.Tensor:
    """The same permutation as a [B, K_out, K] one-hot matrix."""
    return F.one_hot(presence_order(presence, top_k), presence.shape[1]).to(presence.dtype)


def select_present(tensors, presence: torch.Tensor, top_k: Optional[int] = None):
    """Stable present-first reorder (and truncation to top_k) of axis 1 of
    every tensor [B, K, ...] in a dict / tuple / list nest."""
    order = presence_order(presence, top_k)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
        return torch.take_along_dim(x, idx, dim=1)

    return take(tensors)


def compute_object_ids(last_used_id, prev_ids, propagated_pres, discovery_pres):
    """Propagated objects keep their IDs, discovered ones get fresh IDs.

    :param last_used_id: [B, 1]
    :param prev_ids, propagated_pres, discovery_pres: [B, S, 1]
    :return: (new last_used_id [B, 1], ids [B, 2S, 1])
    """
    prop_ids = prev_ids * propagated_pres - (1.0 - propagated_pres)
    id_increments = torch.cumsum(discovery_pres, 1)
    disc_ids = id_increments + last_used_id[:, None]
    last_used_id = last_used_id + id_increments[:, -1]
    disc_ids = disc_ids * discovery_pres - (1.0 - discovery_pres)
    return last_used_id, torch.cat([prop_ids, disc_ids], 1)
