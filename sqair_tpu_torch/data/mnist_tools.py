"""Moving-digit data loading with curriculum support (the port of
sqair_tpu/data/mnist_tools.py).

``load(batch_size)`` returns the data_dict contract: the train and valid
arrays, their minibatch iterators, the axes, ``seq_len``, ``stage_itr``
and ``max_timesteps``.  The curriculum length is resolved on the host per
step (``loader.curriculum_seq_len``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from ..experiment import flags
from .loader import AXES, Minibatcher, process_data, tile_nums_over_time
from .loader import load_pickle as _load_pickle

flags.DEFINE_integer("seq_len", 0,
                     "Length of loaded sequences; 0 = maximum length.")
flags.DEFINE_integer("stage_itr", 0,
                     "If > 0, curriculum: seq_len increases by 1 every stage_itr.")


def load(batch_size: int, n_timesteps: Optional[int] = None,
         train_data: Optional[Dict] = None,
         valid_data: Optional[Dict] = None) -> Dict:
    """``train_data``/``valid_data`` may be passed directly (e.g. from the
    synthetic generator) instead of pickles (``--train_path``,
    ``--valid_path``)."""
    F = flags.FLAGS

    if train_data is None:
        train_data = _load_pickle(_resolve(F.train_path))
    if valid_data is None:
        valid_data = _load_pickle(_resolve(F.valid_path))

    if F.stage_itr == 0 and n_timesteps is None and F.seq_len != 0:
        n_timesteps = F.seq_len

    process_data(train_data, n_timesteps)
    process_data(valid_data, n_timesteps)
    tile_nums_over_time(train_data)
    tile_nums_over_time(valid_data)

    train_iter = Minibatcher(train_data, batch_size, AXES, shuffle=True)
    valid_iter = Minibatcher(valid_data, batch_size, AXES, shuffle=False)

    return dict(
        train_data=train_data,
        valid_data=valid_data,
        train_iter=train_iter,
        valid_iter=valid_iter,
        axes=AXES,
        seq_len=F.seq_len,
        stage_itr=F.stage_itr,
        max_timesteps=train_data["imgs"].shape[0],
    )


def _resolve(path: str) -> str:
    if os.path.exists(path):
        return path
    here = os.path.join(os.path.dirname(__file__), "..", "..", "data", "MNIST_data")
    candidate = os.path.join(here, path)
    if os.path.exists(candidate):
        return candidate
    raise FileNotFoundError(
        f"Dataset '{path}' not found. Pass the path of a dataset pickle (imgs uint8 "
        f"[T, N, H, W], nums, coords), e.g. one that python -m "
        f"sqair_tpu_torch.scripts.create_seq_mnist wrote.")
