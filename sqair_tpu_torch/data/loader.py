"""Dataset loading, batching and the curriculum (a copy of
sqair_tpu/data/loader.py, numpy only).

A host minibatch iterator stands in for the reference's tf.py_func; the
device-resident sampler is ``moving_mnist.DeviceDatasetSampler``.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, Optional

import numpy as np

AXES = {"imgs": 1, "labels": 0, "nums": 1, "coords": 1}


def load_pickle(path: str) -> Dict[str, np.ndarray]:
    """Loads a reference-format dataset pickle (py2 pickles supported):
    imgs -> float/255, nums -> float.  Unpickle only files that this
    project's dataset scripts wrote."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    data["imgs"] = data["imgs"].astype(np.float32) / 255.0
    data["nums"] = data["nums"].astype(np.float32)
    return dict(data)


def save_pickle(path: str, data: Dict) -> None:
    """Writes a dataset dict as a pickle that ``load_pickle`` reads."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)


def process_data(data: Dict, n_timesteps: Optional[int]) -> Dict:
    """Truncate time + zero-pad coords to n_steps."""
    if n_timesteps is not None:
        for k in ("imgs", "coords", "nums"):
            if k in data:
                data[k] = data[k][:n_timesteps]

    if "nums" in data and "coords" in data:
        n_steps = data["nums"].shape[-1]
        to_pad = n_steps - data["coords"].shape[-2]
        if to_pad > 0:
            shape = list(data["coords"].shape)
            shape[-2] = to_pad
            zeros = np.zeros(shape, data["coords"].dtype)
            data["coords"] = np.concatenate([data["coords"], zeros], -2)
    return data


class Minibatcher:
    """Numpy minibatch iterator.

    shuffle=True: uniform sampling with replacement (as the reference).
    shuffle=False: rolling contiguous windows.
    """

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 axes: Optional[Dict[str, int]] = None, shuffle: bool = False,
                 seed: int = 0):
        self.data = {k: v for k, v in data.items() if isinstance(v, np.ndarray)}
        self.batch_size = batch_size
        self.axes = axes or {k: 0 for k in self.data}
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        key = next(iter(self.data))
        self._n = self.data[key].shape[self.axes[key]]
        self._cursor = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.shuffle:
            idx = self._rng.choice(self._n, self.batch_size)
        else:
            if self._cursor + self.batch_size > self._n:
                self._cursor = 0
            idx = np.arange(self._cursor, self._cursor + self.batch_size)
            self._cursor += self.batch_size
        return {k: v.take(idx, self.axes.get(k, 0)) for k, v in self.data.items()}


def tile_nums_over_time(data: Dict[str, np.ndarray]) -> None:
    """If nums has a singleton time axis, tile it to imgs' T.  In-place."""
    if data["imgs"].shape[0] != data["nums"].shape[0]:
        reps = [data["imgs"].shape[0]] + [1] * (data["nums"].ndim - 1)
        data["nums"] = np.tile(data["nums"], reps)


def curriculum_seq_len(global_step: int, base_seq_len: int, stage_itr: int,
                       max_len: int) -> int:
    """seq_len + global_step // stage_itr, capped.

    The stage length is host-side state: T changes every stage_itr steps,
    and the train step is built (captured) again for each stage.
    """
    if base_seq_len == 0 or stage_itr == 0:
        return max_len
    return min(base_seq_len + global_step // stage_itr, max_len)


def truncate_batch(batch: Dict[str, np.ndarray], seq_len: int) -> Dict[str, np.ndarray]:
    """Truncates every time-major tensor to its first ``seq_len`` frames."""
    return {k: v[:seq_len] for k, v in batch.items()}
