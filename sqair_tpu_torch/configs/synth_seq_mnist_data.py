"""Data config that synthesises a moving-digit dataset in-process (the port
of sqair_tpu/configs/synth_seq_mnist_data.py: the same flags, the same
bytes).

Procedurally generated stroke digits through the dataset-creation
pipeline of create_seq_mnist.py; the data_dict contract of
``data/mnist_tools.load``.
"""
from __future__ import annotations

import numpy as np

from .. import common_model_flags  # noqa: F401  (defines output_std)
from ..data import create_seq_dataset
from ..data.mnist_tools import load as _load
from ..experiment import flags

# the reference's output_std=0.3 default is tuned for MNIST digits; the
# procedural stroke digits have other contrast, and 0.3 leaves the
# likelihood too flat to reward explaining objects
flags.set_default("output_std", 0.15)

flags.DEFINE_integer("synth_train_samples", 2048, "#synthetic train sequences")
flags.DEFINE_integer("synth_valid_samples", 256, "#synthetic valid sequences")
flags.DEFINE_integer("synth_timesteps", 10, "sequence length")
flags.DEFINE_integer("synth_seed", 0, "dataset seed")
flags.DEFINE_integer("synth_obj_size", 28, "digit size in pixels")


def load(batch_size: int, n_timesteps=None):
    F = flags.FLAGS
    obj = (F.synth_obj_size, F.synth_obj_size)
    train = create_seq_dataset(
        n_samples=F.synth_train_samples, n_timesteps=F.synth_timesteps,
        obj_size=obj, seed=F.synth_seed,
    )
    valid = create_seq_dataset(
        n_samples=F.synth_valid_samples, n_timesteps=F.synth_timesteps,
        obj_size=obj, seed=F.synth_seed + 1,
    )
    for d in (train, valid):
        d["imgs"] = d["imgs"].astype(np.float32) / 255.0
        d["nums"] = d["nums"].astype(np.float32)
    return _load(batch_size, n_timesteps, train_data=train, valid_data=valid)
