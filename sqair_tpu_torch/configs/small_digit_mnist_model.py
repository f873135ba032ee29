"""Stress-variant model config: 30%-smaller digits (the port of
sqair_tpu/configs/small_digit_mnist_model.py).

The whole ``mlp_mnist_model`` surface with two defaults moved for small
digits: a weaker discovery bias and a sharper likelihood.  Pair it with
``small_digit_seq_mnist_data``.  Command-line flags still win, and the
retune beats a data config's (``flags.set_default``: the first wins, and
the model config is imported first).
"""
from __future__ import annotations

from ..experiment import flags
from .mlp_mnist_model import load, make_optimizer, train_settings  # noqa: F401 (config contract)

flags.set_default("disc_step_bias", 2.0)
flags.set_default("output_std", 0.1)
