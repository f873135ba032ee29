"""Stress-variant data config: 30%-smaller digits (the port of
sqair_tpu/configs/small_digit_seq_mnist_data.py).

Font-rendered digit glyphs at obj_size 20 (~70% of the default 28); pair
with ``small_digit_mnist_model``, which retunes the model's defaults.
"""
from __future__ import annotations

from ..experiment import flags
from .font_seq_mnist_data import load as _font_load

# module level so that the retune is active at parse time and lands in the
# run's flags.json (resume and eval rebuild the same data)
flags.set_default("font_obj_size", 20)


def load(batch_size: int, n_timesteps=None):
    return _font_load(batch_size, n_timesteps)
