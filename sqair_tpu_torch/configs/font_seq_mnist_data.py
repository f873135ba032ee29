"""Data config: moving sequences of font-rendered digit glyphs (the port of
sqair_tpu/configs/font_seq_mnist_data.py: the same flags, the same bytes).

The glyph banks at the defaults (and at the small-digit config's
``font_obj_size`` 20) are read from the port's stored glyph file
(``data/synthetic.py``), so the config needs no matplotlib; another bank
size or seed is rendered with matplotlib.
"""
from __future__ import annotations

import numpy as np

from .. import common_model_flags  # noqa: F401  (defines output_std)
from ..data import create_seq_dataset
from ..data.mnist_tools import load as _load
from ..data.synthetic import make_font_digit_bank
from ..experiment import flags

flags.DEFINE_integer("font_train_samples", 2048, "#train sequences")
flags.DEFINE_integer("font_valid_samples", 256, "#valid sequences")
flags.DEFINE_integer("font_timesteps", 10, "sequence length")
flags.DEFINE_integer("font_seed", 0, "dataset seed")
flags.DEFINE_integer("font_bank_size", 256, "#distinct digit glyphs")
flags.DEFINE_integer("font_obj_size", 28, "digit size in pixels")

# same rationale as synth_seq_mnist_data.py: retune the likelihood width
# for the synthetic contrast
flags.set_default("output_std", 0.15)


def make_sets(F, splits=("train", "valid")):
    """{split: its raw data dict (imgs uint8 [T, N, H, W], nums [1, N, C])}
    at the font flags of ``F`` (an object with them as attributes): the
    train set from font_seed, the valid set from font_seed + 1."""
    bank, _ = make_font_digit_bank(F.font_bank_size, F.font_obj_size, seed=F.font_seed)
    obj = (F.font_obj_size, F.font_obj_size)
    return {split: create_seq_dataset(
        n_samples=getattr(F, f"font_{split}_samples"), n_timesteps=F.font_timesteps,
        obj_size=obj, seed=F.font_seed + (split == "valid"), templates=bank)
        for split in splits}


def load(batch_size: int, n_timesteps=None):
    sets = make_sets(flags.FLAGS)
    for d in sets.values():
        d["imgs"] = d["imgs"].astype(np.float32) / 255.0
        d["nums"] = d["nums"].astype(np.float32)
    return _load(batch_size, n_timesteps, train_data=sets["train"], valid_data=sets["valid"])
