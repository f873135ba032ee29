"""The data configurations of this slice held to the JAX package's, byte for
byte: the stored font glyph banks (``sqair_tpu_torch/data/font_glyphs.npz``)
against a fresh render by the JAX package's ``make_font_digit_bank``; the
font data config with matplotlib hidden; the pedestrian bank and dataset;
the pedestrian and small-digit data configs' data_dicts; and every flag of
the pedestrian and small-digit configs with its type and default, and the
small-digit retunes' precedence, dumped from fresh interpreters.

The render can drift with matplotlib's version or the system's fonts: the
stored file is the fixed point, and the glyph test shows the drift when it
happens.  The data configs run at a few sequences (the ``*_samples``
flags): the same code as at their defaults.
"""
import builtins
import contextlib
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import sqair_tpu.configs.pedestrian_data as jped
import sqair_tpu.configs.small_digit_seq_mnist_data as jsmall
from sqair_tpu.data import pedestrian as jpedestrian
from sqair_tpu.data.synthetic import make_font_digit_bank as jax_font_bank
from sqair_tpu.experiment import flags as jflags
import sqair_tpu_torch.configs.font_seq_mnist_data as pfont
import sqair_tpu_torch.configs.pedestrian_data as pped
import sqair_tpu_torch.configs.small_digit_seq_mnist_data as psmall
from sqair_tpu_torch.data import create_pedestrian_dataset, make_pedestrian_bank, synthetic
from sqair_tpu_torch.experiment import flags as pflags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(font_train_samples=12, font_valid_samples=6, font_timesteps=4,
             ped_train_samples=12, ped_valid_samples=6, ped_timesteps=4, seq_len=0, stage_itr=0)


@contextlib.contextmanager
def flag_values(**values):
    """Both packages' flags at ``values``, put back afterwards."""
    saved = [(f.FLAGS, dict(f.FLAGS._values)) for f in (jflags, pflags)]
    try:
        for registry, _ in saved:
            for name, value in values.items():
                setattr(registry, name, value)
        yield
    finally:
        for registry, old in saved:
            registry._values.clear()
            registry._values.update(old)


@contextlib.contextmanager
def no_matplotlib():
    """``import matplotlib`` raises, as on a machine without it."""
    real = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
            mp.delitem(sys.modules, name)
        mp.setattr(builtins, "__import__", guarded)
        yield


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _same_data_dict(got, want):
    for split in ("train_data", "valid_data"):
        assert sorted(got[split]) == sorted(want[split]), split
        for key in want[split]:
            _same(got[split][key], want[split][key], f"{split} {key}")
    for key in ("axes", "seq_len", "stage_itr", "max_timesteps"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("size", [28, 20])
def test_stored_glyph_banks_are_the_jax_render(size):
    """The stored bank and its labels are byte for byte what the JAX
    package's renderer draws here (256 glyphs, seed 0), and the port reads
    the file for them."""
    assert (256, size, 0) in synthetic.stored_font_banks()
    want_bank, want_labels = jax_font_bank(256, size, seed=0)
    with no_matplotlib():
        bank, labels = synthetic.make_font_digit_bank(256, size, seed=0)
    _same(bank, want_bank, "bank")
    _same(labels, want_labels, "labels")
    assert len(np.unique(labels)) == 10 and bank.max() > 200


def test_font_config_needs_no_matplotlib_and_other_banks_do():
    with flag_values(**SMALL):
        want = pfont.load(4)
        with no_matplotlib():
            got = pfont.load(4)
            with pytest.raises(ImportError):
                synthetic.make_font_digit_bank(8, 28, seed=0)
    _same_data_dict(got, want)
    # an unstored bank is rendered, as the JAX package renders it
    bank, labels = synthetic.make_font_digit_bank(8, 16, seed=3)
    want_bank, want_labels = jax_font_bank(8, 16, seed=3)
    _same(bank, want_bank, "bank")
    _same(labels, want_labels, "labels")


@pytest.mark.parametrize("obj_size,seed", [((32, 12), 0), ((20, 8), 3)])
def test_pedestrian_bank_and_dataset_match_jax(obj_size, seed):
    _same(make_pedestrian_bank(9, *obj_size, seed=seed),
          jpedestrian.make_pedestrian_bank(9, *obj_size, seed=seed), "bank")
    kw = dict(n_samples=16, n_timesteps=5, canvas_size=(64, 48), obj_size=obj_size, seed=seed)
    want = jpedestrian.create_pedestrian_dataset(**kw)
    got = create_pedestrian_dataset(**kw)
    assert sorted(got) == sorted(want)
    for key in want:
        _same(got[key], want[key], key)
    assert got["imgs"].shape == (5, 16, 64, 48)


@pytest.mark.parametrize("name", ["pedestrian", "small_digit"])
def test_data_config_data_dicts_match_jax(name):
    """The pedestrian config at its canvas and at the narrow tests' 40x30;
    the small-digit config at font_obj_size 20 (its module-level retune)."""
    configs = dict(pedestrian=(pped, jped), small_digit=(psmall, jsmall))[name]
    cases = ([dict(), dict(ped_canvas="40,30", ped_seed=2)] if name == "pedestrian"
             else [dict(font_obj_size=20)])
    for extra in cases:
        with flag_values(**dict(SMALL, **extra)):
            got, want = configs[0].load(3), configs[1].load(3)
        _same_data_dict(got, want)
        if name == "small_digit":
            assert pflags.FLAGS._defs["font_obj_size"][1] == 20


CONFIGS = ("mlp_mnist_model", "pedestrian_model", "pedestrian_data",
           "small_digit_mnist_model", "small_digit_seq_mnist_data", "font_seq_mnist_data")
# the flags, with their types and defaults, and the values after the CLI's
# parse of ``argv``, in a fresh interpreter; the configs imported in the
# CLI's order (model first)
_DUMP = """
import importlib, json, sys
pkg, argv = sys.argv[1], sys.argv[2:]
for m in ["scripts.experiment"] + ["configs." + c for c in {configs!r}]:
    importlib.import_module(pkg + "." + m)
flags = importlib.import_module(pkg + ".experiment.flags")
flags.FLAGS.parse(argv)
print(json.dumps(dict(defs={{n: [t.__name__, d] for n, (t, d, _) in flags.FLAGS._defs.items()}},
                      values=flags.FLAGS.as_dict())))
"""


@functools.lru_cache(maxsize=None)
def _registry(pkg, argv=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _DUMP.format(configs=CONFIGS), pkg, *argv],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_config_flags_have_the_jax_types_and_defaults():
    want, got = _registry("sqair_tpu"), _registry("sqair_tpu_torch")
    assert set(got["defs"]) - set(want["defs"]) == {"device"}
    assert {n: got["defs"][n] for n in want["defs"]} == want["defs"]
    for name in ("ped_train_samples", "ped_valid_samples", "ped_timesteps", "ped_seed",
                 "ped_canvas", "ped_obj", "glimpse_hw"):
        assert name in got["defs"], name
    assert got["defs"]["glimpse_hw"] == ["str", "32,12"]
    assert got["defs"]["ped_canvas"] == ["str", "64,48"]


@pytest.mark.parametrize("argv", [(), ("--output_std=0.2", "--font_obj_size=24"),
                                  ("--disc_step_bias=3.5",)])
def test_small_digit_retunes_and_their_precedence_match_jax(argv):
    """The small-digit model config's retunes (disc_step_bias 2, output_std
    0.1) beat the font data config's output_std 0.15 (the model config is
    imported first; ``CONFIGS`` has no other retune of these), the data
    config's font_obj_size 20 holds, and flags on the command line win over
    both."""
    want, got = _registry("sqair_tpu", argv=argv), _registry("sqair_tpu_torch", argv=argv)
    names = ("output_std", "disc_step_bias", "font_obj_size")
    assert {n: got["values"][n] for n in names} == {n: want["values"][n] for n in names}
    given = dict(a[2:].split("=") for a in argv)
    assert got["values"]["output_std"] == float(given.get("output_std", 0.1))
    assert got["values"]["disc_step_bias"] == float(given.get("disc_step_bias", 2.0))
    assert got["values"]["font_obj_size"] == int(given.get("font_obj_size", 20))
