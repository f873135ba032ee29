"""The port's data path (sqair_tpu_torch/data/loader.py, mnist_tools.py and
the data configs) held to the JAX package's, byte for byte: the synthetic
data config's data_dict, the shuffled and windowed minibatches, the
curriculum helpers, and a dataset pickle through ``mnist_tools.load``.
"""
import contextlib
import pickle

import numpy as np
import pytest

import sqair_tpu.configs.seq_mnist_data  # noqa: F401  (defines train_path, valid_path)
import sqair_tpu.configs.synth_seq_mnist_data as jsynth
from sqair_tpu.data import loader as jloader
from sqair_tpu.data import mnist_tools as jmnist_tools
from sqair_tpu.experiment import flags as jflags
import sqair_tpu_torch.configs.seq_mnist_data  # noqa: F401
import sqair_tpu_torch.configs.synth_seq_mnist_data as psynth
from sqair_tpu_torch.data import loader as ploader
from sqair_tpu_torch.data import mnist_tools as pmnist_tools
from sqair_tpu_torch.experiment import flags as pflags

SMALL = dict(synth_train_samples=24, synth_valid_samples=10, synth_timesteps=4, seq_len=3,
             stage_itr=0, synth_seed=3)


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


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _same_dict(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        _same(got[k], want[k], f"{what} {k}")


@pytest.mark.parametrize("seq_len, stage_itr", [(3, 0), (2, 5)])
def test_synth_data_dict_and_batches_match_jax(seq_len, stage_itr):
    with flag_values(**dict(SMALL, seq_len=seq_len, stage_itr=stage_itr)):
        want, got = jsynth.load(5), psynth.load(5)
    for split in ("train_data", "valid_data"):
        _same_dict(got[split], want[split], split)
    for key in ("axes", "seq_len", "stage_itr", "max_timesteps"):
        assert got[key] == want[key], key
    for it in ("train_iter", "valid_iter"):  # shuffled with replacement / windowed
        for i in range(4):
            _same_dict(next(got[it]), next(want[it]), f"{it} batch {i}")


def test_curriculum_and_batch_helpers_match_jax():
    for step in (0, 1, 99, 100, 101, 250, 10**6):
        for base in (0, 1, 3):
            for stage in (0, 1, 100):
                for max_len in (2, 10):
                    assert (ploader.curriculum_seq_len(step, base, stage, max_len)
                            == jloader.curriculum_seq_len(step, base, stage, max_len))
    rs = np.random.default_rng(0)
    batch = {"imgs": rs.random((5, 3, 4, 4), np.float32), "nums": rs.random((5, 3, 2))}
    for n in (1, 3, 5, 7):
        _same_dict(ploader.truncate_batch(batch, n), jloader.truncate_batch(batch, n), str(n))
    for n_timesteps in (None, 2, 4):
        for n_coords in (1, 3, 4):
            data = {"imgs": rs.random((4, 6, 5, 5), np.float32),
                    "nums": rs.random((4, 6, 4)).astype(np.float32),
                    "coords": rs.random((4, 6, n_coords, 4)).astype(np.float32)}
            want = jloader.process_data({k: v.copy() for k, v in data.items()}, n_timesteps)
            got = ploader.process_data({k: v.copy() for k, v in data.items()}, n_timesteps)
            _same_dict(got, want, f"process_data {n_timesteps} {n_coords}")
    for t_nums in (1, 4):
        data = {"imgs": np.zeros((4, 6, 5, 5), np.float32),
                "nums": rs.random((t_nums, 6, 3)).astype(np.float32)}
        want, got = {k: v.copy() for k, v in data.items()}, {k: v.copy() for k, v in data.items()}
        jloader.tile_nums_over_time(want)
        ploader.tile_nums_over_time(got)
        _same_dict(got, want, f"tile_nums_over_time {t_nums}")


def test_pickle_through_mnist_tools_matches_jax(tmp_path):
    """A dataset pickle in the reference format (uint8 frames, nums with a
    singleton time axis, coords short of the slots) that the test writes."""
    rs = np.random.default_rng(1)
    paths = {}
    for name, n in (("train", 12), ("valid", 6)):
        data = {"imgs": rs.integers(0, 256, (5, n, 20, 20), dtype=np.uint8),
                "nums": rs.integers(0, 2, (1, n, 3)).astype(np.uint8),
                "coords": rs.random((5, n, 1, 4)).astype(np.float32)}
        paths[name] = str(tmp_path / f"{name}.pickle")
        with open(paths[name], "wb") as f:
            pickle.dump(data, f, protocol=2)
    with flag_values(train_path=paths["train"], valid_path=paths["valid"], seq_len=4,
                     stage_itr=0):
        want, got = jmnist_tools.load(4), pmnist_tools.load(4)
    for split in ("train_data", "valid_data"):
        _same_dict(got[split], want[split], split)
    assert got["max_timesteps"] == want["max_timesteps"] == 4
    for i in range(3):
        _same_dict(next(got["train_iter"]), next(want["train_iter"]), f"train batch {i}")
    with flag_values(train_path=str(tmp_path / "missing.pickle")):
        with pytest.raises(FileNotFoundError):
            pmnist_tools.load(4)
