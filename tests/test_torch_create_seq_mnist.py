"""``python -m sqair_tpu_torch.scripts.create_seq_mnist`` writes the same
pickles as the JAX package's script, byte for byte after unpickling: with
no MNIST idx files in the output directory (synthetic stroke templates) and
with idx files a user put there (here small fixture files in the idx
format, the train partition gzipped and the test partition raw).  Tiny
--n_train / --n_valid.
"""
import gzip
import pickle
import sys

import numpy as np
import pytest

from sqair_tpu.scripts import create_seq_mnist as jscript
from sqair_tpu_torch.data import load_pickle, make_template_bank
from sqair_tpu_torch.scripts import create_seq_mnist as pscript

ARGS = ["--n_train", "6", "--n_valid", "4", "--n_timesteps", "3", "--canvas", "40",
        "--obj_size", "14", "--name", "tiny"]


def _write_idx(path, array, magic, gz):
    header = magic.to_bytes(4, "big") + b"".join(d.to_bytes(4, "big") for d in array.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def _run_jax(out_dir, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["create_seq_mnist"] + ARGS + ["--out_dir", str(out_dir)])
    jscript.main()


@pytest.mark.parametrize("source", ["synthetic", "idx"])
def test_pickles_match_the_jax_script(source, tmp_path, monkeypatch):
    dirs = {pkg: tmp_path / pkg for pkg in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
        if source == "idx":
            digits = make_template_bank(20, 14, seed=5)
            labels = np.arange(20, dtype=np.uint8) % 10
            _write_idx(d / "train-images-idx3-ubyte.gz", digits, 2051, gz=True)
            _write_idx(d / "train-labels-idx1-ubyte.gz", labels, 2049, gz=True)
            _write_idx(d / "t10k-images-idx3-ubyte", digits[:12], 2051, gz=False)
            _write_idx(d / "t10k-labels-idx1-ubyte", labels[:12], 2049, gz=False)
    _run_jax(dirs["jax"], monkeypatch)
    pscript.main(ARGS + ["--out_dir", str(dirs["port"])])
    for partition, n in (("train", 6), ("validation", 4)):
        name = f"tiny_{partition}.pickle"
        with open(dirs["jax"] / name, "rb") as f:
            want = pickle.load(f)
        with open(dirs["port"] / name, "rb") as f:
            got = pickle.load(f)
        assert sorted(got) == sorted(want)
        for key in want:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key
        assert got["imgs"].shape == (3, n, 40, 40)
        if source == "idx":
            assert got["labels"].any()  # the idx labels, not the synthetic zeros
        # the port's loader reads what the script wrote
        loaded = load_pickle(str(dirs["port"] / name))
        assert loaded["imgs"].dtype == np.float32 and float(loaded["imgs"].max()) <= 1.0
