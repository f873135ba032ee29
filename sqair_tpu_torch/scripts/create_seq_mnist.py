"""Dataset creation script (the port of sqair_tpu/scripts/create_seq_mnist.py:
the same pickles), on the host only.

Writes train and validation moving-digit pickles in the reference's
format.  It reads real MNIST idx files (raw or gzipped) where a user has
put them in ``--out_dir`` (default data/MNIST_data at the repository's
root), and otherwise draws synthetic stroke templates.  It downloads
nothing.

Run: python -m sqair_tpu_torch.scripts.create_seq_mnist [--n_train N] [--n_valid N]
"""
from __future__ import annotations

import argparse
import gzip
import os

import numpy as np

from ..data import create_seq_dataset, make_template_bank, save_pickle

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data", "MNIST_data")


def _find_idx(data_dir: str, stem: str):
    for candidate in (f"{stem}.gz", stem):
        p = os.path.join(data_dir, candidate)
        if os.path.exists(p):
            return p
    return None


def _read_idx(path: str) -> np.ndarray:
    """Parses an idx1 (labels, magic 2049) or idx3 (images, magic 2051)
    file, honouring the dimension fields in the header."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[:4], "big")
    assert magic in (2049, 2051), f"bad idx magic {magic} in {path}"
    ndim = magic - 2048
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    offset = 4 + 4 * ndim
    return np.frombuffer(data[offset:], np.uint8).reshape(dims)


def load_mnist_idx(data_dir: str, partition: str):
    """Loads raw MNIST idx(.gz) image+label files if the user provides
    them (the reference reads the same files through the TF1 MNIST
    reader, data.py:81).  Returns (imgs [N,H,W] uint8, labels [N] uint8
    or None) — or None when no image file is present."""
    prefix = "train" if partition == "train" else "t10k"
    img_path = _find_idx(data_dir, f"{prefix}-images-idx3-ubyte")
    if img_path is None:
        return None
    imgs = _read_idx(img_path)
    assert imgs.ndim == 3, f"expected [N,H,W] images in {img_path}"

    labels = None
    lbl_path = _find_idx(data_dir, f"{prefix}-labels-idx1-ubyte")
    if lbl_path is not None:
        labels = _read_idx(lbl_path)
        assert labels.shape == (imgs.shape[0],), (labels.shape, imgs.shape)
    return imgs, labels


def main(argv=None):
    p = argparse.ArgumentParser(description="Writes train and validation moving-digit "
                                "pickles.")
    p.add_argument("--n_train", type=int, default=60000)
    p.add_argument("--n_valid", type=int, default=10000)
    p.add_argument("--n_timesteps", type=int, default=10)
    p.add_argument("--canvas", type=int, default=50)
    p.add_argument("--obj_size", type=int, default=28)
    p.add_argument("--name", default="seq_mnist")
    p.add_argument("--out_dir", default=_DATA_DIR)
    args = p.parse_args(argv)

    for partition, n in (("train", args.n_train), ("validation", args.n_valid)):
        print(f'Processing partition "{partition}"')
        loaded = load_mnist_idx(args.out_dir, partition)
        if loaded is None:
            print("  no MNIST idx files found -> synthetic stroke templates")
            seed = 0 if partition == "train" else 1
            templates = make_template_bank(max(1024, n // 8), args.obj_size, seed)
            labels = None
        else:
            templates, labels = loaded
            print(f"  {len(templates)} real MNIST digits"
                  + ("" if labels is None else " (with labels)"))
        data = create_seq_dataset(
            n_samples=n, n_timesteps=args.n_timesteps,
            canvas_size=(args.canvas, args.canvas),
            obj_size=(args.obj_size, args.obj_size),
            seed=0 if partition == "train" else 1,
            templates=templates, labels=labels,
        )
        filename = os.path.join(args.out_dir, f"{args.name}_{partition}.pickle")
        print(f'  saving to "{filename}"')
        save_pickle(filename, data)


if __name__ == "__main__":
    main()
