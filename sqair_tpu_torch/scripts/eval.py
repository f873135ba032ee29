"""Checkpoint-sweep evaluation (the port of sqair_tpu/scripts/eval.py).

Walks every nth checkpoint of a run dir, restores its parameters, averages
the metrics over the whole valid (or train) set and appends ``itr: value``
lines to ``<metric>_<dataset>.txt`` in the run dir, as the JAX package's
script does; a step already in the iwae file is skipped, so a sweep can be
resumed.  The run's ``flags.json`` gives the model and its model config
(``--model_config`` when given wins, as does a model flag given on the
command line).

The frames come from ``--data_npz``, an ``.npz`` with ``imgs`` (uint8
[T, N, H, W]) and ``nums`` ([T or 1, N, C] counts one-hot), e.g. a data
config's valid set written with numpy.

Run (on the card unless ``--device cpu``):

    python -m sqair_tpu_torch.scripts.eval --checkpoint_dir results/run/1 \\
        --data_npz valid.npz [--dataset valid] [--every_nth_checkpoint 1] \\
        [--eval_batch_size 32] [--device cuda] [--<model flag> value ...]

``SQAIR_FUSE_GLIMPSE=1`` runs the glimpse encoder through its fused kernel;
``SQAIR_FUSE_CELLS=1`` runs each frame's propagation slots through the
fused propagation kernel where the JAX package would (the release flags),
and raises where the JAX package would also fuse discovery (not ported).
The model reads both switches at every step, as the JAX package does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from os import path as osp
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.loader import Minibatcher
from ..device import resolve_device
from ..experiment import experiment_tools
from ..ops.noise import GeneratorNoise, NoiseSource
from ..training import make_eval_step
from ..training.checkpoint import find_checkpoints, restore_params

METRICS = ("iwae", "vae", "num_step_accuracy", "data_ll", "kl",
           "num_steps", "aspect", "num_step_acc_per_t", "num_steps_per_t")
METRIC_FILES = {"iwae": "logpx", "vae": "vae", "num_step_accuracy": "acc",
                "data_ll": "data_ll", "kl": "kl", "num_steps": "num_steps", "aspect": "aspect",
                "num_step_acc_per_t": "acc_per_t", "num_steps_per_t": "num_steps_per_t"}
EVAL_FLAGS = ("checkpoint_dir", "dataset", "every_nth_checkpoint", "eval_batch_size")
NOISE_SEED = 1  # the JAX package evaluates every batch with PRNGKey(1)


def _already_evaluated(log_path: str):
    done = set()
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                try:
                    done.add(int(line.split(":")[0]))
                except ValueError:
                    pass
    return done


def load_npz(path: str):
    """(imgs float32 [T, N, H, W] in [0, 1], nums float32 [T, N, C]), with a
    singleton time axis of nums tiled over T."""
    with np.load(path) as data:
        imgs, nums = data["imgs"], data["nums"]
    if imgs.dtype != np.uint8:
        raise ValueError(f"{path}: expected uint8 frames, got {imgs.dtype}")
    imgs = imgs.astype(np.float32) / 255.0
    nums = nums.astype(np.float32)
    if nums.shape[0] != imgs.shape[0]:
        nums = np.tile(nums, [imgs.shape[0]] + [1] * (nums.ndim - 1))
    return imgs, nums


def eval_batcher(imgs: np.ndarray, nums: np.ndarray, batch_size: int) -> Minibatcher:
    """The JAX package's eval batches: rolling contiguous windows of
    ``batch_size`` sequences along axis 1 (``Minibatcher(shuffle=False)``),
    back to the start when the next window would run past the end."""
    return Minibatcher({"imgs": imgs, "nums": nums}, batch_size, {"imgs": 1, "nums": 1})


def default_noise(device, seed: int = NOISE_SEED) -> Callable[[], NoiseSource]:
    """Every batch's noise from a generator seeded with 1, as the JAX
    package passes PRNGKey(1) to every batch (a process of a multi-process
    run: ``parallel.distributed.rank_seed(1, rank)``)."""
    device = torch.device(device)
    return lambda: GeneratorNoise(torch.Generator(device=device).manual_seed(seed), device)


def sweep(run_dir: str, model, batcher, n_batches: int, dataset: str = "valid",
          every_nth_checkpoint: int = 1, noise: Optional[Callable[[], NoiseSource]] = None
          ) -> List[int]:
    """Evaluates every nth checkpoint of ``run_dir`` not yet in its iwae
    file and appends its metrics; returns the steps evaluated.

    :param batcher: iterator of dict(imgs, nums) batches (``eval_batcher``);
        ``n_batches`` per checkpoint
    :param noise: a new noise source per batch (default ``default_noise``)
    """
    noise = noise or default_noise(model.device)
    eval_step = make_eval_step(model)
    ckpts = find_checkpoints(run_dir)
    steps = sorted(ckpts)[::every_nth_checkpoint]
    print(f"Evaluating {len(steps)} checkpoints on '{dataset}' ({n_batches} batches each)")
    log_paths = {m: osp.join(run_dir, f"{METRIC_FILES[m]}_{dataset}.txt") for m in METRICS}
    done = _already_evaluated(log_paths["iwae"])
    evaluated = []
    for step in steps:
        if step in done:
            print(f"skipping {step} (already evaluated)")
            continue
        restore_params(ckpts[step], model.sequence)
        totals: Dict[str, np.ndarray] = {m: 0.0 for m in METRICS}
        for _ in range(n_batches):
            batch = next(batcher)
            metrics = eval_step(batch["imgs"], batch["nums"], noise())
            for m in METRICS:
                v = metrics[m].detach().cpu().numpy() if m in metrics else np.nan
                totals[m] = totals[m] + np.asarray(v, np.float64)
        for m in METRICS:
            v = totals[m] = totals[m] / n_batches
            text = " ".join(f"{x}" for x in v) if np.ndim(v) else f"{v}"
            with open(log_paths[m], "a") as f:
                f.write(f"{step}: {text}\n")

        def fmt(v):
            return ("[" + " ".join(f"{x:.3f}" for x in v) + "]" if np.ndim(v)
                    else f"{v:.4f}")
        print(f"{step}: " + ", ".join(f"{m}={fmt(totals[m])}" for m in METRICS))
        evaluated.append(step)
    return evaluated


def _parse_value(text: str):
    try:
        return json.loads(text)
    except ValueError:
        return text


def parse_args(argv: Optional[Sequence[str]] = None):
    """(eval args, model flags given on the command line)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", required=True, help="run dir with checkpoints")
    p.add_argument("--data_npz", required=True, help=".npz with imgs and nums")
    p.add_argument("--dataset", default="valid", help="valid | train (names the files)")
    p.add_argument("--every_nth_checkpoint", type=int, default=1)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--data_config", default="", help="accepted; the data is --data_npz")
    p.add_argument("--model_config", default=None,
                   help="model config (default: the run's, else mlp_mnist_model)")
    p.add_argument("--device", default="cuda")
    args, rest = p.parse_known_args(argv)
    overrides, i = {}, 0
    while i < len(rest):
        arg = rest[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        elif i + 1 < len(rest) and not rest[i + 1].startswith("--"):
            key, value = arg[2:], rest[i + 1]
            i += 2
        else:
            key, value = arg[2:], "true"
            i += 1
        overrides[key] = _parse_value(value)
    return args, overrides


def run_flags(run_dir: str, overrides: Dict) -> Dict:
    """The run's flags.json (when present) under the command line's model
    flags; the eval-only flags are dropped."""
    flags = {}
    flag_file = osp.join(run_dir, "flags.json")
    if osp.exists(flag_file):
        with open(flag_file) as f:
            flags = json.load(f)
    flags.update(overrides)
    for key in EVAL_FLAGS:
        flags.pop(key, None)
    return flags


def main(argv: Optional[Sequence[str]] = None) -> List[int]:
    args, overrides = parse_args(argv)
    device = resolve_device(args.device)
    flags = run_flags(args.checkpoint_dir, overrides)
    imgs, nums = load_npz(args.data_npz)
    n_batches = max(1, imgs.shape[1] // args.eval_batch_size)
    batcher = eval_batcher(imgs, nums, args.eval_batch_size)
    next(batcher)  # the JAX script draws its example batch first
    model_config = (args.model_config or flags.get("model_config")
                    or "sqair_tpu/configs/mlp_mnist_model.py")
    # mean_img is a parameter that every checkpoint holds
    model = experiment_tools.load(model_config, flags, imgs.shape[2:],
                                  mean_img=np.zeros(imgs.shape[2:]), device=device)
    return sweep(args.checkpoint_dir, model, batcher, n_batches, dataset=args.dataset,
                 every_nth_checkpoint=args.every_nth_checkpoint)


if __name__ == "__main__":
    main(sys.argv[1:])
