"""The per-frame metric breakdown of one checkpoint of the port (the
counterpart of tools/eval_one_ckpt.py).

Usage:
    python tools/eval_one_ckpt_torch.py <run_dir> <step> [n_batches] \\
        [json-flag-overrides] [--device cpu]

Averages the eval metrics (per-frame accuracy and inferred counts
included) over ``n_batches`` (default 8) batches of 32 of the run's valid
set, after the example batch, each batch with the noise of a generator
seeded with 1 (the JAX package's PRNGKey(1)).  The optional JSON dict of
flag overrides goes over the run's flags.json, e.g.
'{"early_disc_step_bias": 1.0}': the checkpoint under a modified prior.
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqair_tpu_torch.device import resolve_device  # noqa: E402
from sqair_tpu_torch.experiment.experiment_tools import load_run  # noqa: E402
from sqair_tpu_torch.scripts.eval import default_noise  # noqa: E402
from sqair_tpu_torch.training import make_eval_step  # noqa: E402
from sqair_tpu_torch.training.checkpoint import find_checkpoints, restore_params  # noqa: E402

BATCH = 32


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir")
    p.add_argument("step", type=int)
    p.add_argument("n_batches", type=int, nargs="?", default=8)
    p.add_argument("overrides", nargs="?", default="{}")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    _, data, model = load_run(args.run_dir, BATCH, device, json.loads(args.overrides))
    restore_params(find_checkpoints(args.run_dir)[args.step], model.sequence)
    batcher = data["valid_iter"]  # Minibatcher(shuffle=False): rolling windows
    next(batcher)  # the JAX tool draws its example batch first
    eval_step, noise = make_eval_step(model), default_noise(device)
    totals = {}
    for _ in range(args.n_batches):
        b = next(batcher)
        for k, v in eval_step(b["imgs"], b["nums"], noise()).items():
            totals[k] = totals.get(k, 0.0) + v.cpu().numpy().astype(np.float64)
    out = {}
    for k in sorted(totals):
        v = out[k] = totals[k] / args.n_batches
        if np.ndim(v):
            print(f"{k}: " + " ".join(f"{x:.4f}" for x in v))
        else:
            print(f"{k}: {v:.5f}")
    return out


if __name__ == "__main__":
    main()
