"""Interactive exploration of a trained run of the port (the counterpart of
notebooks/play.py, itself the reference's notebooks/play.ipynb).

Loads a run (or trains a tiny model first with --quick_train), averages
the eval metric set over a few valid batches and draws the reconstruction
figures with per-object-ID coloured boxes (``eval_tools.ProgressFig``);
without matplotlib it skips the figures and says so.

Usage (on the card unless ``--device cpu``):
    # explore an existing run
    python notebooks/play_torch.py --checkpoint_dir results/multi_mnist/1

    # no checkpoint at hand: the CLI's 200-step --test_run, then the same
    python notebooks/play_torch.py --quick_train
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqair_tpu_torch import eval_tools  # noqa: E402
from sqair_tpu_torch.device import resolve_device  # noqa: E402
from sqair_tpu_torch.experiment.experiment_tools import load_run  # noqa: E402
from sqair_tpu_torch.ops.noise import GeneratorNoise  # noqa: E402
from sqair_tpu_torch.training import make_eval_step  # noqa: E402
from sqair_tpu_torch.training.checkpoint import latest_checkpoint, restore_params  # noqa: E402

RENDER_SEED = 2  # the JAX notebook renders with PRNGKey(2)


def main(argv=None):
    """Returns (the averaged metrics, the figures' paths)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint_dir", default="", help="run dir (.../run_name/<n>)")
    p.add_argument("--play_data_config", default="",
                   help="data config (default: the run's, else the synthetic one)")
    p.add_argument("--play_model_config", default="",
                   help="model config (default: the run's, else mlp_mnist_model)")
    p.add_argument("--fig_dir", default="play_figs", help="where to write figures")
    p.add_argument("--play_batch_size", type=int, default=16)
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--quick_train", action="store_true",
                   help="train the CLI's --test_run model (200 steps) first")
    p.add_argument("--results_dir", default="play_results", help="--quick_train's results")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.quick_train:
        from sqair_tpu_torch.scripts import experiment

        args.checkpoint_dir = experiment.main(["--test_run", f"--results_dir={args.results_dir}",
                                               f"--device={device.type}"])[0]
    overrides = {name: value for name, value in (("data_config", args.play_data_config),
                                                 ("model_config", args.play_model_config))
                 if value}
    flags, data, model = load_run(args.checkpoint_dir or None, args.play_batch_size, device,
                                  overrides)
    if args.checkpoint_dir:
        found = latest_checkpoint(args.checkpoint_dir)
        if found:
            step, path = found
            restore_params(path, model.sequence)
            print(f"restored step {step} from {path}")

    # the metrics over a few valid batches, batch i's noise seeded with i
    eval_step = make_eval_step(model)
    acc = {}
    for i in range(args.eval_batches):
        b = next(data["valid_iter"])
        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(i), device)
        for k, v in eval_step(b["imgs"], b["nums"], noise).items():
            acc.setdefault(k, []).append(v.cpu().numpy())
    metrics = {k: np.mean(np.stack(v), axis=0) for k, v in acc.items()}
    print("validation metrics:")
    for k in sorted(metrics):
        mean = metrics[k]
        if mean.ndim:
            print(f"  {k:24s} [" + " ".join(f"{x:.3f}" for x in mean) + "]")
        else:
            print(f"  {k:24s} {mean:12.5g}")

    if not eval_tools._HAS_MPL:
        print("figures skipped: matplotlib is not installed")
        return metrics, []

    def render_fn(obs, nums):
        with torch.inference_mode():
            gen = torch.Generator(device=device).manual_seed(RENDER_SEED)
            _, aux = model.loss_and_metrics(torch.as_tensor(obs, device=device),
                                            GeneratorNoise(gen, device),
                                            torch.as_tensor(nums, device=device), render=True)
        return aux["render"]

    fig = eval_tools.ProgressFig(render_fn, args.fig_dir, img_size=model.sequence.decoder.img_size,
                                 glimpse_size=model.sequence.decoder.glimpse_size,
                                 seq_n_samples=4)
    fig.plot_all("play", next(data["valid_iter"]))
    paths = [os.path.join(args.fig_dir, f"{kind}_fig_play.png") for kind in ("still", "seq")]
    print(f"figures written to {args.fig_dir}/")
    return metrics, paths


if __name__ == "__main__":
    main()
