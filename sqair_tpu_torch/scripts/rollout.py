"""Long-horizon conditional generation (the port of sqair_tpu/scripts/rollout.py).

The model infers latents from the first ``--condition_frames`` frames of a
valid batch, then draws what, where and presence from its learned priors
and renders them, for ``--rollout_len`` frames in all: the paper's
100-step rollouts.  The frames after the conditioning window are zeros;
under generation the prior's samples replace the posterior's, so they never
reach the rendered latents.

Run (on the card unless ``--device cpu``):

    python -m sqair_tpu_torch.scripts.rollout \\
        --checkpoint_dir sqair_tpu_torch/release/mnist_mlp/1 --out_dir results/rollout \\
        [--rollout_len 100] [--condition_frames 5] [--n_examples 8] [--rollout_seed 0]

The run's flags.json gives the model and the data; the rollout's own flags,
and ``--data_config`` / ``--model_config`` when given, win over it.  With no
``--checkpoint_dir`` the weights are drawn from ``--rollout_seed``.  Writes
``rollout.npz`` (particle 0 of each example: ``canvas`` [T, B, H, W],
``where`` logits [T, B, S, 4], ``presence`` and ``obj_id`` [T, B, S], and
the ``conditioned`` frames) and, where matplotlib is installed,
``rollout.png`` (a strip of frames) into ``--out_dir`` (default the
checkpoint dir, else ".").  The model's noise comes from a generator seeded
with ``--rollout_seed``.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..experiment import flags
from ..experiment.experiment_tools import _import_module, json_load, load, parse_flags
from ..ops.noise import GeneratorNoise, NoiseSource
from ..training.checkpoint import latest_checkpoint, restore_params

ROLLOUT_FLAGS = flags.define_all((
    (str, "checkpoint_dir", "", "Run dir with checkpoints; empty = fresh weights."),
    (str, "out_dir", "", "Output dir (default: checkpoint_dir or '.')."),
    (str, "data_config", "sqair_tpu/configs/synth_seq_mnist_data.py", ""),
    (str, "model_config", "sqair_tpu/configs/mlp_mnist_model.py", ""),
    (int, "rollout_len", 100, "Total frames to generate."),
    (int, "condition_frames", 5, "Frames of inference before generation."),
    (int, "n_examples", 8, "How many sequences to roll out."),
    (int, "rollout_seed", 0, ""),
    (str, "device", "cuda", "cuda, or cpu to run on the CPU."),
))
# flags that flags.json never overrides
OWN_FLAGS = set(ROLLOUT_FLAGS) - {"data_config", "model_config"}


def resolve_flags(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parses the command line over the run's flags.json: the rollout's own
    flags (and the configs, where given) from the command line, every other
    flag of flags.json from there, as the JAX script does."""
    if argv is not None:
        sys.argv = [sys.argv[0]] + list(argv)
    F = flags.FLAGS
    parse_flags()
    saved = {}
    if F.checkpoint_dir:
        saved = json_load(os.path.join(F.checkpoint_dir, "flags.json"))
    keep = OWN_FLAGS | {n for n in ("data_config", "model_config") if n in F._cli_set}
    if saved:
        F.restore({**saved, **{n: getattr(F, n) for n in keep}})
    # the configs define their flags (model config first, as the CLIs import
    # them); a flag of theirs on the command line counts unless flags.json has it
    for config in (F.model_config, F.data_config):
        _import_module(config)
    parse_flags()
    if saved:
        F.restore({n: v for n, v in saved.items() if n not in keep})
    return F.as_dict()


def generate(model, obs: torch.Tensor, noise: NoiseSource) -> Dict[str, torch.Tensor]:
    """The model's full record [T, B*k, ...] on ``obs`` [T, B, H, W] (the
    conditioning frames, then zeros), without autograd."""
    with torch.inference_mode():
        return model.forward(obs, noise)


def main(argv: Optional[Sequence[str]] = None, noise: Optional[NoiseSource] = None) -> Dict:
    """Rolls out; returns {"outputs": the full record, "npz": path, "png":
    path or None, "conditioned": frames}.

    :param noise: the model's noise, in place of the seeded generator's
        (e.g. another implementation's, replayed)
    """
    F = flags.FLAGS
    resolve_flags(argv)
    device = resolve_device(F.device)

    data = load(F.data_config, F.n_examples)
    batch = next(iter(data["valid_iter"]))
    obs = np.asarray(batch["imgs"], np.float32)  # [T0, B, H, W]
    T0, B = obs.shape[:2]
    cond = min(F.condition_frames, T0)
    T = F.rollout_len
    padded = np.zeros((T,) + obs.shape[1:], np.float32)
    padded[:cond] = obs[:cond]

    F.sample_from_prior = True
    F.generate_after = cond - 1
    model = load(F.model_config, F.as_dict(), obs.shape[2:], mean_img=obs.mean(axis=(0, 1)),
                 device=device, seed=F.rollout_seed)
    if F.checkpoint_dir:
        found = latest_checkpoint(F.checkpoint_dir)
        if found is None:
            raise FileNotFoundError(f"no checkpoints in {F.checkpoint_dir}")
        step, path = found
        restore_params(path, model.sequence)
        print(f"restored checkpoint at step {step}")

    if noise is None:
        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(F.rollout_seed),
                               device)
    out = generate(model, torch.from_numpy(padded).to(device), noise)

    k = model.k_particles

    def particle0(name):
        x = out[name].cpu().numpy()
        return x.reshape((T, B, k) + x.shape[2:])[:, :, 0]

    canvas = particle0("canvas")
    out_dir = F.out_dir or F.checkpoint_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    npz_path = os.path.join(out_dir, "rollout.npz")
    np.savez_compressed(npz_path, canvas=canvas, where=particle0("where"),
                        presence=particle0("presence"), obj_id=particle0("obj_id"),
                        conditioned=obs[:cond])
    print("wrote", npz_path)
    png_path = plot_strip(canvas, cond, B, out_dir)
    return dict(outputs=out, npz=npz_path, png=png_path, conditioned=obs[:cond])


def plot_strip(canvas: np.ndarray, cond: int, B: int, out_dir: str) -> Optional[str]:
    """Writes rollout.png (up to 8 examples x 16 frames) where matplotlib is
    installed; returns its path, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        print("figure skipped: matplotlib is not installed")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    T = canvas.shape[0]
    n_show = min(8, B)
    cols = min(T, 16)
    stride = max(1, T // cols)
    fig, axes = plt.subplots(n_show, cols, figsize=(cols * 1.2, n_show * 1.3))
    axes = np.atleast_2d(axes)
    for r in range(n_show):
        for c in range(cols):
            t = c * stride
            ax = axes[r, c]
            ax.imshow(canvas[t, r], cmap="gray", vmin=0, vmax=1)
            ax.set_xticks([]), ax.set_yticks([])
            if r == 0:
                ax.set_title(f"t={t}" + (" (gen)" if t >= cond else ""), fontsize=7)
    png_path = os.path.join(out_dir, "rollout.png")
    fig.savefig(png_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", png_path)
    return png_path


if __name__ == "__main__":
    main()
