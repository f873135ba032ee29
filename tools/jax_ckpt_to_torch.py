"""Converts an orbax checkpoint of the JAX package (sqair_tpu) into a
checkpoint of the PyTorch port (sqair_tpu_torch/training/checkpoint.py).

Run on a machine with JAX (the CPU will do):

    python tools/jax_ckpt_to_torch.py --checkpoint release_models/mnist_mlp/1/ckpt-1000000 \\
        --out_dir /tmp/release/1 [--flags release_models/mnist_mlp/1/flags.json] \\
        [--img_size 50,50]

It builds the port's model from the run's flags.json (by default the one
beside the checkpoint; its model_config, e.g. the conv model's), restores the parameters with
``sqair_tpu.training.restore_params`` into the flax tree of that model's
shapes, converts them with ``sqair_tpu_torch.convert.params_from_flax``
(strictly: every key and shape must match), and, when the checkpoint holds
the optax RMSProp state, carries ``nu``, ``trace`` and the schedule count
over too (optax keeps state for every leaf, the decoder's two stds
included; the port's step never reads theirs).  It writes
``<out_dir>/ckpt-<step>`` and copies flags.json beside it, so that
``python -m sqair_tpu_torch.scripts.eval --checkpoint_dir <out_dir>``
sweeps it.  This is the one file outside the tests that imports both
packages; the port never imports it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

from sqair_tpu.training import restore_checkpoint, restore_params  # noqa: E402
from sqair_tpu.training.train import make_lr_schedule, make_optimizer  # noqa: E402
from sqair_tpu_torch.configs import mlp_mnist_model  # noqa: E402
from sqair_tpu_torch.convert import params_from_flax  # noqa: E402
from sqair_tpu_torch.experiment import experiment_tools  # noqa: E402
from sqair_tpu_torch.training import init_train  # noqa: E402
from sqair_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402


def flax_tree_like(sequence):
    """The flax parameter tree ({top: {"params": {...}}}) of the port's
    state_dict, as numpy zeros of its shapes: the example that orbax
    restores into."""
    tree = {}
    for key, value in sequence.state_dict().items():
        top, *path = key.split(".")
        node = tree.setdefault(top, {}).setdefault("params", {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.zeros(tuple(value.shape), np.float32)
    return tree


def _has_opt_state(checkpoint):
    meta = ocp.Checkpointer(ocp.PyTreeCheckpointHandler()).metadata(checkpoint)
    tree = getattr(meta, "item_metadata", meta)
    tree = getattr(tree, "tree", tree)
    return "opt_state" in dict(tree)


def convert(checkpoint: str, flags: dict, out_dir: str, img_size=(50, 50)) -> str:
    """Writes ``<out_dir>/ckpt-<step>`` from the orbax checkpoint; returns its path."""
    checkpoint = os.path.abspath(checkpoint)
    m = re.match(r"^ckpt-(\d+)$", os.path.basename(checkpoint))
    if m is None:
        raise ValueError(f"{checkpoint}: expected a directory named ckpt-<step>")
    step = int(m.group(1))
    model_config = flags.get("model_config") or "sqair_tpu/configs/mlp_mnist_model.py"
    model = experiment_tools.load(model_config, flags, img_size,
                                  mean_img=np.zeros(img_size, np.float32), device="cpu")
    seq = model.sequence
    example = flax_tree_like(seq)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    params = to_np(restore_params(checkpoint, example))
    seq.load_state_dict(params_from_flax(params, seq), strict=True)

    optimizer = None
    if _has_opt_state(checkpoint):
        # the optimizer as the JAX package's experiment builds it, for the
        # structure of its state
        s = mlp_mnist_model.train_settings(flags)
        if s["opt"].lower() != "rmsprop":
            raise NotImplementedError(f"an optax {s['opt']} state is not converted yet "
                                      "(RMSProp's is)")
        if not s["schedule"]:
            raise NotImplementedError("an optax state without a schedule count is not "
                                      "converted yet")
        lr = make_lr_schedule(s["learning_rate"], s["schedule"], s["train_itr"])
        opt_example = make_optimizer(s["opt"], lr).init(example)
        restored = restore_checkpoint(
            checkpoint, dict(params=example, opt_state=opt_example, step=np.asarray(0)))
        rms, schedule, trace = restored["opt_state"]
        factory, _ = mlp_mnist_model.make_optimizer(flags)
        optimizer = init_train(model, factory).optimizer
        nu = params_from_flax(to_np(rms.nu), seq)
        tr = params_from_flax(to_np(trace.trace), seq)
        for name, param in seq.named_parameters():
            optimizer.state[param] = dict(nu=nu[name], trace=tr[name])
        optimizer.count = int(np.asarray(schedule.count))
    return save_checkpoint(out_dir, step, seq, optimizer)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help="orbax checkpoint dir ckpt-<step>")
    p.add_argument("--out_dir", required=True, help="run dir to write ckpt-<step> into")
    p.add_argument("--flags", default="", help="flags.json (default: beside the checkpoint)")
    p.add_argument("--img_size", default="50,50", help="H,W of a frame")
    args = p.parse_args(argv)
    flags_path = args.flags or os.path.join(os.path.dirname(os.path.abspath(args.checkpoint)),
                                            "flags.json")
    with open(flags_path) as f:
        flags = json.load(f)
    img_size = tuple(int(s) for s in args.img_size.split(","))
    path = convert(args.checkpoint, flags, args.out_dir, img_size)
    os.makedirs(args.out_dir, exist_ok=True)
    if os.path.abspath(flags_path) != os.path.abspath(os.path.join(args.out_dir, "flags.json")):
        shutil.copyfile(flags_path, os.path.join(args.out_dir, "flags.json"))
    print(path)


if __name__ == "__main__":
    main()
