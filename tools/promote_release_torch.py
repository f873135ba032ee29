"""Promotes a run of the port to a release artifact (the counterpart of
tools/promote_release.py): a params-only checkpoint (no optimizer or
generator state: restorable whatever the schedule or optimizer) and the
run's flags.json, as ``sqair_tpu_torch/release/mnist_mlp/1`` holds them.

Usage:
    python tools/promote_release_torch.py --run_dir results/font_long/1 \\
        --out sqair_tpu_torch/release/mnist_mlp/1 [--step 60000]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqair_tpu_torch.training.checkpoint import (find_checkpoints, load_checkpoint,  # noqa: E402
                                                 write_checkpoint)


def main(argv=None) -> str:
    """Returns the promoted checkpoint's path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    args = ap.parse_args(argv)
    ckpts = find_checkpoints(args.run_dir)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {args.run_dir}")
    step = args.step if args.step is not None else max(ckpts)
    print(f"promoting {ckpts[step]}")
    state = load_checkpoint(ckpts[step])
    os.makedirs(args.out, exist_ok=True)
    path = write_checkpoint(args.out, step, {"step": int(state["step"]),
                                             "params": state["params"]})
    with open(os.path.join(args.run_dir, "flags.json")) as f:
        flags = json.load(f)
    with open(os.path.join(args.out, "flags.json"), "w") as f:
        json.dump(flags, f, indent=4, sort_keys=True)
        f.write("\n")
    print(f"release artifact at {args.out} (ckpt-{step} + flags.json)")
    return path


if __name__ == "__main__":
    main()
