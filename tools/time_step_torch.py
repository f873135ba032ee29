"""Train-step time of the port at the release width (the counterpart of
tools/time_step.py): eager train steps, then a captured CUDA graph of N
train steps replayed a call (``training/graph.py``, the CLI's
``--steps_per_call N``; on the CPU the same steps run eagerly).

The model is the release run's flags (release_models/mnist_mlp/1/flags.json:
B 32, k 5, T 10, 50x50, S 3, 256 wide) with weights from a seed, the batch
uniform noise frames.  JAX's remat and scan-unroll arguments have no
counterpart: the port's time loop is a Python loop, its backward autograd.

    python tools/time_step_torch.py [--device cpu] [--steps 20] [--trials 3] [--chain 10]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sqair_tpu_torch.configs import mlp_mnist_model  # noqa: E402
from sqair_tpu_torch.device import resolve_device  # noqa: E402
from sqair_tpu_torch.ops.noise import GeneratorNoise  # noqa: E402
from sqair_tpu_torch.training import init_train, make_train_step  # noqa: E402
from sqair_tpu_torch.training.graph import make_chained_train_step  # noqa: E402

RELEASE_FLAGS = os.path.join(REPO, "release_models", "mnist_mlp", "1", "flags.json")
IMG = (50, 50)


def release_setup(device, batch_size=None, timesteps=10, seed=0):
    """(flags, model, obs [T, B, 50, 50], nums [T, B, S + 1]) at the release
    flags, weights from ``seed``, on ``device``."""
    with open(RELEASE_FLAGS) as f:
        flags = json.load(f)
    if batch_size:
        flags["batch_size"] = batch_size
    B, S = int(flags["batch_size"]), int(flags["n_steps_per_image"])
    model = mlp_mnist_model.load(flags, IMG, device=device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(1)
    obs = torch.rand((timesteps, B) + IMG, generator=gen, device=device)
    nums = torch.zeros((timesteps, B, S + 1), device=device)
    return flags, model, obs, nums


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Returns {"eager": [ms a step per trial], "graph": [...], "warm_target": t}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=20, help="train steps a trial")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--chain", type=int, default=10, help="steps a graph replay")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--timesteps", type=int, default=10)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    flags, model, obs, nums = release_setup(device, args.batch_size, args.timesteps)
    T, B = obs.shape[:2]
    factory, l2 = mlp_mnist_model.make_optimizer(flags)
    noise_gen = torch.Generator(device=device).manual_seed(0)
    out = {"eager": [], "graph": []}

    step = make_train_step(model, factory, l2)
    t0 = time.perf_counter()
    for _ in range(3):
        m = step(obs, nums, GeneratorNoise(noise_gen, device))
    out["warm_target"] = float(m["target"])
    print(f"warm target: {out['warm_target']:.2f} (3 steps {time.perf_counter() - t0:.1f}s)",
          flush=True)
    for trial in range(args.trials):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            m = step(obs, nums, GeneratorNoise(noise_gen, device))
        float(m["target"])
        dt = (time.perf_counter() - t0) / args.steps
        out["eager"].append(dt * 1e3)
        print(f"eager trial {trial}: {dt * 1e3:.2f} ms/step -> {T * B / dt:.0f} frames/s",
              flush=True)

    n = args.chain
    state = init_train(model, factory)
    chain = make_chained_train_step(model, state, lambda: {"imgs": obs, "nums": nums}, n, T,
                                    l2, lambda itr: GeneratorNoise(noise_gen, device),
                                    [noise_gen])
    chain()  # captures on the card
    _sync(device)
    calls = max(1, args.steps // n)
    for trial in range(args.trials):
        t0 = time.perf_counter()
        for _ in range(calls):
            m = chain()
        float(m["target"])
        dt = (time.perf_counter() - t0) / (calls * n)
        out["graph"].append(dt * 1e3)
        print(f"graph N={n} trial {trial}: {dt * 1e3:.2f} ms/step -> {T * B / dt:.0f} "
              "frames/s", flush=True)
    chain.release()
    out["median_ms"] = {k: statistics.median(out[k]) for k in ("eager", "graph")}
    return out


if __name__ == "__main__":
    main()
