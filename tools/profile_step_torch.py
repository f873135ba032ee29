"""Wall-clock breakdown of the port's train step (the counterpart of
tools/profile_step.py), at the release width (``time_step_torch.release_setup``):

  - the train step (forward, backward, RMSProp)
  - the loss forward alone
  - the SequentialAIR forward on the particle-tiled batch (B*k)
  - one timestep (propagation, discovery, merge) from the initial carry
  - the decoder alone
  - the loss forward and backward (no optimizer)

Each sub-step's wall ms a call is the mean of ``--iters`` calls after
warm-up, the device synchronized around them.  ``--trace DIR`` writes a
torch.profiler trace of one train step to DIR/trace.json (on the card with
its device activity) and prints its device time.

    python tools/profile_step_torch.py [--device cpu] [--trace DIR] [--iters 20]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from time_step_torch import release_setup  # noqa: E402

from sqair_tpu_torch.configs import mlp_mnist_model  # noqa: E402
from sqair_tpu_torch.device import resolve_device  # noqa: E402
from sqair_tpu_torch.ops import indexing  # noqa: E402
from sqair_tpu_torch.ops.noise import GeneratorNoise  # noqa: E402
from sqair_tpu_torch.training import make_train_step  # noqa: E402


def main(argv=None):
    """Returns {sub-step: wall ms a call} (and "trace_device_ms" with --trace)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace", default=None, help="torch.profiler trace dir")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--timesteps", type=int, default=10)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    flags, model, obs, nums = release_setup(device, args.batch_size, args.timesteps)
    T, B = obs.shape[:2]
    k, seq = model.k_particles, model.sequence
    gen = torch.Generator(device=device).manual_seed(0)

    def noise():
        return GeneratorNoise(gen, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {}

    def timeit(name, fn):
        for _ in range(args.warmup):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        sync()
        out[name] = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"{name:34s} {out[name]:9.2f} ms", flush=True)

    factory, l2 = mlp_mnist_model.make_optimizer(flags)
    train_step = make_train_step(model, factory, l2)
    timeit("train step (fwd+bwd+opt)", lambda: train_step(obs, nums, noise()))
    print(f"{'-> frames/sec':34s} {T * B / out['train step (fwd+bwd+opt)'] * 1e3:9.0f}")

    def inference(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    timeit("loss forward", inference(lambda: model.loss_and_metrics(obs, noise(), nums)[0]))
    tiled = indexing.tile_input_for_iwae(obs, k, with_time=True)
    timeit("SequentialAIR forward (B*k)", inference(lambda: seq(tiled, noise())["canvas"]))
    ts = seq.timestep
    carry = ts.initial_carry(B * k, device, obs.dtype)
    timeit("one timestep", inference(lambda: ts(
        tiled[0], carry["z"], carry["time_state"], carry["prior_state"],
        carry["last_used_id"], carry["prev_ids"], 0, noise().scope(0))))
    S, n_what = int(flags["n_steps_per_image"]), int(flags["n_what"])
    what = torch.randn((B * k, S, n_what), generator=gen, device=device)
    where = torch.randn((B * k, S, 4), generator=gen, device=device)
    presence = torch.ones((B * k, S, 1), device=device)
    timeit("decoder", inference(lambda: seq.decoder(what, where, presence)))
    params = [p for p in seq.parameters() if p.requires_grad]

    def grads():
        target = model.loss_and_metrics(obs, noise(), nums, record_mode="train")[0]
        return torch.autograd.grad(target, params, allow_unused=True)

    timeit("loss fwd+bwd (no opt)", grads)

    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            train_step(obs, nums, noise())
            sync()
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        if device.type == "cuda":
            out["trace_device_ms"] = sum(
                e.self_device_time_total for e in prof.key_averages()) / 1e3
            print(f"device time of the traced step: {out['trace_device_ms']:.3f} ms")
        print("trace written to", path)
    return out


if __name__ == "__main__":
    main()
