#!/usr/bin/env python3
"""The look behind the compared numbers, at a cell's own size on the CUDA
card: for each seed, the program's first train steps (set-up and its first
call, as a run makes them), the float32 reference and a float64 reference
from the same weights, batches and noise, each pair compared as a run
compares the program with the reference; and where the three part in the
presence draws.

    python3 benchmark/look.py --workload <cell> --seeds 1,2,... \\
        [--cpu-seeds 1,...] [--out FILE]

prints one JSON line per seed:

  pairs      for each pair (program / float32, program / float64,
             float32 / float64): the losses' gaps step by step, ``grad``
             (worst leaf) and ``change`` (median leaf) as ``correct``
             compares them, the worst leaf's change, and each leaf's gap on
             the leaves named
  presence   for each step and pair: the presence draws that differ (of
             T * B * k * slots), and the first, with the presence logit of
             each side there
  cpu        (``--cpu-seeds``) the program's first gradient on its plain
             path (the program built on the CPU, no kernels) against the
             float64 reference: a second witness for the gradient gaps
"""
import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

SHOWN = ("grad", "change", "change_worst", "grad_leaf", "change_leaf")


def _presence_of(model, record):
    """Wraps ``model.forward`` so that each call appends its presence draws
    and logits [T, B * k, slots] to ``record``."""
    forward = model.forward

    def recorded(*args, **kwargs):
        out = forward(*args, **kwargs)
        record.append((out["presence"].detach(), out["presence_logit"].detach()))
        return out

    model.forward = recorded


def _parting(a, b):
    """Where two runs' presence draws of one step differ."""
    (pa, la), (pb, lb) = a, b
    differ = (pa.double() != pb.double()).nonzero()
    out = dict(differ=int(differ.shape[0]), of=int(pa.numel()))
    if differ.shape[0]:
        at = tuple(int(i) for i in differ[0])
        out.update(first=at, logits=[float(la[at]), float(lb[at])])
    return out


def _pair(numbers, leaves):
    out = {k: numbers[k] for k in SHOWN}
    out["loss_steps"] = numbers["loss_steps"]
    out["leaves"] = {n: [numbers["grad_gaps"].get(n), numbers["change_gaps"].get(n)]
                     for n in leaves}
    return out


def look(cell, seed, device, cpu_witness):
    import torch

    from harness import oracle, runner, weights
    from reference import train as reference_train
    from reference.build import build_model
    from reference.ops.noise import TableNoise
    from sqair_tpu_torch.ops.noise import ReplayNoise

    config, traffic, F = cell.config, cell.traffic, cell.config["flags"]
    steps = int(traffic["checked_steps"])
    lr = reference_train.learning_rate(F, 0)
    data, mean_img, w0, training, readings = runner.set_up(cell, seed, device, {}, 0.0)
    noise = readings["noise"]
    batches = runner.reference_batches(data, traffic, seed, steps, device)

    # the program's presence draws, step by step, from the weights each
    # step started from (the recorder's copies), through its own kernels
    rec = training.recorder
    starts = [w0] + [rec.unflatten(rec.snapshots[i]) for i in range(steps - 1)]
    program = []
    _presence_of(training.model, program)
    with torch.no_grad():
        for w, b, t in zip(starts, batches, noise):
            weights.load(training.model.sequence, w)
            training.model.forward(b["imgs"], ReplayNoise(t, device), "train")
    training.release()
    del training

    def reference(dtype):
        model = build_model(config["model"], F, config["img_size"], device, mean_img)
        model.sequence.to(dtype)
        weights.load(model.sequence, w0)
        record = []
        _presence_of(model, record)
        out = reference_train.follow(
            model, F, [{k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
                       for b in batches],
            [TableNoise({k: v.to(dtype) for k, v in t.items()}) for t in noise])
        return out, record

    ref32, pres32 = reference(torch.float32)
    ref64, pres64 = reference(torch.float64)
    w64 = {k: v.double() for k, v in w0.items()}
    as_program = dict(losses=ref32["losses"], grads=ref32["grads"], params=ref32["params"])
    pairs = dict(program_f32=oracle.compare(readings, ref32, w0, lr),
                 program_f64=oracle.compare(readings, ref64, w64, lr),
                 f32_f64=oracle.compare(as_program, ref64, w64, lr))
    named = sorted({p[k] for p in pairs.values() for k in ("grad_leaf", "change_leaf")}
                   | {"decoder._glimpse_decoder.output_scale"})
    out = dict(seed=seed, pairs={k: _pair(v, named) for k, v in pairs.items()},
               presence=[dict(step=i + 1, program_f32=_parting(a, b),
                              program_f64=_parting(a, c), f32_f64=_parting(b, c))
                         for i, (a, b, c) in enumerate(zip(program, pres32, pres64))])
    if cpu_witness:
        out["cpu"] = _plain_path_gradient(config, mean_img, w0, batches[0], noise[0], ref64,
                                          w64, lr, named)
    return out


def _plain_path_gradient(config, mean_img, w0, batch, table, ref64, w64, lr, named):
    """The program built on the CPU (its plain path) from the same weights:
    its first gradient against the float64 reference's."""
    from harness import oracle, weights
    from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model
    from sqair_tpu_torch.ops.noise import ReplayNoise

    F = config["flags"]
    loader = conv_mnist_model if config["model"] == "conv" else mlp_mnist_model
    model = loader.load(F, tuple(config["img_size"]), mean_img=mean_img, device="cpu")
    weights.load(model.sequence, {k: v.cpu() for k, v in w0.items()})
    _, l2 = loader.make_optimizer(F)
    target, _ = model.loss_and_metrics(batch["imgs"].cpu(), ReplayNoise(table, "cpu"),
                                       batch["nums"].cpu(), l2_weight=l2, record_mode="train")
    target.backward()
    grads = {n: p.grad.detach().to(w64[n].device) for n, p in model.sequence.named_parameters()
             if p.grad is not None}
    numbers = oracle.compare(dict(losses=[float(target.detach())], grads=grads, params=w0),
                             ref64, w64, lr)
    return dict(loss=numbers["loss"], grad=numbers["grad"], grad_leaf=numbers["grad_leaf"],
                leaves={n: numbers["grad_gaps"].get(n) for n in named})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--cpu-seeds", default="", help="the seeds to witness on the CPU")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("look.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    cpu = {int(s) for s in args.cpu_seeds.split(",") if s}
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        line = dict(workload=args.workload, **look(cell, seed, "cuda", seed in cpu))
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(l + "\n" for l in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
