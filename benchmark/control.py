#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, at a cell's
own size on the CUDA card, in one process:

  program     the program's first train steps (set-up and its first call,
              as a run makes them) against the reference, one per seed
  tf32        the control: the reference computed in TF32 (the precision
              one step below the configuration's float32 with TF32 off)
              in the program's place, against the reference in float32
  half_batch  a planted fault: the reference on the first half of each
              batch (the mean taken over the rest), with the rows of the
              same noise that those examples drew, in the program's place

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out FILE]

prints one JSON line per reading and a summary line: each number's lower
reading (the largest of the program's) and the least of the control's and
of the fault's.  A state left unchanged reads 1 on ``grad`` and ``change``
by the comparison's measure and needs no run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

NUMBERS = ("loss", "grad", "change")


def program_reading(cell, seed, device):
    """The program's numbers of one seed (set-up and the first call of a
    run; no window)."""
    from harness import oracle, runner
    from reference import train as reference_train

    data, mean_img, w0, training, readings = runner.set_up(cell, seed, device, {},
                                                           time.perf_counter())
    training.release()
    ref = runner.follow_reference(cell.config, data, mean_img, w0, cell.traffic, seed,
                                  readings["noise"], device)
    return oracle.compare(readings, ref, w0, reference_train.learning_rate(cell.config["flags"], 0))


def first_half(table):
    """A step's noise of the batch's first half: every draw's first axis is
    the B * k particles, example-major (row b * k + j), so its first half."""
    return {key: v[:v.shape[0] // 2] for key, v in table.items()}


def reference_readings(cell, seed, device):
    """(the TF32 control's numbers, the half-batch fault's numbers) of one
    seed, each against the float32 reference from the same weights, data
    and noise."""
    import torch

    from harness import oracle, program, runner, weights
    from reference import train as reference_train
    from reference.build import build_model
    from reference.ops.noise import TableNoise
    from sqair_tpu_torch.ops.noise import GeneratorNoise

    traffic, config = cell.traffic, cell.config
    steps = int(traffic["checked_steps"])
    data, mean_img = runner.make_data(traffic, seed, device)
    w0 = runner.make_weights(config, mean_img, seed, device)
    g = torch.Generator(device=device).manual_seed(program.sub_seed(seed, 2))
    sources = [GeneratorNoise(g, device, record=True) for _ in range(steps)]
    batches = runner.reference_batches(data, traffic, seed, steps, device)
    lr = reference_train.learning_rate(config["flags"], 0)

    def follow(tf32, batches, noises):
        model = build_model(config["model"], config["flags"], config["img_size"], device,
                            mean_img)
        weights.load(model.sequence, w0)
        reference_train.precision(tf32)
        try:
            return reference_train.follow(model, config["flags"], batches, noises)
        finally:
            reference_train.precision(False)

    ref = follow(False, batches, sources)
    tables = [s.table for s in sources]
    as_program = lambda r: dict(losses=r["losses"], grads=r["grads"], params=r["params"])  # noqa: E731
    tf32 = follow(True, batches, [TableNoise(t) for t in tables])
    half = [{k: v[:, :v.shape[1] // 2] for k, v in b.items()} for b in batches]
    fault = follow(False, half, [TableNoise(first_half(t)) for t in tables])
    return (oracle.compare(as_program(tf32), ref, w0, lr),
            oracle.compare(as_program(fault), ref, w0, lr))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="the program's seeds, comma-separated")
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    lines = []

    def emit(line):
        line = {k: v for k, v in line.items() if not k.endswith("_gaps")}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = program_reading(cell, seed, "cuda")
        emit(dict(kind="program", seed=seed, seconds=time.perf_counter() - t0, **numbers))
    for seed in (int(s) for s in args.control_seeds.split(",")):
        t0 = time.perf_counter()
        tf32, fault = reference_readings(cell, seed, "cuda")
        emit(dict(kind="tf32", seed=seed, seconds=time.perf_counter() - t0, **tf32))
        emit(dict(kind="half_batch", seed=seed, **fault))
    summary = dict(kind="summary", workload=args.workload,
                   card=torch.cuda.get_device_name(0))
    for k in NUMBERS:
        summary[k] = dict(
            lower=max(l[k] for l in lines if l["kind"] == "program"),
            tf32=min(l[k] for l in lines if l["kind"] == "tf32"),
            half_batch=min(l[k] for l in lines if l["kind"] == "half_batch"))
    emit(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(l) + "\n" for l in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
