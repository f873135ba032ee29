#!/usr/bin/env python3
"""Times the kernels redesigned for Hopper of a checkout of this repository
(the MLP forward, the vanilla-RNN and GRU forwards, the vanilla-RNN
backward) on one CUDA card, at every shape a train step gives them (release
flags, no switch), beside one PyTorch call of the same function.  The GRU
forward runs as the train step calls it, saving zr and c.

    python3 tools/time_fused_kernels.py [--root DIR] [--save FILE] [--compare FILE]
                                        [--sms N]

``--root`` is the checkout whose ``sqair_tpu_torch`` and ``chip_smoke.py``
are used (default: this one); it builds that checkout's kernels.  The inputs
come from ``chip_smoke.make_inputs`` with a fixed seed, so two checkouts
time the same calls.  ``--save`` writes every output to a torch file and
``--compare`` holds this run's outputs to such a file: the largest absolute
difference and whether the bits are the same.  Prints one JSON line per
kernel: the call-weighted ms, library ms and bound ms over the train step's
shapes, each shape's numbers, and the card's name and power limit.  Run
two checkouts in turns (A, B, B, A) in one call to compare them.  ``--sms``
makes the host pick its launch geometry (``ops/fused.py``: the MLP's
cluster size, the cells' column split, the vanilla-RNN backward's row
tile) as if the card had N SMs, e.g. 1 for one block a row tile.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    ap.add_argument("--sms", type=int)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_fused_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sqair_tpu_torch.ops import build, fused, stn

    stn.full_fp32_matmul()
    if args.sms:
        fused.SMS = args.sms
    build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    flags = json.loads(cs.RELEASE_FLAGS.read_text())
    B, k = int(flags["batch_size"]), int(flags["k_particles"])
    T = int(flags.get("font_timesteps", 10))
    shapes = cs.main_path_shapes(flags, B, k, T, train=True)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    outputs, want = {}, torch.load(args.compare) if args.compare else None
    report = {}
    forwards = {"fused_mlp": fused.fused_mlp, "fused_vanilla_rnn": fused.fused_vanilla_rnn,
                "fused_gru": lambda *a: fused._gru_fwd_cuda(*a, save=True)}
    for kernel, backward in (("fused_mlp", False), ("fused_vanilla_rnn", False),
                             ("fused_gru", False), ("fused_vanilla_rnn", True)):
        name = kernel + ("_bwd" if backward else "")
        rows, tot = [], dict(calls=0, ms=0.0, lib=0.0, bound=0.0)
        for kn, shape, calls in shapes:
            if kn != kernel:
                continue
            with torch.inference_mode():
                fargs = cs.make_inputs(torch, kernel, shape, gen, device)
                if backward:
                    bargs = cs.make_bwd_inputs(torch, fused, kernel, fargs, gen)
                    need_dx = cs.needs_dx(kernel, shape)

                    def fn():
                        return fused.fused_vanilla_rnn_bwd(*bargs, need_dx=need_dx)
                else:
                    def fn():
                        return forwards[kernel](*fargs)
                out = fn()
                torch.cuda.synchronize()
                key = f"{name} {cs.jdump(shape)}"
                flat = [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]
                outputs[key] = [t.cpu() for t in flat]
                ms = cs.device_ms(torch, fn)
            if backward:
                with torch.inference_mode(False):
                    lib = cs.library_bwd_fn(torch, kernel, fargs, need_dx, gen)
                    lib_ms = cs.device_ms(torch, lib)
            else:
                with torch.inference_mode():
                    lib_fn = cs.library_fn(torch, kernel)
                    lib_ms = cs.device_ms(torch, lambda: lib_fn(*fargs))
            nbytes, flops = cs.work(kernel, shape, backward=backward)
            bound = 1e3 * max(nbytes / cs.PEAK_BYTES, flops / cs.PEAK_F32)
            row = dict(shape=shape, calls=calls, ms=ms, library_ms=lib_ms, bound_ms=bound)
            if want is not None:
                ref = want[key]
                got = [t.cpu() for t in flat]
                row["max_abs_diff"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
                row["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, ref))
            rows.append(row)
            tot["calls"] += calls
            tot["ms"] += calls * ms
            tot["lib"] += calls * lib_ms
            tot["bound"] += calls * bound
        c = tot["calls"]
        report[name] = dict(ms=tot["ms"] / c, library_ms=tot["lib"] / c,
                            bound_ms=tot["bound"] / c, calls_per_train_step=c)
        print(json.dumps(dict(kernel=name, root=str(root), sms=args.sms, card=card,
                              **report[name], shapes=rows)), flush=True)
    if args.save:
        torch.save(outputs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
