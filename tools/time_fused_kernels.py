#!/usr/bin/env python3
"""Times the kernels redesigned for Hopper of a checkout of this repository
(the MLP forward and backward, the vanilla-RNN and GRU forwards, the
vanilla-RNN backward, the glimpse encoder's forward and backward, the
propagation unroll's forward and backward, the discovery unroll's
forward and backward, the GRU backward) on one CUDA card, at every shape a
train step gives them (release
flags; the MLP and cells with no switch, the glimpse encoder with the
glimpse switch, masked and unmasked, the propagation unroll with both
switches, the discovery unroll with both at DISC_FLAGS, one call a frame),
beside one PyTorch call of the same function where there is one.  The GRU
forward runs as the train step calls it, saving zr and c; the glimpse
forward saving what its backward reads.

    python3 tools/time_fused_kernels.py [--root DIR] [--save FILE] [--compare FILE]
                                        [--sms N] [--profile] [--only K1,K2]

``--root`` is the checkout whose ``sqair_tpu_torch`` and ``chip_smoke.py``
are used (default: this one); it builds that checkout's kernels.  The inputs
come from ``chip_smoke.make_inputs`` and ``chip_smoke.prop_inputs`` with a
fixed seed, so two checkouts time the same calls.  ``--save`` writes every
output to a torch file and ``--compare`` holds this run's outputs to such a
file: the largest absolute difference and whether the bits are the same.
Prints one JSON line per kernel: the call-weighted ms, library ms and bound
ms over the train step's shapes, each shape's numbers, and the card's name
and power limit.  Run two checkouts in turns (A, B, B, A) in one call to
compare them.  ``--sms`` makes the host pick its launch geometry
(``ops/fused.py``, ``ops/fused_cells.py``, ``ops/fused_glimpse.py``: the
MLP's cluster sizes, the cells' column split, the vanilla-RNN backward's row
tile, the clusters of the kernels that hold a tile's state in every block)
as if the card had N SMs, e.g. 1 for one block a row tile.  ``--profile``
adds each shape's device time by CUDA kernel (torch.profiler over 10 calls,
ms a call): the split of a backward between its launches.  ``--only`` times
the kernels named (of ``KERNELS``) alone.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
UNROLLS = ("fused_prop", "fused_prop_bwd", "fused_disc", "fused_disc_bwd")  # 10 calls
KERNELS = ("fused_mlp", "fused_vanilla_rnn", "fused_gru", "fused_vanilla_rnn_bwd",
           "fused_mlp_bwd", "fused_prop", "fused_prop_bwd", "fused_gru_bwd", "fused_glimpse",
           "fused_glimpse_bwd", "fused_disc", "fused_disc_bwd")


def disc_fwd_call(torch, cs, fc, flags, rows, T, gen, device):
    """(shape, arguments of ``fc._disc_fwd_cuda``) of the discovery forward
    at DISC_FLAGS: the frames of the port's data generator and the inputs
    from ``gen``."""
    from sqair_tpu_torch.data import create_seq_dataset, make_template_bank

    dflags = dict(flags, **cs.DISC_LEVERS)
    dshape = cs.disc_shape(dflags, rows)
    frames = create_seq_dataset(
        n_samples=-(-rows // T), n_timesteps=T, canvas_size=cs.IMG, obj_size=(28, 28),
        n_objects=(0, 2), seed=SEED + 8,
        templates=make_template_bank(256, 28, seed=SEED))["imgs"]
    frames = torch.from_numpy(frames.reshape(-1, *cs.IMG).astype("float32") / 255.0)
    dargs, dweights = cs.disc_inputs(torch, fc, dshape, gen, device, frames)
    return dshape, (*dargs, dweights, cs.disc_dims(dshape))


def disc_bwd_call(torch, cs, fc, flags, rows, T, gen, device):
    """(shape, arguments of ``fc._disc_bwd_cuda``) of the discovery backward
    at DISC_FLAGS: ``disc_fwd_call``'s inputs, the saved tensors of the
    plain forward and random output gradients."""
    dshape, (*dargs, dweights, ddims) = disc_fwd_call(torch, cs, fc, flags, rows, T, gen,
                                                      device)
    with torch.inference_mode():
        want = fc.disc_plain_fwd(*dargs, dweights, ddims)
        cots = tuple(torch.randn(t.shape, generator=gen, device=device) for t in want[:9])
    saved = (want[0], want[2], want[3], want[5], want[6], want[7])
    return dshape, (*dargs, dweights, saved, want[9], want[10], want[11], cots, ddims)


def profile_split(torch, fn, calls=10):
    """Device ms a call of ``fn`` by CUDA kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    ap.add_argument("--sms", type=int)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--only", help="comma-separated kernels of KERNELS to time")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_fused_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sqair_tpu_torch.ops import build, fused, stn
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

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
    forwards = {"fused_mlp": fused.fused_mlp, "fused_vanilla_rnn": fused.fused_vanilla_rnn,
                "fused_gru": lambda *a: fused._gru_fwd_cuda(*a, save=True)}

    def calls_of(kernel):
        """(shape, calls, fn, library fn or None, (bytes, flops)) of each call
        of ``kernel`` in a train step, its inputs drawn from ``gen``."""
        out = []
        if kernel in ("fused_prop", "fused_prop_bwd"):
            pshape = cs.prop_shape(flags, B * k)
            pdims = cs.prop_dims(pshape)
            pargs, pweights = cs.prop_inputs(torch, fc, pshape, gen, device)
            if kernel == "fused_prop":
                return [(pshape, T, lambda: fc._fwd_cuda(*pargs, pweights, pdims), None,
                         cs.prop_work(pshape))]
            with torch.inference_mode():
                fwd = fc.prop_plain_fwd(*pargs, pweights, pdims)
                cots = tuple(torch.randn(t.shape, generator=gen, device=device)
                             for t in fwd[:10])
            saved = (fwd[0], fwd[2], fwd[3], fwd[5], fwd[6], fwd[7], fwd[9])
            pbargs = (*pargs, pweights, saved, fwd[10], cots, pdims)
            return [(pshape, T, lambda: fc._bwd_cuda(*pbargs), None,
                     cs.prop_work(pshape, backward=True))]
        if kernel == "fused_glimpse_bwd":
            for shape, calls in cs.glimpse_shapes(flags, B * k, T):
                dims, n = cs.glimpse_dims(shape), shape["n"]
                gargs = cs.glimpse_inputs(torch, shape, gen, device)
                with torch.inference_mode():
                    want = fg.glimpse_plain_fwd(*gargs, dims)
                    saved = tuple(want[2:5]) + (want[1],) + tuple(want[5:])
                    dloc, dscale = (torch.randn((n, shape["n_what"]), generator=gen,
                                                device=device) for _ in range(2))
                gbargs = gargs[:6] + (saved, dloc, dscale, dims)
                with torch.inference_mode(False):
                    lib = cs.glimpse_library_bwd_fn(torch, stn, shape, gargs, gen)
                out.append((shape, calls, lambda b=gbargs: fg.fused_glimpse_bwd(*b), lib,
                            cs.glimpse_work(shape, backward=True)))
            return out
        if kernel == "fused_glimpse":
            for shape, calls in cs.glimpse_shapes(flags, B * k, T):
                dims = cs.glimpse_dims(shape)
                gargs = cs.glimpse_inputs(torch, shape, gen, device)
                lib = cs.glimpse_library_fn(torch, stn, shape)
                out.append((shape, calls, lambda a=gargs, d=dims: fg._fwd_cuda(*a, d, save=True),
                            lambda a=gargs, f=lib: f(*a), cs.glimpse_work(shape)))
            return out
        if kernel == "fused_disc":
            dshape, dfargs = disc_fwd_call(torch, cs, fc, flags, B * k, T, gen, device)
            return [(dshape, T, lambda: fc._disc_fwd_cuda(*dfargs), None, cs.disc_work(dshape))]
        if kernel == "fused_disc_bwd":
            dshape, dbargs = disc_bwd_call(torch, cs, fc, flags, B * k, T, gen, device)
            return [(dshape, T, lambda: fc._disc_bwd_cuda(*dbargs), None,
                     cs.disc_work(dshape, backward=True))]
        base = kernel.removesuffix("_bwd")
        for kn, shape, calls in shapes:
            if kn != base:
                continue
            with torch.inference_mode():
                fargs = cs.make_inputs(torch, base, shape, gen, device)
                if kernel == base:
                    lib_fn = cs.library_fn(torch, base)
                    out.append((shape, calls, lambda f=fargs: forwards[base](*f),
                                lambda f=fargs, lf=lib_fn: lf(*f), cs.work(base, shape)))
                    continue
                bargs = cs.make_bwd_inputs(torch, fused, base, fargs, gen)
            need_dx = cs.needs_dx(base, shape)
            bwd = {"fused_mlp": fused.fused_mlp_bwd, "fused_vanilla_rnn": fused.fused_vanilla_rnn_bwd,
                   "fused_gru": fused.fused_gru_bwd}[base]
            with torch.inference_mode(False):
                lib = cs.library_bwd_fn(torch, base, fargs, need_dx, gen)
            out.append((shape, calls, lambda b=bargs, d=need_dx, f=bwd: f(*b, need_dx=d), lib,
                        cs.work(base, shape, backward=True, need_dx=need_dx)))
        return out

    for name in args.only.split(",") if args.only else KERNELS:
        entries = calls_of(name)
        rows, tot = [], dict(calls=0, ms=0.0, lib=0.0, bound=0.0)
        for shape, calls, fn, lib, (nbytes, flops) in entries:
            with torch.inference_mode():
                out = fn()
                torch.cuda.synchronize()
                key = f"{name} {cs.jdump(shape)}"
                flat = out if isinstance(out, tuple) else (out,)
                flat = [t for t in flat if t is not None]
                if name == "fused_mlp_bwd":
                    flat = [t for t in cs.flat_grads("fused_mlp", out) if t is not None]
                outputs[key] = [t.cpu() for t in flat]
                ms = cs.device_ms(torch, fn, calls=10 if name in UNROLLS else 50)
            lib_ms = None
            if lib is not None:
                with torch.inference_mode(not name.endswith("_bwd")):
                    lib_ms = cs.device_ms(torch, lib)
            bound = 1e3 * max(nbytes / cs.PEAK_BYTES, flops / cs.PEAK_F32)
            row = dict(shape=shape, calls=calls, ms=ms, library_ms=lib_ms, bound_ms=bound)
            if args.profile:
                with torch.inference_mode():
                    row["split_ms"] = profile_split(torch, fn)
            if want is not None and key in want:
                ref = want[key]
                got = outputs[key]
                row["max_abs_diff"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
                row["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, ref))
            rows.append(row)
            tot["calls"] += calls
            tot["ms"] += calls * ms
            tot["lib"] += calls * (lib_ms or 0.0)
            tot["bound"] += calls * bound
        c = tot["calls"]
        has_lib = all(r["library_ms"] is not None for r in rows)
        report = dict(ms=tot["ms"] / c, library_ms=tot["lib"] / c if has_lib else None,
                      bound_ms=tot["bound"] / c, calls_per_train_step=c)
        if want is not None:
            report["same_bits"] = all(r.get("same_bits", False) for r in rows)
        print(json.dumps(dict(kernel=name, root=str(root), sms=args.sms, card=card, **report,
                              shapes=rows)), flush=True)
    if args.save:
        torch.save(outputs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
