#!/usr/bin/env python3
"""Where one train step's gradients part between f32 runs of the port.

Runs on one CUDA card, from the root of the repository:

    python3 tools/torch_grad_referee.py [--seeds 6] [--out FILE]

It rebuilds the model and the 3 train steps of ``chip_smoke.py`` (the
release flags at full width, weights from seed 0), then for each seed takes
a batch and its noise (seed 0: chip_smoke's train-check batch and noise)
and computes one train step's parameter gradients in these runs:

  kernels_off    every kernel, SQAIR_FUSE_GLIMPSE off
  plain_off      every plain version, switch off
  kernels_on     every kernel, switch on
  plain_on       every plain version, switch on
  mlp_only_on    fused_mlp and the glimpse kernels, the cells plain, switch on
  cells_only_on  the cell kernels and the glimpse kernels, fused_mlp plain
  mlp_fwd_on     mlp_only_on with fused_mlp's backward plain
  mlp_bwd_on     mlp_only_on with fused_mlp's forward plain
  ref_off_f64    the plain versions in float64, switch off (the referee)
  ref_on_f64     the plain versions in float64, switch on (its referee)

and with ``--fuse_cells`` also SQAIR_FUSE_CELLS (with the glimpse switch,
the JAX package's all-opt-in configuration: the fused propagation unroll):

  kernels_fuse_cells  every kernel
  plain_fuse_cells    every plain version
  ref_fuse_cells_f64  the plain versions in float64 (its referee)

and the same three with both switches on the model at chip_smoke's
DISC_FLAGS (the same weights; discovery runs fused too):

  kernels_fuse_disc   every kernel
  plain_fuse_disc     every plain version
  ref_fuse_disc_f64   the plain versions in float64 (its referee)

and each f32 run's distance to the referee of its switch: max over
parameters of max|g - g64| / max|g64|.  f32 rounding moves a run across a
kink of the step's gradient now and then (``chip_smoke.kinks``: the
interpolation coordinates of a glimpse crop, of a fused frame kernel's crop
or of the decoder's paste crossing an integer, the transient penalty's
relu).  It counts the kinks
at which each run lies on another side than its referee, then runs
everything again with the gradient through the union of them zeroed, one
kind at a time and all together, and gives the distances again: what is
left is the step's smooth part.  One JSON object per seed on standard
output and in ``--out``, then a summary: for each f32 run that uses a
kernel, the geometric mean over the seeds of its distance to its referee
over the plain run's with the same switches, every crossed kink masked
(the ratio train-check's gate is built on).  ``--device cpu`` with a small ``--batch_size``
and ``--timesteps`` is a dry run of the logic (the plain versions only).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--out", default=str(REPO / "results" / "grad_referee.jsonl"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch_size", type=int, default=None, help="overrides the flags'")
    ap.add_argument("--timesteps", type=int, default=None, help="overrides the flags'")
    ap.add_argument("--fuse_cells", action="store_true",
                    help="add the runs with SQAIR_FUSE_CELLS (and SQAIR_FUSE_GLIMPSE), "
                         "at the release flags and at DISC_FLAGS")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_grad_referee: this script needs a card", file=sys.stderr)
        return 1
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.data import DeviceDatasetSampler, create_seq_dataset, make_template_bank
    from sqair_tpu_torch.models.air import AIRDecoder, AIREncoder
    from sqair_tpu_torch.ops import build, fused, stn
    from sqair_tpu_torch.ops import distributions as D
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.training import make_train_step

    stn.full_fp32_matmul()
    device = torch.device(args.device)
    if device.type == "cuda":
        build.library()
    flags = json.loads(cs.RELEASE_FLAGS.read_text())
    if args.batch_size:
        flags["batch_size"] = args.batch_size
    if args.timesteps:
        flags["font_timesteps"] = args.timesteps
    B, T = int(flags["batch_size"]), int(flags.get("font_timesteps", 10))
    glimpse = [int(flags["glimpse_size"])] * 2
    data = create_seq_dataset(n_samples=cs.N_BATCHES * B, n_timesteps=T, canvas_size=cs.IMG,
                              obj_size=(28, 28), n_objects=(0, 2), seed=cs.SEED + 1,
                              templates=make_template_bank(256, 28, seed=cs.SEED))
    imgs = data["imgs"].astype("float32") / 255.0
    model = mlp_mnist_model.load(flags, imgs.shape[2:], mean_img=imgs.mean((0, 1)),
                                 device=device, seed=cs.SEED)
    sampler = DeviceDatasetSampler(data, device)
    optimizer, l2 = mlp_mnist_model.make_optimizer(flags)
    train_step = make_train_step(model, optimizer, l2_weight=l2)
    data_gen = torch.Generator(device=device).manual_seed(cs.SEED + 4)
    train_noise = GeneratorNoise(torch.Generator(device=device).manual_seed(cs.SEED + 5),
                                 device)
    train_batches = [sampler.sample(data_gen, B) for _ in range(cs.N_TRAIN_STEPS)]
    for b in train_batches:
        train_step(b["imgs"], b["nums"], train_noise)
    ref_model = copy.copy(model)
    ref_model.sequence = copy.deepcopy(model.sequence).double()
    # the same weights at DISC_FLAGS (the levers hold no weights)
    disc_model = mlp_mnist_model.load(dict(flags, **cs.DISC_LEVERS), imgs.shape[2:],
                                      mean_img=imgs.mean((0, 1)), device=device, seed=cs.SEED)
    disc_model.sequence.load_state_dict(model.sequence.state_dict())
    disc_ref = copy.copy(disc_model)
    disc_ref.sequence = copy.deepcopy(disc_model.sequence).double()

    def plain():
        return cs.plain_versions(fused, fg, fc)

    def plain_cells():
        return mock.patch.multiple(fused, fused_vanilla_rnn=fused.vanilla_rnn_plain,
                                   fused_gru=fused.gru_plain)

    def plain_mlp():
        return mock.patch.multiple(fused, fused_mlp=fused.mlp_plain)

    def plain_mlp_bwd():
        def bwd(x, params, transfers, acts, g, need_dx=True):
            dx, dparams = fused.mlp_bwd_plain(x, params, transfers, acts, g)
            return (dx if need_dx else None), dparams

        return mock.patch.object(fused, "fused_mlp_bwd", bwd)

    def plain_mlp_fwd():
        return mock.patch.object(fused, "_mlp_fwd_cuda",
                                 lambda x2, params, transfers, save:
                                 fused.mlp_plain_acts(x2, params, transfers))

    # name: (switches, patches, float64)
    runs = {"kernels_off": ("off", [], False), "plain_off": ("off", [plain], False),
            "kernels_on": ("glimpse", [], False), "plain_on": ("glimpse", [plain], False),
            "mlp_only_on": ("glimpse", [plain_cells], False),
            "cells_only_on": ("glimpse", [plain_mlp], False),
            "mlp_fwd_on": ("glimpse", [plain_cells, plain_mlp_bwd], False),
            "mlp_bwd_on": ("glimpse", [plain_cells, plain_mlp_fwd], False),
            "ref_off_f64": ("off", [plain], True), "ref_on_f64": ("glimpse", [plain], True)}
    if args.fuse_cells:
        runs.update({"kernels_fuse_cells": ("cells", [], False),
                     "plain_fuse_cells": ("cells", [plain], False),
                     "ref_fuse_cells_f64": ("cells", [plain], True),
                     "kernels_fuse_disc": ("disc", [], False),
                     "plain_fuse_disc": ("disc", [plain], False),
                     "ref_fuse_disc_f64": ("disc", [plain], True)})
    refs = {"off": "ref_off_f64", "glimpse": "ref_on_f64", "cells": "ref_fuse_cells_f64",
            "disc": "ref_fuse_disc_f64"}
    referee = {n: refs[sw] for n, (sw, _, _) in runs.items()}
    f32 = [n for n, (_, _, f64) in runs.items() if not f64]

    def gradients(name, batch, table, keep=None):
        sw, patches, f64 = runs[name]
        m = (disc_ref if f64 else disc_model) if sw == "disc" else (ref_model if f64 else model)
        dtype = torch.float64 if f64 else torch.float32
        with contextlib.ExitStack() as stack:
            stack.enter_context(cs.switched(cs.SWITCHES[sw]))
            for p in patches:
                stack.enter_context(p())
            rec = stack.enter_context(cs.kinks(torch, AIREncoder, AIRDecoder, D,
                                               None if keep is None
                                               else keep[cs.KINK_GROUPS[sw]], fc))
            grads, _ = cs.step_gradients(torch, m, batch["imgs"].to(dtype),
                                         batch["nums"].to(dtype),
                                         ReplayNoise(table, device, dtype=dtype), l2)
        return grads, rec

    def distance(g, ref):
        errs = cs.grad_errors(torch, g, ref, "referee")
        return dict(share=errs[-1][0], worst=errs[-1][1])

    def distances(g):
        out = {n: distance(g[n], g[referee[n]]) for n in f32}
        out["kernels_on_vs_plain_off"] = distance(g["kernels_on"], g["plain_off"])
        out["referees_apart"] = distance(g["ref_on_f64"], g["ref_off_f64"])
        if "ref_fuse_cells_f64" in g:
            out["cells_referees_apart"] = distance(g["ref_fuse_cells_f64"], g["ref_off_f64"])
        return out

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plain_of = {sw: n for n, (sw, patches, f64) in runs.items()
                if n.startswith("plain_") and not f64}
    log_ratios = {n: [] for n in f32 if not n.startswith("plain_")}
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        if seed == 0:
            batch, noise_seed = train_batches[0], cs.SEED + 6
        else:
            batch = sampler.sample(torch.Generator(device=device).manual_seed(1000 + seed), B)
            noise_seed = 2000 + seed
        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(noise_seed), device,
                               record=True)
        # the noise table (these gradients are discarded)
        cs.step_gradients(torch, model, batch["imgs"], batch["nums"], noise, l2)
        got = {n: gradients(n, batch, noise.table) for n in runs}
        union, crossed, flips = {}, {}, {}
        for n in f32:
            c, flips[n] = cs.kinks_crossed(torch, fg, stn, got[n][1], got[referee[n]][1],
                                           runs[n][0] != "off", cs.IMG, glimpse)
            crossed[n] = {kind: int(sum(int(x.sum()) for x in v)) for kind, v in c.items()}
            group = cs.KINK_GROUPS[runs[n][0]]
            u = union.get(group)
            union[group] = c if u is None else {k: [m | x for m, x in zip(u[k], c[k])] for k in c}
        kinds = list(union["off_glimpse"])
        keep_all = {g: {kind: [~m for m in u[kind]] for kind in kinds} for g, u in union.items()}
        ones = {g: {kind: [torch.ones_like(m) for m in u[kind]] for kind in kinds}
                for g, u in union.items()}
        variants = {kind: {g: dict(ones[g], **{kind: keep_all[g][kind]}) for g in union}
                    for kind in kinds}
        variants["all"] = keep_all
        row = dict(seed=seed, crossed=crossed, presence_flips=flips,
                   masked={f"{g}.{kind}":
                           int(sum(int(m.sum()) for m in u[kind]))
                           for g, u in union.items() for kind in kinds},
                   none=distances({n: g[0] for n, g in got.items()}))
        for name, keep in variants.items():
            row[f"masked_{name}"] = distances(
                {n: gradients(n, batch, noise.table, keep)[0] for n in runs})
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        with out_path.open("a") as f:
            f.write(json.dumps(row) + "\n")
        for n, logs in log_ratios.items():
            masked = row["masked_all"]
            logs.append(math.log(masked[n]["share"] / masked[plain_of[runs[n][0]]]["share"]))
    summary = dict(summary="geometric mean over seeds of the masked distance to the referee, "
                           "kernel run over plain run",
                   seeds=args.seeds,
                   ratio={n: math.exp(sum(v) / len(v)) for n, v in log_ratios.items() if v})
    print(json.dumps(summary), flush=True)
    with out_path.open("a") as f:
        f.write(json.dumps(summary) + "\n")
    if device.type == "cuda":
        print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
              .read().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
