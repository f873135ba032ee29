#!/usr/bin/env python3
"""Where float32 rollouts of the release checkpoint leave float64, and why.

Runs on one CUDA card, from the root of the repository:

    python3 tools/rollout_divergence.py [--seeds 8] [--rollout_len 100] [--out FILE]

It sets up the rollout of ``chip_smoke.py``'s rollout phase (the release
checkpoint of the port, 32 examples of its font valid set, 5 conditioning
frames, ``scripts/rollout.py``'s model and frames) and, for each noise seed
(seed 0 is the phase's noise) and switch setting (no switch, the glimpse
switch, both), rolls it out three times under the same recorded noise:

  kernels       every kernel
  plain         every plain version, on the card
  plain_jitter  plain, every output but a presence times 1 + --jitter xi
                (xi standard normal): rounding of a chosen size, no kernel
  ref_f64       the plain versions in float64 (the referee)

For the float32 runs it gives the first frame at which a field of the
record lies ``--part`` from the referee (|a - b| / (|b| + 1), as
chip_smoke's frame distances), that field, and the first presence draw
that the run samples otherwise than the referee.  During the kernels' run it
also holds every kernel call's output, and its plain version's on the same
inputs, against the plain version in float64 on those inputs: per kernel,
the calls and, of e = (out - f64) / (|f64| + 1) over each call's output
elements, the largest max |e|, the mean over the calls of max |e| and of
the root mean square of e, and the mean of e over its root mean square
(the bias: ~0 where the rounding errors cancel), for the kernel and for
the plain version (presence fields left out: a draw at a near-tie is a
flip, not a rounding).  At a run's departure it gives the field's value
and |a - b| there and its distance a frame before and after.

Why: a generated frame multiplies a run's distance to the referee by a
factor, so a run leaves it where its early rounding, amplified, passes the
bound; the frame varies with the noise, and a kernel whose calls round
further from float64 than their plain versions leaves it earlier on the
whole.  One JSON object per seed and setting on standard output and in
``--out``, then a summary per setting: each run's departure frames over the
seeds (median, min, max) and each kernel's call distances.  ``--device cpu
--examples 2 --rollout_len 8 --seeds 1`` is a dry run of the logic (the
plain versions only).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

SETTINGS = (("no_switch", {}), ("glimpse", cs.GLIMPSE_SWITCH), ("both", cs.CELLS_SWITCH))
PRESENCE_OUTPUTS = {"fused_prop": (7,), "fused_disc": (7,)}  # presence: left out of the distances


@contextlib.contextmanager
def call_distances(torch):
    """Every kernel call inside the block, and its plain version on the same
    inputs, held against the plain version in float64 on those inputs.
    Yields {kernel: dict(calls, kernel_max, kernel_mean, plain_max,
    plain_mean)}, filled when the block ends."""
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

    table = cs.kernel_calls(fused, fg, fc)
    pending = {}

    def dist(got, ref, skip):
        """[max, root mean square, mean] of e = (out - f64) / (|f64| + 1)
        over every element of the outputs."""
        e = torch.cat([((a.double() - r) / (torch.abs(r) + 1.0)).reshape(-1)
                       for i, (a, r) in enumerate(zip(got, ref))
                       if a is not None and a.numel() and i not in skip])
        return torch.stack([e.abs().max(), e.square().mean().sqrt(), e.mean()])

    def recording(kernel, real, plain):
        def call(*args, **kw):
            out = real(*args, **kw)
            got, want = cs.as_tuple(out), cs.as_tuple(plain(*args))
            ref = cs.as_tuple(plain(*cs.to_double(torch, args)))
            skip = PRESENCE_OUTPUTS.get(kernel, ())
            pending.setdefault(kernel, []).append(
                torch.stack([dist(got, ref, skip), dist(want, ref, skip)]))
            return out
        return call

    report = {}
    with contextlib.ExitStack() as stack:
        for kernel, (module, name, plain) in table.items():
            stack.enter_context(mock.patch.object(
                module, name, recording(kernel, getattr(module, name), plain)))
        yield report
    for kernel, rows in pending.items():
        d = torch.stack(rows).cpu()  # [calls, (kernel, plain), (max, rms, mean)]
        entry = dict(calls=len(rows))
        for j, who in enumerate(("kernel", "plain")):
            bias = (d[:, j, 2] / d[:, j, 1].clamp(min=1e-30)).mean()  # ~0 when unbiased
            entry.update({f"{who}_max": f"{float(d[:, j, 0].max()):.3e}",
                          f"{who}_mean": f"{float(d[:, j, 0].mean()):.3e}",
                          f"{who}_rms": f"{float(d[:, j, 1].mean()):.3e}",
                          f"{who}_bias": f"{float(bias):.3f}"})
        report[kernel] = entry


@contextlib.contextmanager
def jittered(torch, delta, gen):
    """The plain versions (``chip_smoke.plain_versions``) with every output
    but a presence multiplied by 1 + delta xi, xi standard normal from
    ``gen``: a run whose rounding differs from the plain run's by noise of
    a chosen size, with no kernel."""
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

    def jitter(fn, skip=()):
        def call(*args, **kw):
            out = fn(*args, **kw)
            outs = cs.as_tuple(out)
            outs = [t if i in skip else t * (1.0 + delta * torch.randn(
                t.shape, generator=gen, device=t.device, dtype=t.dtype))
                for i, t in enumerate(outs)]
            return tuple(outs) if isinstance(out, (tuple, list)) else outs[0]
        return call

    with mock.patch.multiple(fused, mlp_plain=jitter(fused.mlp_plain),
                             vanilla_rnn_plain=jitter(fused.vanilla_rnn_plain),
                             gru_plain=jitter(fused.gru_plain)), \
            mock.patch.object(fg, "glimpse_plain_fwd", jitter(fg.glimpse_plain_fwd)), \
            mock.patch.multiple(fc, prop_plain_fwd=jitter(fc.prop_plain_fwd, (7,)),
                                disc_plain_fwd=jitter(fc.disc_plain_fwd, (7,))), \
            cs.plain_versions(fused, fg, fc):
        yield


def departure(torch, np, rec, ref, part):
    """(first frame at which a field of ``rec`` lies ``part`` from ``ref``,
    or None; there: that field, the referee's value and |a - b| at the
    farthest element, and the field's distance a frame before and after;
    the largest distance at each tenth frame)."""
    errs = cs.frame_errors(torch, rec, ref)
    worst = np.max(np.stack(list(errs.values())), 0)
    over = np.nonzero(worst > part)[0]
    if not over.size:
        return None, None, worst
    t = int(over[0])
    field = max(errs, key=lambda n: float(errs[n][t]))
    a, b = rec[field][t].double().reshape(-1), ref[field][t].double().reshape(-1)
    i = int(torch.argmax(torch.abs(a - b) / (torch.abs(b) + 1.0)))
    T = len(worst)
    at = dict(field=field, value=f"{float(b[i]):.4g}", abs_diff=f"{float(abs(a[i] - b[i])):.3e}",
              before=f"{float(errs[field][t - 1]):.2e}" if t else None,
              after=f"{float(errs[field][t + 1]):.2e}" if t + 1 < T else None)
    return t, at, worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--rollout_len", type=int, default=cs.ROLLOUT["rollout_len"])
    ap.add_argument("--examples", type=int, default=cs.ROLLOUT["n_examples"])
    ap.add_argument("--part", type=float, default=cs.PART_AT)
    ap.add_argument("--jitter", type=float, default=1e-7,
                    help="the plain_jitter run's relative noise on every output (0: no such run)")
    ap.add_argument("--out", default=str(REPO / "results" / "rollout_divergence.jsonl"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("rollout_divergence: this script needs a card", file=sys.stderr)
        return 1
    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.ops import build, fused, stn
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.scripts import rollout

    stn.full_fp32_matmul()
    device = torch.device(args.device)
    kernels = device.type == "cuda"
    if kernels:
        build.library()
    card = "cpu"
    if kernels:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    # the rollout script's model and frames, as the rollout phase has them
    captured = {}

    class Captured(Exception):
        pass

    def capture(model, obs, noise):
        captured.update(model=model, obs=obs)
        raise Captured

    cond = cs.ROLLOUT["condition_frames"]
    pflags.reset()
    try:
        with mock.patch.object(rollout, "generate", capture):
            rollout.main([f"--checkpoint_dir={cs.PORT_RELEASE}", f"--device={device.type}",
                          f"--n_examples={args.examples}", f"--rollout_len={args.rollout_len}",
                          f"--condition_frames={cond}"])
    except Captured:
        pass
    finally:
        pflags.reset()
    model, obs = captured["model"], captured["obs"]
    m64 = copy.copy(model)
    m64.sequence = copy.deepcopy(model.sequence).double()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []
    with open(args.out, "w") as f:
        for seed in range(args.seeds):
            for label, switches in SETTINGS:
                t0 = time.perf_counter()
                noise = GeneratorNoise(torch.Generator(device=device).manual_seed(seed), device,
                                       record=True)
                runs, sites = {}, {}
                with cs.switched(switches):
                    calls = {}
                    if kernels:
                        with call_distances(torch) as calls, \
                                cs.presence_sites(torch, model) as sites["kernels"]:
                            runs["kernels"] = rollout.generate(model, obs, noise)
                    table = noise.table
                    with cs.plain_versions(fused, fg, fc):
                        if not kernels:
                            runs["kernels"] = None
                            rollout.generate(model, obs, noise)  # records the noise
                        with cs.presence_sites(torch, model) as sites["plain"]:
                            runs["plain"] = rollout.generate(model, obs,
                                                             ReplayNoise(table, device))
                    if args.jitter:
                        gen = torch.Generator(device=device).manual_seed(10_000 + seed)
                        with jittered(torch, args.jitter, gen), \
                                cs.presence_sites(torch, model) as sites["plain_jitter"]:
                            runs["plain_jitter"] = rollout.generate(model, obs,
                                                                    ReplayNoise(table, device))
                    with cs.plain_versions(fused, fg, fc):
                        with cs.presence_sites(torch, m64) as sites["ref"]:
                            ref = rollout.generate(m64, obs.double(),
                                                   ReplayNoise(table, device, torch.float64))
                line = dict(seed=seed, setting=label, card=card)
                for name, rec in runs.items():
                    if rec is None:
                        continue
                    t, at, worst = departure(torch, np, rec, ref, args.part)
                    flip, crossed = cs.first_flip(sites[name], sites["ref"], table)
                    line[name] = dict(departs=t, at=at, first_flip=flip,
                                      flip_crossed=crossed,
                                      every_10th=[f"{float(w):.2e}" for w in worst[::10]])
                line["calls"] = calls
                line["seconds"] = round(time.perf_counter() - t0, 3)
                print(json.dumps(line), flush=True)
                f.write(json.dumps(line) + "\n")
                lines.append(line)
                del runs, ref
        summary = dict(summary=True, part=args.part, card=card)
        for label, _ in SETTINGS:
            mine = [ln for ln in lines if ln["setting"] == label]
            entry = {}
            for name in ("kernels", "plain", "plain_jitter"):
                frames = [ln[name]["departs"] for ln in mine if name in ln]
                frames = [args.rollout_len if t is None else t for t in frames]
                if frames:
                    entry[name] = dict(median=statistics.median(frames), min=min(frames),
                                       max=max(frames), frames=frames)
            calls = {}
            for ln in mine:
                for kernel, c in ln["calls"].items():
                    acc = calls.setdefault(kernel, {})
                    for key, v in c.items():
                        if key != "calls":
                            acc.setdefault(key, []).append(float(v))
            # over the seeds: the largest of the max, the mean of the rest
            entry["calls"] = {
                k: {key: f"{max(v) if key.endswith('_max') else statistics.mean(v):.3e}"
                    for key, v in acc.items()} for k, acc in calls.items()}
            summary[label] = entry
        print(json.dumps(summary), flush=True)
        f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
