#!/usr/bin/env python3
"""Drives the PyTorch / CUDA port of SQAIR (sqair_tpu_torch) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs one Hopper card (sm_90a) and the CUDA toolkit, and no network.
Phases, one line each with its own numbers and seconds:

  device   card name, power limit, torch and CUDA versions
  build    nvcc build of sqair_tpu_torch/csrc (or the cached library)
  kernels  every kernel against its plain PyTorch version at the shapes the
           eval step gives it (random inputs from a seed)
  eval     3 eval steps of the release model's flags at full width (weights
           from a seed, data from the port's generator), with the launch
           counts of every kernel; batch 0 re-run through the plain
           versions on the card and on the CPU with the same noise
  timing   CUDA-event medians per kernel (kernel, plain version, a chain of
           torch.addmm + activation, and the bound) and of the eval step
  profile  the device's busy time in one eval step (torch.profiler)

It exits non-zero on any failure.  The last two lines are a JSON object of
the kernels' numbers and the JSON result line.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
RELEASE_FLAGS = REPO / "release_models" / "mnist_mlp" / "1" / "flags.json"
SEED = 0
N_BATCHES = 3
REPS = 20

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# tolerances, with why: the kernel and its plain version compute the same
# f32 sums in another order, over at most 2500 terms of size ~1
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-4
# the eval metrics sum those differences over T x 2S dependent cell steps
METRIC_TOL = 1e-4  # on |a - b| / (|b| + 1)

KERNELS = {
    "fused_mlp": dict(source="sqair_tpu_torch/csrc/fused_mlp.cu",
                      replaces="sqair_tpu/ops/fused.py:111"),
    "fused_vanilla_rnn": dict(source="sqair_tpu_torch/csrc/fused_rnn.cu",
                              replaces="sqair_tpu/ops/fused.py:201"),
    "fused_gru": dict(source="sqair_tpu_torch/csrc/fused_rnn.cu",
                      replaces="sqair_tpu/ops/fused.py:308"),
}


def log(phase, t0, **fields):
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body} seconds={time.perf_counter() - t0:.3f}", flush=True)


class Failure(Exception):
    pass


def main_path_shapes(F, rows):
    """Every kernel call of one frame of the eval step, as
    (kernel, shape, calls per frame); ``rows`` = B * k."""
    h = 32 * int(F["n_units"])
    w, S = int(F["n_what"]), int(F["n_steps_per_image"])
    g = int(F["glimpse_size"]) ** 2
    img = 50 * 50
    slots = rows * S
    sp = h // 2
    mlp = [  # (d_in, widths, transfers, rows, calls)
        (img, [h, h], ["elu", "elu"], rows, 1),                   # input encoder
        (g, [h, h], ["elu", "elu"], rows, 3 * S),                 # glimpse encoder
        (h, [128, g], ["elu", "sigmoid"], rows, 2 * S),           # glimpse mask
        (h, [h, h, 8], ["elu", "elu", "id"], rows, S),            # disc where
        (2 * h + 4, [h, h, 8], ["elu", "elu", "id"], rows, S),    # prop where
        (h + w, [sp, 1], ["elu", "id"], rows, S),                 # disc presence
        (2 * h + w, [sp, 1], ["elu", "id"], rows, S),             # prop presence
        (h, [128, 4], ["elu", "id"], rows, S),                    # where bias
        (h, [3 * w], ["sigmoid"], rows, S),                       # what gates
        (w + 4, [h, h], ["elu", "elu"], slots, 1),                # latent encoder
        (1, [10, S + 1], ["elu", "id"], rows, 1),                 # count prior
        (w, [h, h, g], ["elu", "elu", "id"], slots, 1),           # glimpse decoder
    ]
    vrnn = [  # (d_x, units, rows, calls)
        (h + h + w + 5, h, rows, S),         # discovery transition
        (3 * w + 10 + h, h, rows, S),        # propagation transition
        (4, 4, rows, S),                     # where prior
    ]
    gru = [
        (w + 4, h, slots, 1),                # propagation prior
        (h + 4 + 2 * w, h, rows, S),         # temporal cell
    ]
    out = [("fused_mlp", dict(d_in=d, widths=ws, acts=a, n=n), c) for d, ws, a, n, c in mlp]
    out += [("fused_vanilla_rnn", dict(dx=d, units=u, n=n), c) for d, u, n, c in vrnn]
    out += [("fused_gru", dict(dx=d, units=u, n=n), c) for d, u, n, c in gru]
    return out


def make_inputs(torch, kernel, shape, gen, device):
    """Seeded inputs at a kernel's shape: x in [0, 1) like the image and the
    probabilities, weights of lecun scale, small biases."""
    def rand(*s):
        return torch.rand(s, generator=gen, device=device)

    def weight(d_in, d_out):
        return torch.randn((d_in, d_out), generator=gen, device=device) / math.sqrt(d_in)

    def bias(d):
        return 0.1 * torch.randn((d,), generator=gen, device=device)

    if kernel == "fused_mlp":
        dims = [shape["d_in"]] + shape["widths"]
        params = tuple((weight(a, b), bias(b)) for a, b in zip(dims[:-1], dims[1:]))
        return (rand(shape["n"], shape["d_in"]), params, tuple(shape["acts"]))
    n, dx, u = shape["n"], shape["dx"], shape["units"]
    x, h = rand(n, dx), 2 * rand(n, u) - 1
    if kernel == "fused_vanilla_rnn":
        return (x, h, weight(dx, u), weight(u, u), bias(u))
    return (x, h, weight(dx, 2 * u), weight(u, 2 * u), bias(2 * u), weight(dx, u),
            weight(u, u), bias(u))


def work(kernel, shape):
    """(bytes read once and written once, f32 FLOPs) of one call."""
    n = shape["n"]
    if kernel == "fused_mlp":
        dims = [shape["d_in"]] + shape["widths"]
        weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        macs = n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        return 4 * (n * dims[0] + weights + n * dims[-1]), 2 * macs
    dx, u = shape["dx"], shape["units"]
    mult = 1 if kernel == "fused_vanilla_rnn" else 3  # the GRU's gates + candidate
    weights = mult * ((dx + u) * u + u)
    return 4 * (n * (dx + u) + weights + n * u), 2 * n * mult * (dx + u) * u


def library_fn(torch, kernel):
    """The same function as one chain of torch.addmm + activation (a
    yardstick only: the port never calls it)."""
    F = torch.nn.functional
    act = {"id": lambda z: z, "elu": F.elu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}
    if kernel == "fused_mlp":
        def mlp(x, params, acts):
            for (w, b), a in zip(params, acts):
                x = act[a](torch.addmm(b, x, w))
            return x
        return mlp
    if kernel == "fused_vanilla_rnn":
        return lambda x, h, w, u, b: torch.tanh(torch.addmm(torch.addmm(b, x, w), h, u))

    def gru(x, h, wg, ug, bg, wc, uc, bc):
        zr = torch.sigmoid(torch.addmm(torch.addmm(bg, x, wg), h, ug))
        z, r = zr[:, :h.shape[1]], zr[:, h.shape[1]:]
        c = torch.tanh(torch.addmm(torch.addmm(bc, x, wc), r * h, uc))
        return (1 - z) * h + z * c
    return gru


def device_ms(torch, fn, calls=50, reps=REPS):
    """Median over ``reps`` of the device time per call of ``fn``, from CUDA
    events around ``calls`` back-to-back calls.  A spin kernel runs first,
    so that the host has queued every call before the device reaches them
    and the events time the device, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def profile_device(torch, fn):
    """Device time of one call of ``fn`` under torch.profiler (ms, summed over
    every device activity), and the five largest contributors by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    top = [dict(name=k[:60], ms=round(ms, 3), count=c) for k, ms, c in rows[:5]]
    return sum(ms for _, ms, _ in rows), top


def compare_metrics(torch, got, want, what):
    worst, worst_key = 0.0, None
    for key, ref in want.items():
        a = got[key].detach().double().cpu()
        b = ref.detach().double().cpu()
        if not torch.isfinite(a).all():
            raise Failure(f"{what}: metric {key} is not finite: {a}")
        err = float(torch.max(torch.abs(a - b) / (torch.abs(b) + 1.0)))
        if err > worst:
            worst, worst_key = err, key
    if worst > METRIC_TOL:
        raise Failure(f"{what}: metric {worst_key} differs by {worst:.3g} > {METRIC_TOL}: "
                      f"{got[worst_key]} vs {want[worst_key]}")
    return worst


def run():
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.data import create_seq_dataset, make_template_bank
    from sqair_tpu_torch.ops import build, fused
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.training import make_eval_step

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log("device", t0, name=repr(kind), count=torch.cuda.device_count(),
        capability=torch.cuda.get_device_capability(0), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(card, flush=True)

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    build.library()
    log("build", t0, cached=build.last_build["cached"],
        build_seconds=f"{build.last_build['seconds']:.3f}",
        library=Path(build.last_build["path"]).name)

    # ----------------------------------------------------------- kernels
    flags = json.loads(RELEASE_FLAGS.read_text())
    B, k = int(flags["batch_size"]), int(flags["k_particles"])
    T = int(flags.get("font_timesteps", 10))
    shapes = main_path_shapes(flags, B * k)
    wrappers = {"fused_mlp": fused.fused_mlp, "fused_vanilla_rnn": fused.fused_vanilla_rnn,
                "fused_gru": fused.fused_gru}
    plains = {"fused_mlp": fused.mlp_plain, "fused_vanilla_rnn": fused.vanilla_rnn_plain,
              "fused_gru": fused.gru_plain}
    gen = torch.Generator(device=device).manual_seed(SEED)
    checked = []
    with torch.inference_mode():
        for kernel, shape, calls in shapes:
            t0 = time.perf_counter()
            args = make_inputs(torch, kernel, shape, gen, device)
            got = wrappers[kernel](*args)
            want = plains[kernel](*args)
            torch.cuda.synchronize()
            diff = torch.abs(got - want)
            abs_err = float(torch.max(diff))
            # relative error where the value is not near 0 (|value| >= 1e-2)
            big = torch.abs(want) >= 1e-2
            rel_err = float(torch.max(diff[big] / torch.abs(want[big]))) if big.any() else 0.0
            ok = bool(torch.all(diff <= KERNEL_ATOL + KERNEL_RTOL * torch.abs(want)))
            log("kernels", t0, kernel=kernel, shape=json.dumps(shape, separators=(",", ":")),
                max_abs_err=f"{abs_err:.3e}", max_rel_err=f"{rel_err:.3e}",
                tol=f"|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|value|", ok=ok)
            if not ok or got.shape != want.shape:
                raise Failure(f"{kernel} {shape}: kernel disagrees with its plain version")
            checked.append((kernel, shape, calls, args, abs_err))

    # -------------------------------------------------------------- eval
    t0 = time.perf_counter()
    n_seq = N_BATCHES * B
    data = create_seq_dataset(n_samples=n_seq, n_timesteps=T, canvas_size=(50, 50),
                              obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 1,
                              templates=make_template_bank(256, 28, seed=SEED))
    imgs = data["imgs"].astype("float32") / 255.0  # [T, N, 50, 50]
    nums = data["nums"].astype("float32").repeat(T, 0)  # [T, N, 3]
    model = mlp_mnist_model.load(flags, imgs.shape[2:], mean_img=imgs.mean((0, 1)),
                                 device=device, seed=SEED)
    eval_step = make_eval_step(model)
    log("eval-setup", t0, sequences=n_seq, T=T, B=B, k=k,
        params=sum(p.numel() for p in model.sequence.parameters()))

    batches = [(imgs[:, i * B:(i + 1) * B], nums[:, i * B:(i + 1) * B])
               for i in range(N_BATCHES)]
    noise_gen = torch.Generator(device=device).manual_seed(SEED + 2)
    fused.reset_launches()
    t0 = time.perf_counter()
    # batch 0's noise is recorded for the re-runs below
    noises = [GeneratorNoise(noise_gen, device, record=(i == 0)) for i in range(N_BATCHES)]
    results = [eval_step(obs, gt, noise) for (obs, gt), noise in zip(batches, noises)]
    noise0 = noises[0].table
    torch.cuda.synchronize()
    counts = dict(fused.launches)
    per_frame = {name: sum(c for kn, _, c in shapes if kn == name) for name in KERNELS}
    expected = {name: N_BATCHES * T * c for name, c in per_frame.items()}
    for i, m in enumerate(results):
        for key, v in m.items():
            if not torch.isfinite(v).all():
                raise Failure(f"batch {i}: metric {key} is not finite")
    log("eval", t0, steps=N_BATCHES, launches=json.dumps(counts, separators=(",", ":")),
        expected=json.dumps(expected, separators=(",", ":")),
        iwae=f"{float(results[0]['iwae']):.4f}",
        num_step_accuracy=f"{float(results[0]['num_step_accuracy']):.4f}",
        mse=f"{float(results[0]['mse']):.5f}")
    if counts != expected:
        raise Failure(f"launch counts {counts} differ from the main path's {expected}")

    t0 = time.perf_counter()
    obs0, gt0 = batches[0]
    with mock.patch.object(fused, "fused_mlp", fused.mlp_plain), \
            mock.patch.object(fused, "fused_vanilla_rnn", fused.vanilla_rnn_plain), \
            mock.patch.object(fused, "fused_gru", fused.gru_plain):
        fused.reset_launches()
        plain = eval_step(obs0, gt0, ReplayNoise(noise0, device))
        if sum(fused.launches.values()):
            raise Failure("the plain re-run launched a kernel")
    err_plain = compare_metrics(torch, results[0], plain, "kernels vs plain on the card")
    cpu_model = copy.copy(model)
    cpu_model.sequence = copy.deepcopy(model.sequence).cpu()
    cpu = make_eval_step(cpu_model)(obs0, gt0, ReplayNoise(
        {key: v.cpu() for key, v in noise0.items()}, "cpu"))
    err_cpu = compare_metrics(torch, results[0], cpu, "card vs the CPU")
    log("eval-check", t0, vs_plain_on_card=f"{err_plain:.3e}", vs_cpu=f"{err_cpu:.3e}",
        tol=METRIC_TOL, metrics=len(plain))

    # ------------------------------------------------------------ timing
    rows = {name: dict(weight=0, ms=0.0, plain=0.0, lib=0.0, bound=0.0, t_bytes=0.0,
                       t_ops=0.0, err=0.0) for name in KERNELS}
    with torch.inference_mode():
        for kernel, shape, calls, args, abs_err in checked:
            t0 = time.perf_counter()
            ms = device_ms(torch, lambda: wrappers[kernel](*args))
            plain_ms = device_ms(torch, lambda: plains[kernel](*args))
            lib = library_fn(torch, kernel)
            lib_ms = device_ms(torch, lambda: lib(*args))
            nbytes, flops = work(kernel, shape)
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
            log("timing", t0, kernel=kernel, shape=json.dumps(shape, separators=(",", ":")),
                calls_per_frame=calls, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                library_ms=f"{lib_ms:.5f}", bound_ms=f"{max(t_bytes, t_ops):.5f}",
                bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
            r = rows[kernel]
            r["weight"] += calls
            r["ms"] += calls * ms
            r["plain"] += calls * plain_ms
            r["lib"] += calls * lib_ms
            r["bound"] += calls * max(t_bytes, t_ops)
            r["t_bytes"] += calls * t_bytes
            r["t_ops"] += calls * t_ops
            r["err"] = max(r["err"], abs_err)

    t0 = time.perf_counter()
    step_noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 3), device)
    for _ in range(2):
        eval_step(obs0, gt0, step_noise)
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eval_step(obs0, gt0, step_noise)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    log("timing", t0, eval_step_ms=f"{step_ms:.3f}",
        frames_per_s=f"{B * T / (step_ms / 1e3):.1f}", reps=REPS, B=B, T=T, k=k,
        card=repr(card))

    t0 = time.perf_counter()
    busy_ms, top = profile_device(torch, lambda: eval_step(obs0, gt0, step_noise))
    if busy_ms is None:
        log("profile", t0, device_busy="not-measured (the profiler saw no device time)")
    else:
        log("profile", t0, device_busy_ms=f"{busy_ms:.3f}", step_ms=f"{step_ms:.3f}",
            busy_share=f"{busy_ms / step_ms:.3f}",
            top=json.dumps(top, separators=(",", ":")), card=repr(card))

    kernels = []
    for name, meta in KERNELS.items():
        r = rows[name]
        w = r["weight"]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=counts[name], max_abs_err=r["err"], ms=r["ms"] / w,
            plain_ms=r["plain"] / w, bound_ms=r["bound"] / w,
            bound_by="bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
            library_ms=r["lib"] / w))
    log("total", t_all, ok=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(run())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
