"""One run of one cell: set-up, the measured window, the traced slice and
the check that decides ``correct``, on one device.

Set-up makes the data and the weights on the device from the seed, builds
the program's training object and makes its first call (on the card: one
warm-up step, the capture of N steps and their first replay), which
records what the check compares.  The window then calls the chain back to
back for the given seconds.  A traced run profiles a few more calls after
the window.  Once the program's state is freed, the reference follows the
first steps from the same weights, batches and noise.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, Optional

import torch

from reference import train as reference_train
from reference.build import build_model
from reference.ops.noise import TableNoise

from . import digits, oracle, profiling, program, spec, weights, yardstick


def make_data(traffic: Dict, seed: int, device):
    """The data set and its mean frame (host float32 [H, W])."""
    g = torch.Generator(device=device).manual_seed(program.sub_seed(seed, 0))
    return digits.make_dataset(traffic["data"], seed, g)


def make_weights(config: Dict, mean_img, seed: int, device):
    return weights.make(config, mean_img,
                        torch.Generator(device=device).manual_seed(program.sub_seed(seed, 3)))


def set_up(cell: spec.Cell, seed: int, device, phases: Dict, t_start: float):
    """A run's set-up: the data, the weights, the program's training object
    and its first call.  Returns (data, mean frame, weights, the training
    object, what its first call recorded); ``phases`` gets the seconds from
    ``t_start`` at which each part ended."""
    config, traffic = cell.config, cell.traffic
    program.set_switches(traffic["switches"])
    data, mean_img = make_data(traffic, seed, device)
    phases["data"] = time.perf_counter() - t_start
    w0 = make_weights(config, mean_img, seed, device)
    phases["weights"] = time.perf_counter() - t_start
    training = program.Training(config, traffic, data, w0, mean_img, seed, device,
                                int(traffic["checked_steps"]))
    phases["program"] = time.perf_counter() - t_start
    return data, mean_img, w0, training, training.first_call()


def reference_batches(data, traffic: Dict, seed: int, steps: int, device):
    """The batches of the first ``steps`` train steps: the rows that the
    sampler's rule (``steps`` draws of B uniform indices from the data
    generator's seed) picks, as float32 in [0, 1], cut to the traffic's
    frames."""
    g = torch.Generator(device=device).manual_seed(program.sub_seed(seed, 1))
    n, T, B = data["imgs"].shape[1], int(traffic["seq_len"]), int(traffic["batch_size"])
    out = []
    for _ in range(steps):
        idx = torch.randint(0, n, (B,), generator=g, device=device)
        out.append(dict(imgs=data["imgs"][:T, idx].to(torch.float32) / 255.0,
                        nums=data["nums"][:T, idx]))
    return out


def follow_reference(config: Dict, data, mean_img, initial, traffic: Dict, seed: int,
                     noise, device, tf32: bool = False, step_hook=None) -> Dict:
    """The reference's first steps (see ``reference.train.follow``)."""
    model = build_model(config["model"], config["flags"], config["img_size"], device,
                        mean_img)
    weights.load(model.sequence, initial)
    reference_train.precision(tf32)
    try:
        return reference_train.follow(
            model, config["flags"],
            reference_batches(data, traffic, seed, len(noise), device),
            [TableNoise(t) for t in noise], step_hook)
    finally:
        reference_train.precision(False)


def main_shapes(cell: spec.Cell):
    """The yardstick's kernel calls of one of the cell's train steps."""
    t, c = cell.traffic, cell.config
    switches = t["switches"]
    return yardstick.main_path_shapes(
        c["flags"], int(t["batch_size"]), int(c["flags"]["k_particles"]), int(t["seq_len"]),
        c["model"] == "conv", tuple(c["img_size"]),
        fuse_glimpse=switches.get("SQAIR_FUSE_GLIMPSE") == "1",
        fuse_cells=switches.get("SQAIR_FUSE_CELLS") == "1")


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: Optional[float] = None) -> Dict:
    """One run; returns its result line's fields and the checked numbers."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    steps = int(traffic["checked_steps"])
    B, T, N = int(traffic["batch_size"]), int(traffic["seq_len"]), int(traffic["steps_per_call"])
    if N <= steps:
        raise ValueError(f"the check reads the weights at the start of step {steps + 1}: "
                         f"a call of {N} steps has none")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    phases = dict(start=time.perf_counter() - t_start)
    data, mean_img, w0, training, readings = set_up(cell, seed, device, phases, t_start)
    setup_s = time.perf_counter() - t_start

    calls, wall, last_loss, call_ms = training.window(seconds)
    window_steps = calls * N
    reading = None
    if trace:
        sliced = profiling.profile_calls(training.chain, int(traffic["profiled_calls"]), N,
                                         training.sync)
        reading = profiling.Reading(
            slice=sliced, window_steps=window_steps, window_s=wall,
            flops_per_step=yardstick.train_step_flops(
                config["flags"], config["model"] == "conv", B,
                int(config["flags"]["k_particles"]), T, tuple(config["img_size"])),
            kernel_bound_s_per_step=yardstick.step_bound_s(main_shapes(cell),
                                                           tuple(config["img_size"])),
            launches=training.launches(),
            expected_launches=yardstick.expected_launches(main_shapes(cell), N, backward=True))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    training.release()
    del training

    try:
        ref = follow_reference(config, data, mean_img, w0, traffic, seed, readings["noise"],
                               device)
        numbers = oracle.compare(readings, ref, w0,
                                 reference_train.learning_rate(config["flags"], 0))
    except (KeyError, ValueError) as e:
        # the program drew other noise than the model's keys and shapes ask
        # for: its steps cannot be paired with the reference's
        ref = dict(losses=[], error=f"{type(e).__name__}: {e}")
        numbers = dict({k: math.nan for k in cell.limits}, grad_leaf=None, change_leaf=None,
                       leaves=0)
    finite = math.isfinite(last_loss)
    correct = finite and oracle.judge(numbers, cell.limits)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(train_frames_per_s=window_steps * B * T / wall, setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=cell.chips, memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=window_steps,
               failed=0 if finite else window_steps, metrics=metrics, device=dev)
    info_slice = {}
    if trace:
        s = reading.slice
        dev.update(busy_s=s.busy_us() / 1e6, window_s=s.window_us / 1e6)
        out["breakdown"] = dict(device_ops=s.top_ops(), idle_gaps=s.idle_gaps())
        # what the profiler adds to a call (device_idle_share's docstring)
        info_slice = dict(slice_call_ms=s.window_us / 1e3 / int(traffic["profiled_calls"]),
                          window_call_ms=statistics.median(call_ms) if call_ms else None)
    out["checks"] = {k: dict(value=numbers[k] if math.isfinite(numbers[k]) else None,
                             limit=cell.limits[k]) for k in cell.limits}
    info = dict(setup_s=setup_s, setup_phases_s=phases, window_s=wall, call_ms=call_ms, calls=calls, steps=window_steps,
                last_loss=last_loss, launches=reading.launches if reading else None,
                loss_steps=numbers.get("loss_steps"), change_worst=numbers.get("change_worst"),
                grad_leaf=numbers["grad_leaf"], change_leaf=numbers["change_leaf"],
                leaves=numbers["leaves"], losses=readings["losses"],
                reference_losses=ref["losses"], reference_error=ref.get("error"), **info_slice)
    return dict(result=out, info=info)
