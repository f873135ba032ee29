"""Shared pieces of the benchmark's tests: paths and a tiny cell on the CPU."""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

PER_LAYER = ("device_idle_share", "kernels_ms_per_step", "kernels_roofline",
             "torch_ops_ms_per_step", "conv_ms_per_step", "train_mfu")


def tiny_config(name: str):
    """The configuration ``name`` at a width and size a CPU test holds."""
    with open(BENCH / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    F = dict(cfg["flags"], n_units=1, n_what=6, glimpse_size=10, k_particles=2)
    if cfg["model"] == "conv":
        F["conv_channels"] = "4,8"
    return dict(cfg, flags=F, img_size=[26, 26])


def tiny_cell(workload: str) -> spec.Cell:
    """The cell ``workload`` of BENCHMARK.json, its limits as shipped, at a
    tiny size: B 2, k 2, T 3, 4 steps a call, 16 sequences of 26x26."""
    full = spec.cell(workload)
    entry = next(w for w in spec.benchmark()["workloads"] if w["name"] == workload)
    t = full.traffic
    traffic = dict(t, batch_size=2, seq_len=3, steps_per_call=4, profiled_calls=1,
                   data=dict(t["data"], sequences=16, frames=3, canvas=[26, 26],
                             templates=8, template_size=12))
    return spec.Cell(name=workload, chips=1, config=tiny_config(entry["config"]),
                     traffic=traffic, limits=full.limits, end_to_end=full.end_to_end,
                     per_layer=full.per_layer)
