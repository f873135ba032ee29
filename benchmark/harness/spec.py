"""What a run loads by name: ``BENCHMARK.json`` at the checkout's root
names the cells, configurations and metrics; each cell's traffic, each
configuration and each per-layer metric is a file of its own under the
benchmark's folder:

  configs/<file named by the configuration>   the model's flags and sizes
  traffic/<traffic>.json                       batch, frames, steps a call,
                                               switches, the data set
  workloads/<cell>.json                        the limits of ``correct``
  metrics/<per-layer metric>.py                its reader: read(reading)
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _load_json(ROOT / "BENCHMARK.json")


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its files."""
    spec = benchmark()
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(ROOT / configs[entry["config"]]["file"])
    traffic = _load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    limits = _load_json(BENCH / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
