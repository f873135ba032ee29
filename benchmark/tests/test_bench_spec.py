"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
cells, configurations, traffic and metrics by name from files alone."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap

from helpers import BENCH, PER_LAYER, ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_names_and_units_use_only_the_allowed_characters():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.fullmatch(name), name
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for text in [c["source"] for c in b["configs"]] + [w["why"] for w in b["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["benchmark"]


def test_every_file_the_benchmark_names_exists_under_its_folder():
    b = load()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    assert sorted(m["name"] for m in b["per_layer"]) == sorted(PER_LAYER)
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_the_harness_finds_files_added_beside_the_others(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added
    as new files and entries, in a copy, with no other file edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = load()
    b["configs"].append(dict(b["configs"][0], name="mlp_narrow",
                             file="benchmark/configs/mlp_narrow.json"))
    b["workloads"].append(dict(name="mlp_narrow-train-short", config="mlp_narrow",
                               traffic="train_short", chips=1, why="a test cell"))
    b["per_layer"].append(dict(name="steps_in_slice", unit="steps", better="higher",
                               source="device_trace", layer="device",
                               moves="train_frames_per_s",
                               workloads=["mlp_narrow-train-short"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cfg = json.loads((BENCH / "configs" / "mlp_release.json").read_text())
    cfg["flags"]["n_units"] = 4
    (tmp_path / "benchmark" / "configs" / "mlp_narrow.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "train.json").read_text())
    traffic["seq_len"] = 5
    (tmp_path / "benchmark" / "traffic" / "train_short.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "workloads" / "mlp_narrow-train-short.json").write_text(
        json.dumps({"limits": {"loss": 1.0}}))
    (tmp_path / "benchmark" / "metrics" / "steps_in_slice.py").write_text(
        "def read(r):\n    return float(r.slice.steps) if r.slice else None\n")
    probe = textwrap.dedent("""
        import sys, types
        sys.path.insert(0, sys.argv[1])
        from harness import spec
        c = spec.cell("mlp_narrow-train-short")
        print(c.config["flags"]["n_units"], c.traffic["seq_len"], c.limits["loss"],
              sorted(m["name"] for m in c.per_layer))
        print(spec.reader("steps_in_slice")(types.SimpleNamespace(slice=types.SimpleNamespace(steps=7))))
        """)
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path / "benchmark")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, second = out.stdout.split("\n")[:2]
    assert first == "4 5 1.0 ['steps_in_slice']"
    assert second == "7.0"
