"""On the card: the TF32 control and a planted half-batch fault read over
the shipped limits, and the program's own steps under them, at each
cell's widths with a batch of 8 and 4 frames (``control.py`` reads the
same at the cells' own size, for the limits).  Skipped without a card;
run on the card with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda --noconftest
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from helpers import BENCH  # noqa: F401  (puts the harness on the path)
from harness import spec

CELLS = ["mlp_release-train-fused", "conv_mnist-train"]


def smaller(cell):
    t = cell.traffic
    return dataclasses.replace(cell, traffic=dict(t, batch_size=8, seq_len=4,
                                                  data=dict(t["data"], sequences=256, frames=4)))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_fault_fail_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import control

    cell = smaller(spec.cell(workload))
    sound = control.program_reading(cell, 2**31 + 21, "cuda")
    tf32, fault = control.reference_readings(cell, 2**31 + 22, "cuda")
    limits = cell.limits
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(tf32[k] > limits[k] for k in limits), tf32
    assert any(fault[k] > limits[k] for k in limits), fault
