"""The per-layer readers on a made-up profiled slice: busy time as the
union of device intervals, the idle gaps and what the host did in them,
and each reader's arithmetic."""
from __future__ import annotations

import pytest

from helpers import PER_LAYER
from harness import spec
from harness.profiling import Reading, Slice


def made_up_slice():
    device = [("void sqair::mlp_fwd<4>(float*)", 100.0, 300.0),
              ("void sqair::mlp_bwd(float*)", 250.0, 400.0),     # overlaps the last
              ("cudnn::wgrad2d_grouped_direct_kernel", 500.0, 700.0),
              ("sm90_xmma_gemm_f32f32_f32f32", 700.0, 800.0),   # cuBLAS: not a conv
              ("Memcpy HtoD (Pageable -> Device)", 900.0, 950.0)]
    host = [("cudaGraphLaunch", 0.0, 120.0), ("aten::copy_", 400.0, 480.0),
            ("cudaStreamSynchronize", 420.0, 1000.0)]
    return Slice(device=device, host=host, steps=2)


def test_busy_time_is_the_union_of_device_intervals():
    s = made_up_slice()
    assert s.window_us == 900.0  # from the device's first start to the sync's end
    assert s.busy_us() == 300.0 + 300.0 + 50.0
    assert s.top_ops(2) == [["void sqair::mlp_fwd<4>(float*)", 200e-6],
                            ["cudnn::wgrad2d_grouped_direct_kernel", 200e-6]]


def test_idle_gaps_are_labelled_by_the_host():
    gaps = sorted(made_up_slice().idle_gaps(), key=lambda g: (-g[1], g[0]))
    # [400, 500) the copy and the sync overlap it by 80 us each, and the
    # shorter wins; [800, 900), [950, 1000) the sync; [0, 100), the first
    # launch onto an idle device, lies before the window
    assert gaps == [["aten::copy_", 100e-6], ["cudaStreamSynchronize", 100e-6],
                    ["cudaStreamSynchronize", 50e-6]]


def test_readers():
    r = Reading(slice=made_up_slice(), window_steps=100, window_s=2.0,
                flops_per_step=67e10, kernel_bound_s_per_step=35e-6,
                launches={"fused_mlp": 2}, expected_launches={"fused_mlp": 2})
    read = {name: spec.reader(name)(r) for name in PER_LAYER}
    assert read["device_idle_share"] == pytest.approx(100 * 250 / 900)
    assert read["kernels_ms_per_step"] == pytest.approx(0.175)  # 350 us / 2 steps
    assert read["kernels_roofline"] == pytest.approx(20.0)      # 35 us of 175 us
    assert read["conv_ms_per_step"] == pytest.approx(0.1)
    assert read["torch_ops_ms_per_step"] == pytest.approx(0.075)
    assert read["train_mfu"] == pytest.approx(50.0)             # 67e10 x 50 / s of 67e12


def test_readers_find_nothing_to_read_without_a_trace_or_with_other_launches():
    r = Reading(slice=Slice(device=[], host=[], steps=2), window_steps=0, window_s=0.0,
                flops_per_step=1.0, kernel_bound_s_per_step=1.0, launches={"fused_mlp": 1},
                expected_launches={"fused_mlp": 2})
    assert all(spec.reader(name)(r) is None for name in PER_LAYER)
    sliced = Reading(slice=made_up_slice(), window_steps=1, window_s=1.0, flops_per_step=1.0,
                     kernel_bound_s_per_step=1.0, launches={"fused_mlp": 1},
                     expected_launches={"fused_mlp": 2})
    assert spec.reader("kernels_roofline")(sliced) is None
