"""torch_ops_ms_per_step: device time of every operation that is neither
one of the program's kernels nor a cuDNN convolution (PyTorch's own
kernels, cuBLAS's, copies and sets) over the profiled slice's train steps,
in ms."""
from __future__ import annotations

from harness.profiling import is_conv, is_program_kernel


def read(r):
    s = r.slice
    if s is None or not s.steps or not s.device:
        return None
    return s.device_us(lambda n: not is_program_kernel(n) and not is_conv(n)) / 1e3 / s.steps
