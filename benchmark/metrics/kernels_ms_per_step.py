"""kernels_ms_per_step: device time of the program's own kernels (names
in its ``sqair::`` namespace) over the profiled slice's train steps, in ms."""
from __future__ import annotations

from harness.profiling import is_program_kernel


def read(r):
    s = r.slice
    if s is None or not s.steps:
        return None
    us = s.device_us(is_program_kernel)
    if us <= 0:
        return None
    return us / 1e3 / s.steps
