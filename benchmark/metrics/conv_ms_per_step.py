"""conv_ms_per_step: device time of cuDNN's convolutions (kernel names
with cudnn, conv, fprop, dgrad or wgrad) over the profiled slice's train
steps, in ms."""
from __future__ import annotations

from harness.profiling import is_conv, is_program_kernel


def read(r):
    s = r.slice
    if s is None or not s.steps:
        return None
    us = s.device_us(lambda n: is_conv(n) and not is_program_kernel(n))
    if us <= 0:
        return None
    return us / 1e3 / s.steps
