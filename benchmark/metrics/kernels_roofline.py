"""kernels_roofline: the least time the program's kernel calls of a train
step could take on the card (each call's larger of bytes over the HBM peak
and FLOPs over the f32 peak, forward and backward, calls from the
yardstick's ``main_path_shapes``) over their measured device time, in %.

Nothing is read where the capture's launch counts differ from the
yardstick's, since the bound would then count other calls than ran."""
from __future__ import annotations

from harness.profiling import is_program_kernel


def read(r):
    s = r.slice
    if s is None or not s.steps or r.launches != r.expected_launches:
        return None
    us = s.device_us(is_program_kernel)
    if us <= 0:
        return None
    return 100.0 * r.kernel_bound_s_per_step / (us / 1e6 / s.steps)
