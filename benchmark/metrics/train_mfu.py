"""train_mfu: the model FLOPs of the train steps that the measured window
completed (the yardstick's ``train_step_flops``) over the window's wall
time, as a share of the card's f32 peak, in %."""
from __future__ import annotations

from harness.yardstick import PEAK_F32


def read(r):
    if not r.window_steps or r.window_s <= 0:
        return None
    return 100.0 * r.flops_per_step * r.window_steps / r.window_s / PEAK_F32
