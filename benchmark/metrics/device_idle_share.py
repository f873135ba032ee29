"""device_idle_share: the share of the profiled slice's window in which no
operation ran on the device, in %.

The reading includes the profiler's own cost at each graph launch: under
it a call of the chain takes longer than in the measured window (the run's
``info`` gives both, ``slice_call_ms`` beside ``window_call_ms``), and the
slice's longest idle gaps are ``cudaGraphLaunch``.  On an H100 a profiled
call took up to 31 ms longer than the window's median of 355-377 ms in the
MLP cell and 76-88 ms longer than 1149 ms in the conv cell, as much as the
share read."""
from __future__ import annotations


def read(r):
    s = r.slice
    if s is None or not s.device or s.window_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us() / s.window_us)
