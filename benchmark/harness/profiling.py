"""A profiled slice of the timed path, read into device and host
intervals, and the quantities every per-layer reader takes from them.

The slice is a few chain calls under ``torch.profiler`` (CPU and CUDA
activities), after the measured window has closed.  Its window runs from
the device's first activity to the last recorded event, device or host
(the closing sync): the host's launch of the first call onto an idle
device, which the window's back-to-back calls never wait for, is left
out.  Its busy time is the union of the device's activity intervals
(kernels, copies, sets).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

Interval = Tuple[str, float, float]  # (name, start us, end us)

# what marks a convolution of cuDNN's by its kernel's name
CONV_MARKS = ("cudnn", "conv", "fprop", "dgrad", "wgrad")
PROGRAM_KERNEL_MARK = "sqair::"


def is_conv(name: str) -> bool:
    low = name.lower()
    return any(mark in low for mark in CONV_MARKS)


def is_program_kernel(name: str) -> bool:
    return PROGRAM_KERNEL_MARK in name


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


@dataclasses.dataclass
class Slice:
    """What a profiled slice saw."""

    device: List[Interval]
    host: List[Interval]
    steps: int

    def bounds(self) -> Tuple[float, float]:
        """(the device's first start, the last end of any event)."""
        start = min(s for _, s, _ in self.device)
        return start, max(e for _, _, e in self.device + self.host)

    @property
    def window_us(self) -> float:
        if not self.device:
            return 0.0
        start, end = self.bounds()
        return end - start

    def busy_us(self) -> float:
        return sum(e - s for s, e in _merge([(s, e) for _, s, e in self.device]))

    def device_us(self, select: Callable[[str], bool]) -> float:
        return sum(e - s for name, s, e in self.device if select(name))

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, [name, seconds]."""
        totals: Dict[str, float] = {}
        for name, s, e in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in ranked]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches of the window with no device activity,
        [what the host was doing, seconds]: the host event that overlaps
        the gap most (the shortest of equals), or "host idle"."""
        if not self.device:
            return []
        start, end = self.bounds()
        busy = _merge([(s, e) for _, s, e in self.device])
        gaps, at = [], start
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if end > at:
            gaps.append((at, end))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:n]:
            best, key = "host idle", None
            for name, s, e in self.host:
                overlap = min(e, g1) - max(s, g0)
                if overlap > 0:
                    rank = (-overlap, e - s)
                    if key is None or rank < key:
                        best, key = name, rank
            out.append([best[:160], (g1 - g0) / 1e6])
        return out


def profile_calls(fn: Callable[[], object], calls: int, steps_per_call: int,
                  sync: Callable[[], None]) -> Slice:
    """``calls`` calls of ``fn`` under the profiler, then ``sync``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        sync()
    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    return Slice(device=device, host=host, steps=calls * steps_per_call)


@dataclasses.dataclass
class Reading:
    """Everything a per-layer reader may read: the profiled slice, the
    window's steps and seconds, and the yardstick's numbers for the cell."""

    slice: Optional[Slice]
    window_steps: int
    window_s: float
    flops_per_step: float
    kernel_bound_s_per_step: float
    launches: Optional[Dict[str, int]]
    expected_launches: Dict[str, int]
