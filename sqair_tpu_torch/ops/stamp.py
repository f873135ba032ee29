"""The device stamp of ``tracing.py`` (``csrc/trace_stamp.cu``): one thread
writes the card's nanosecond clock (``%globaltimer``) into a ring.  It is
not counted in ``fused.launches`` and its kernel is not an ``sqair::`` one,
so the launch counts and the kernels' profile of a captured chain stay
those of its train steps.
"""
from __future__ import annotations

import ctypes

import torch


def stamp(buf: torch.Tensor):
    """Launches one stamp into ``buf`` (int64 [1 + capacity]: the stamps
    written so far, then the ring) on the current stream; captured into a
    graph while one is captured."""
    from .build import library

    stream = torch.cuda.current_stream(buf.device).cuda_stream
    code = library().sqair_trace_stamp(ctypes.c_void_p(buf.data_ptr()), buf.numel() - 1,
                                       ctypes.c_void_p(stream))
    if code != 0:
        raise RuntimeError(f"sqair_trace_stamp: CUDA error {code} at launch")
