"""ctypes binding to the native (C++) sequence-data generator (a copy of
sqair_tpu/data/native.py, numpy only).

A multithreaded C++ generator (native/datagen/datagen.cpp) creates a
moving-object dataset in bulk on the host; the library is built with
``make`` on first use.  Before it is picked, a small generation runs in a
process of its own: the Makefile builds for the building host's
instruction set (``-march=native``), and a library built elsewhere may die
here of an illegal instruction.  Where it cannot be built, loaded or run,
the numpy generator (``moving_mnist.create_seq_dataset``) runs instead:
either way this is host-side data generation, and the device never sees
it.

Use :func:`generate_sequences` (native where it can, else numpy) and
:func:`native_available` to ask which path runs.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Dict, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native", "datagen")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsqairdata.so")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


# a small generation with the library, in a process of its own
_PROBE = """
import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location("native_probe", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native._probed = True
native.generate_sequences_native(np.full((2, 12, 12), 255.0, np.float32), 8, 3,
                                 canvas_size=(48, 48), n_objects=(1, 2), n_threads=2)
"""
_probed = False


def _runs() -> bool:
    """Whether the library runs on this host (a process that dies of it
    takes this one's place)."""
    try:
        return subprocess.run([sys.executable, "-c", _PROBE, os.path.abspath(__file__)],
                              capture_output=True, timeout=120).returncode == 0
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH):
        try:  # build on demand
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    if not _probed and not _runs():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.sqair_generate_sequences.restype = ctypes.c_int
        lib.sqair_generate_sequences.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # templates
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_templates, th, tw
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # N, T, H, W
            ctypes.c_int, ctypes.c_int,  # min_obj, max_obj
            ctypes.c_uint64,  # seed
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # noise, speed, acc
            ctypes.c_int,  # n_threads
            ctypes.POINTER(ctypes.c_uint8),   # out_imgs
            ctypes.POINTER(ctypes.c_float),   # out_coords
            ctypes.POINTER(ctypes.c_uint8),   # out_nums
        ]
        lib.sqair_datagen_version.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def generate_sequences_native(
    templates: np.ndarray, n_samples: int, n_timesteps: int,
    canvas_size=(50, 50), n_objects=(0, 2), seed: int = 0,
    noise_std: float = 0.01, max_speed: float = 10.0, max_acc: float = 3.0,
    n_threads: int = 0,
) -> Dict[str, np.ndarray]:
    """Generates a moving-object dataset with the native library.

    :param templates: [n_templates, th, tw] float32 in [0, 255]
    :return: dict(imgs [T,N,H,W] uint8, nums [1,N,max+1] uint8 cumulative
        one-hot, coords [T,N,max,4] float32 (y,x,h,w))
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native datagen library unavailable")

    templates = np.ascontiguousarray(templates, np.float32)
    n_templates, th, tw = templates.shape
    H, W = canvas_size
    min_obj, max_obj = sorted(n_objects)
    m = max(max_obj, 1)

    imgs = np.empty((n_timesteps, n_samples, H, W), np.uint8)
    coords = np.empty((n_timesteps, n_samples, m, 4), np.float32)
    nums = np.empty((n_samples,), np.uint8)

    rc = lib.sqair_generate_sequences(
        templates.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_templates, th, tw, n_samples, n_timesteps, H, W,
        min_obj, max_obj, ctypes.c_uint64(seed),
        noise_std, max_speed, max_acc, n_threads,
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nums.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"sqair_generate_sequences failed with code {rc}")

    # cumulative one-hot counts [1, N, max+1] (reference data.py:172-177)
    expanded = np.zeros((1, n_samples, max_obj + 1), np.uint8)
    for i, n in enumerate(nums):
        expanded[0, i, :n] = 1
    return dict(imgs=imgs, nums=expanded, coords=coords)


def generate_sequences(templates: np.ndarray, n_samples: int, n_timesteps: int,
                       **kw) -> Dict[str, np.ndarray]:
    """The native generator, or the numpy one where the library cannot be
    loaded (the same contract)."""
    if native_available():
        return generate_sequences_native(templates, n_samples, n_timesteps, **kw)
    from .moving_mnist import create_seq_dataset

    kw.pop("n_threads", None)
    noise = {k: kw.pop(k) for k in ("noise_std", "max_speed", "max_acc")
             if k in kw}
    del noise  # the numpy path has the reference's dynamics constants built in
    data = create_seq_dataset(
        n_samples=n_samples, n_timesteps=n_timesteps, templates=templates, **kw
    )
    return dict(imgs=data["imgs"], nums=data["nums"], coords=data["coords"])
