"""Builds the CUDA kernels of ``sqair_tpu_torch/csrc`` and loads them.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles the
sources to objects, and one more links them into one shared library with a
plain C interface, which ``ctypes`` loads; nothing includes PyTorch's
headers, so the build takes seconds.  The library's name carries a hash of
the sources and the flags, so a second run finds it and skips the build.
It is written in a temporary directory and renamed into place, so processes
that build at the same time never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from .. import tracing

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")  # each source to an object (-c)
LINK_FLAGS = ("-shared",)
REQUIRED_CAPABILITY = (9, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes per exported function: every pointer (device or host) and the
# stream as c_void_p, so that ctypes never cuts a pointer to 32 bits
PROTOTYPES = {
    # x, y, n, n_layers, dims*, acts*, w**, b**, saved**, geom*, stream
    "sqair_fused_mlp": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # x, y, n, K, D, act, w, b, geom*, stream
    "sqair_fused_mlp_long_k": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # x, h, w, u, b, hn, n, dx, units, geom*, stream
    "sqair_fused_vanilla_rnn": (_P,) * 6 + (_I, _I, _I, _P, _P),
    # x, h, wg, ug, bg, wc, uc, bc, hn, zr, c, n, dx, units, geom*, stream
    "sqair_fused_gru": (_P,) * 11 + (_I, _I, _I, _P, _P),
    # x, g, dx, n, n_layers, dims*, acts*, w**, a**, dz**, dw**, db**, geom*, stream
    "sqair_fused_mlp_bwd": (_P, _P, _P, _I, _I) + (_P,) * 9,
    # x, g, dx, n, K, D, act, w, a, dz, dw, db, geom*, stream
    "sqair_fused_mlp_bwd_long_k": (_P, _P, _P, _I, _I, _I, _I) + (_P,) * 7,
    # x, h, w, u, hn, g, dx, dh, dw, du, db, n, dx, units, geom*, stream
    "sqair_fused_vanilla_rnn_bwd": (_P,) * 11 + (_I, _I, _I, _P, _P),
    # x, h, wg, ug, wc, uc, zr, c, g, dc_in, da, rh, dx, dh, dwg, dug, dbg,
    # dwc, duc, dbc, n, dx, units, geom*, stream
    "sqair_fused_gru_bwd": (_P,) * 20 + (_I, _I, _I, _P, _P),
    # ptrs* (see csrc/fused_glimpse.cu), dims*, geom*, stream
    "sqair_fused_glimpse": (_P, _P, _P, _P),
    "sqair_fused_glimpse_bwd": (_P, _P, _P, _P),
    # ptrs* (see csrc/fused_prop.cu), dims*, geom*, stream
    "sqair_fused_prop": (_P, _P, _P, _P),
    "sqair_fused_prop_bwd": (_P, _P, _P, _P),
    # ptrs* (see csrc/fused_disc.cu), dims*, geom*, stream
    "sqair_fused_disc": (_P, _P, _P, _P),
    "sqair_fused_disc_bwd": (_P, _P, _P, _P),
    # dims*
    "sqair_fused_prop_scratch_floats": (_P,),
    "sqair_fused_disc_scratch_floats": (_P,),
    # ring*, capacity, stream (csrc/trace_stamp.cu)
    "sqair_trace_stamp": (_P, _I, _P),
}

_lock = threading.Lock()
_library = None


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME, else at /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "kernels of sqair_tpu_torch/csrc")


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsqair_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the kernels unless the library for these sources exists.
    Recorded as the ``sqair.build`` span (``tracing``), with ``cached`` and
    ``path``."""
    path = library_path()
    cached = path.exists()
    with tracing.setup_span("sqair.build", cached=cached, path=str(path)):
        if not cached:
            _compile(path)
    return path


def _compile(path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            objs.append(os.path.join(tmp, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *LINK_FLAGS, "-o", lib, *objs]
        failed = []
        for cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                              f"{out}\n{err}")
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                              f"{proc.stdout}\n{proc.stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(lib, path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use on a Hopper card."""
    global _library
    with _lock:
        if _library is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            cap = torch.cuda.get_device_capability()
            if cap != REQUIRED_CAPABILITY:
                raise RuntimeError(
                    f"the kernels are built for sm_90a (Hopper); this device "
                    f"has compute capability {cap}")
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in PROTOTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
        return _library
