#!/usr/bin/env python3
"""Splits one hand-written kernel's device time into its products, its crops
and the rest, with clock64, on one CUDA card.

    python3 tools/kernel_phase_cycles.py KERNEL [--root DIR] [--calls N]

KERNEL is ``glimpse_fwd`` or ``glimpse_bwd`` (the glimpse encoder's forward,
or its backward's phase A, at the train step's masked shape: 160 rows),
``prop_fwd`` (the propagation unroll's forward at 160 rows, S = 3),
``disc_fwd`` or ``disc_bwd`` (the discovery unroll's slots forward, or its
backward's phase A, at DISC_FLAGS: 160 rows, S = 3) or ``gru_bwd`` (the GRU
backward's phase A at the temporal cell's shape: 160 rows, d_x 360, 256
units).  The tool copies the checkout's ``csrc`` (``--root``, default this
one) into a temporary directory and, in the copy only, puts a mark before
and after every call of a product (``cluster_dense``..., or a first
design's ``dense``, ``acc_smem``...) and of a crop step (``crop_*``) in the
kernel's functions (those of ``FUNCTIONS`` that the source defines): thread
0 of each block reads clock64 at each mark and adds the cycles since the
last mark to the category of the code they cover.  It builds the copy with
nvcc (one process a source), runs the checkout's wrapper ``--calls`` times
on the inputs of ``chip_smoke.py`` and prints one JSON line: the mean
cycles of a block by category, their shares, the blocks a call, the SM
clock that nvidia-smi reads and the card's name and power limit.  The marks serialise
nothing, so they cost a few cycles each; a block's threads run ahead of
thread 0 between barriers, so a share is that of thread 0's time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

# the calls that are marked, by the category of the time they take: a
# product (cluster_dense...: its plan, its first staging and its epilogues,
# as the rounds and barriers inside are marked on their own; and the first
# designs' per-thread products, dense, acc_smem..., which this tree no
# longer has, for a checkout of them given by --root), a crop step, a
# product's rounds (cluster_dense.cuh's product_pass) and its cluster
# barriers
CATEGORIES = ("other", "product", "crop", "rounds", "barrier")
CALLS = {**{c: 1 for c in ("dense", "dense2", "dense_t", "dense_t2", "acc_smem", "acc_smem_t",
                           "acc_global", "cluster_dense", "cluster_dense_t", "store_dz",
                           "store_rows", "encode_rows")},
         **{c: 2 for c in ("crop_setup", "crop_glimpse", "crop_bwd", "sparse_crop_setup",
                           "sparse_crop_glimpse", "sparse_crop_bwd")},
         "product_pass": 3, "cluster_wait": 4, "cluster_sync_all": 4}
# the functions whose calls are marked, with the category of the time
# between their marks: the kernels of both designs (the first designs' for
# an older checkout) and the helpers that hold their products and crops
_PRODUCT = ("cluster_dense.cuh", (("cluster_product", 1),))
FUNCTIONS = {
    "glimpse_fwd": (_PRODUCT,
                    ("fused_glimpse.cu", (("glimpse_fwd_kernel", 0),)),
                    ("glimpse_common.cuh", (("glimpse_encode_fwd", 0),))),
    "glimpse_bwd": (_PRODUCT,
                    ("fused_glimpse.cu", (("glimpse_bwd_rows_kernel", 0),
                                          ("glimpse_bwd_kernel", 0))),
                    ("glimpse_common.cuh", (("encode_rows_bwd", 0),))),
    "prop_fwd": (_PRODUCT,
                 ("fused_prop.cu", (("prop_fwd_kernel", 0), ("prop_glimpse", 0),
                                    ("prop_glimpse_fwd", 0))),
                 ("glimpse_common.cuh", (("glimpse_encode_fwd", 0),))),
    "disc_fwd": (_PRODUCT,
                 ("fused_disc.cu", (("disc_fwd_kernel", 0),)),
                 ("glimpse_common.cuh", (("glimpse_encode_fwd", 0),))),
    "disc_bwd": (_PRODUCT,
                 ("fused_disc.cu", (("disc_bwd_rows_kernel", 0), ("disc_bwd_kernel", 0))),
                 ("glimpse_common.cuh", (("encode_rows_bwd", 0),))),
    "gru_bwd": (_PRODUCT,
                ("fused_bwd.cu", (("gru_bwd_rows_kernel", 0), ("gru_bwd_kernel", 0)))),
}
MARK_DEFS = r"""
#ifndef SQP_MARKS
#define SQP_MARKS
#include <cuda_runtime.h>
static __device__ unsigned long long sqp_cycles[8];
static __device__ long long sqp_last[4096];
#define SQP_START() do { if (threadIdx.x == 0) sqp_last[blockIdx.x] = clock64(); } while (0)
#define SQP_MARK(c) do { if (threadIdx.x == 0) { const long long t_ = clock64(); \
    atomicAdd(&sqp_cycles[c], (unsigned long long)(t_ - sqp_last[blockIdx.x])); \
    sqp_last[blockIdx.x] = t_; } } while (0)
#endif
"""
READ_ENTRY = r"""
extern "C" int sqair_phase_cycles(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaError_t e = cudaMemcpyFromSymbol(out, sqp_cycles, sizeof(unsigned long long) * 8);
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(sqp_cycles, z, sizeof(z));
  return (int)e;
}
"""


def _body(text, name):
    """(start, end) of the body of the function `name` (after its `{`,
    before its `}`), or None."""
    m = re.search(r"\b" + name + r"\s*\([^;{]*\)\s*\{", text)
    if m is None:
        return None
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
    return m.end(), i - 1


def _instrument(text, names, kernel_names):
    """The source with marks around the calls of ``CALLS`` in the functions
    `names` ((name, category of the time between marks) pairs); the kernels
    among them start the clock and end with a mark."""
    calls = "|".join(sorted(CALLS, key=len, reverse=True))
    pat = re.compile(r"(?<![\w.])(" + calls + r")\s*(<[^;()]*?>)?\s*\(")
    for name, home in names:
        span = _body(text, name)
        if span is None:
            continue
        s, e = span
        body = text[s:e]
        out, pos = [], 0
        for m in pat.finditer(body):
            if m.start() < pos:
                continue
            # the call's statement ends at the `;` after its closing parenthesis
            depth, i = 1, m.end()
            while depth:
                depth += {"(": 1, ")": -1}.get(body[i], 0)
                i += 1
            j = body.index(";", i) + 1
            out.append(body[pos:m.start()])
            # in braces: the call may be the body of an if without them
            out.append(f"{{ SQP_MARK({home}); {body[m.start():j]} SQP_MARK({CALLS[m.group(1)]}); }}")
            pos = j
        out.append(body[pos:])
        body = "".join(out)
        if name in kernel_names:
            body = " SQP_START(); " + body + f" SQP_MARK({home}); "
        text = text[:s] + body + text[e:]
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", choices=sorted(FUNCTIONS))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_phase_cycles: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sqair_tpu_torch.ops import build, fused, stn
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

    stn.full_fp32_matmul()
    csrc = root / "sqair_tpu_torch" / "csrc"
    tmp = Path(tempfile.mkdtemp(prefix="phase_cycles_"))
    try:
        for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
            shutil.copy(f, tmp / f.name)
        main_src = FUNCTIONS[args.kernel][1][0]
        marked = []
        for fname, names in FUNCTIONS[args.kernel]:
            text = (tmp / fname).read_text()
            kernels = [n for n, _ in names
                       if re.search(r"__global__[^;{]*\b" + n + r"\b", text)]
            new = _instrument(text, names, kernels)
            if new != text:  # the marks' definitions, once a translation unit
                new = new.replace("namespace sqair {", MARK_DEFS + "\nnamespace sqair {", 1)
            marked += [n for n, _ in names if _body(text, n) is not None]
            (tmp / fname).write_text(new + (READ_ENTRY if fname == main_src else ""))
        nvcc = build.find_nvcc()
        objs = []
        procs = []
        for src in sorted(f.name for f in tmp.glob("*.cu")):
            objs.append(str(tmp / (src + ".o")))
            procs.append(subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o", objs[-1],
                                           str(tmp / src)], stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        for p in procs:
            out, err = p.communicate()
            if p.returncode:
                print(out, err, file=sys.stderr)
                return 1
        lib_path = tmp / "libphase.so"
        subprocess.run([nvcc, *build.LINK_FLAGS, "-o", str(lib_path), *objs], check=True)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in build.PROTOTYPES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        lib.sqair_phase_cycles.argtypes = (ctypes.c_void_p,)
        build.library = lambda: lib

        flags = json.loads(cs.RELEASE_FLAGS.read_text())
        B, k, T = int(flags["batch_size"]), int(flags["k_particles"]), 10
        device = torch.device("cuda")
        gen = torch.Generator(device=device).manual_seed(cs.SEED)
        with torch.inference_mode():
            if args.kernel == "gru_bwd":
                shape = next(s for kn, s, _ in cs.main_path_shapes(flags, B, k, T, train=True)
                             if kn == "fused_gru" and s["n"] == B * k)
                bargs = cs.make_bwd_inputs(torch, fused, "fused_gru",
                                           cs.make_inputs(torch, "fused_gru", shape, gen, device),
                                           gen)
                fn = lambda: fused.fused_gru_bwd(*bargs)  # noqa: E731
            elif args.kernel == "disc_fwd":
                from time_fused_kernels import disc_fwd_call

                shape, dfargs = disc_fwd_call(torch, cs, fc, flags, B * k, T, gen, device)
                fn = lambda: fc._disc_fwd_cuda(*dfargs)  # noqa: E731
            elif args.kernel == "prop_fwd":
                shape = cs.prop_shape(flags, B * k)
                pdims = cs.prop_dims(shape)
                pargs, pw = cs.prop_inputs(torch, fc, shape, gen, device)
                fn = lambda: fc._fwd_cuda(*pargs, pw, pdims)  # noqa: E731
            elif args.kernel == "disc_bwd":
                from time_fused_kernels import disc_bwd_call

                shape, dbargs = disc_bwd_call(torch, cs, fc, flags, B * k, T, gen, device)
                fn = lambda: fc._disc_bwd_cuda(*dbargs)  # noqa: E731
            elif args.kernel == "glimpse_fwd":
                shape = cs.glimpse_shapes(flags, B * k, T)[0][0]
                gargs = cs.glimpse_inputs(torch, shape, gen, device)
                fn = lambda: fg._fwd_cuda(*gargs, cs.glimpse_dims(shape), save=True)  # noqa
            else:
                shape = cs.glimpse_shapes(flags, B * k, T)[0][0]
                dims = cs.glimpse_dims(shape)
                gargs = cs.glimpse_inputs(torch, shape, gen, device)
                want = fg.glimpse_plain_fwd(*gargs, dims)
                saved = tuple(want[2:5]) + (want[1],) + tuple(want[5:])
                dl, dsc = (torch.randn((shape["n"], shape["n_what"]), generator=gen,
                                       device=device) for _ in range(2))
                fn = lambda: fg.fused_glimpse_bwd(*gargs[:6], saved, dl, dsc, dims)  # noqa
            fn()
            buf = (ctypes.c_ulonglong * 8)()
            lib.sqair_phase_cycles(buf)
            fused.reset_launches()
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            if lib.sqair_phase_cycles(buf):
                raise RuntimeError("reading the cycle counters failed")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
        blocks = _blocks(args.kernel, shape, fused, fc, fg)
        per_block = {c: buf[i] / args.calls / blocks for i, c in enumerate(CATEGORIES)}
        total = sum(per_block.values())
        print(json.dumps(dict(kernel=args.kernel, root=str(root), marked=marked,
                              shape=shape, blocks=blocks, calls=args.calls,
                              cycles_per_block=per_block, total_cycles_per_block=total,
                              share={c: v / total for c, v in per_block.items()},
                              card_name_power_limit_sm_clock=card)), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def _blocks(kernel, shape, fused, fc, fg):
    """Blocks of one launch of the marked kernel, as the checkout's host
    picks them (the first designs: 2 rows a block for prop_fwd, disc_fwd
    and disc_bwd, 8 for the glimpse kernels and gru_bwd)."""
    n = shape["n"]
    home, name = {"prop_fwd": (fc, "prop_fwd_geometry"), "disc_bwd": (fc, "disc_bwd_geometry"),
                  "disc_fwd": (fc, "disc_fwd_geometry"),
                  "gru_bwd": (fused, "gru_bwd_geometry"),
                  "glimpse_fwd": (fg, "glimpse_fwd_geometry"),
                  "glimpse_bwd": (fg, "glimpse_bwd_geometry")}[kernel]
    geom = getattr(home, name, None)
    if geom is None:
        return -(-n // (2 if kernel in ("prop_fwd", "disc_fwd", "disc_bwd") else 8))
    if kernel == "gru_bwd":
        return geom(n, shape["dx"], shape["units"])["blocks"]
    if kernel == "disc_fwd":
        return geom([n, shape["S"], *shape["img"], *shape["glimpse"], shape["n_what"],
                     shape["U"], shape["SP"], shape["C"]])["blocks"]
    return geom([n])["blocks"]


if __name__ == "__main__":
    sys.exit(main())
