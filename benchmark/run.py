#!/usr/bin/env python3
"""Runs one cell of the benchmark of the PyTorch / CUDA port of SQAIR
(``sqair_tpu_torch``) on the CUDA card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is named in ``BENCHMARK.json``; its
configuration, traffic and limits are files under this folder
(``harness/spec.py``).  Set-up makes the data and the weights on the card
from the seed, builds the program's graphed train step and makes its first
call; the window then trains for ``--seconds``; with ``--trace 1`` a few
more calls run under ``torch.profiler`` and the per-layer metrics are read
from them.  The program's first train steps are then compared with the
plain reference (``reference/``).  The last line of standard output is the
result as one JSON object; the last lines of standard error are the
numbers compared, each beside its limit.  Without a CUDA card, or with
fewer than the cell asks for, it prints no result and exits with 2; if JAX
or the JAX package was loaded, with 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from harness import imports, runner, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = imports.forbidden()
    if loaded:
        print(f"the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(dict(info=out["info"])), file=sys.stderr)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
