#!/usr/bin/env python3
"""What the program's tracing (``sqair_tpu_torch/tracing.py``) reads in one
cell of the benchmark, and what it costs, on the CUDA card.

    python3 tools/trace_cell_torch.py --workload mlp_release-train-fused \\
        --seed 2147490023 --seconds 51 --rounds 3 --out results/trace_cell.jsonl

Set-up is the benchmark's (``benchmark/harness/runner.set_up``: the data and
weights from the seed, the graphed chain and its first call); its line gives
the capture's kernel launches and its MLP calls that took the long-K
kernels (``ChainedTrainStep.launches``, ``long_k_calls``).  Then
``--rounds`` pairs of measured windows (``Training.window``, the
benchmark's closed loop) run with tracing off and on, in alternating
order, each for ``--seconds`` (many short rounds resolve the cost of
tracing where the cell's speed drifts between windows: the summary gives
the median and quartiles of the rounds' paired costs).  Every window
reports its frames/s and its calls' gap share from the replay stamps (in
the graph either way), and a window with tracing on also the medians of
``sqair.chain.rates_fill`` and ``sqair.chain.graph_launch``, the part of
each fill after the last
replay ended (its end less the replay's last stamp on the aligned clock),
and the longest gaps between replays with their labels.  Last, two
profiled slices of ``--profiled_calls`` calls, tracing off and on: the
gaps between replays by the stamps against the profiler's (the end of one
replay's last stamp kernel to the start of the next one's first), each
stamp less its kernel's start on the profiler's clock (less the smallest
such: all 0 where the two clocks agree), and the device events named
after the program's spans that the profiler records beside the kernels.
One JSON line per part on stdout and in ``--out``; the last line sums up.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO / "benchmark"), str(REPO)]

STAMP_KERNEL = "sqair_trace::stamp_kernel"


def _median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def window(training, tracing, seconds: float, on: bool, frames_per_step: int):
    """One measured window; returns its record."""
    if on:
        tracing.enable()
    c0 = tracing.mark()
    calls, wall, loss, call_ms = training.window(seconds)
    c1 = tracing.mark()
    out = tracing.summary(calls=(c0, c1))
    tracing.disable()
    steps, replays = training.chain.steps, out["replays"]
    rec = dict(part="window", tracing=on, calls=calls, wall_s=wall, loss=loss,
               frames_per_s=calls * steps * frames_per_step / wall,
               call_ms_median=_median(call_ms),
               **{k: replays[k] for k in ("gap_share_pct", "gap_ms_median", "replay_ms_median",
                                          "replay_ms_min", "replay_ms_max")})
    if on:
        spans = out["spans"]
        rec.update(rates_fill_ms=spans["sqair.chain.rates_fill"]["median_ms"],
                   rates_fill_p90_ms=spans["sqair.chain.rates_fill"]["p90_ms"],
                   graph_launch_ms=spans["sqair.chain.graph_launch"]["median_ms"],
                   graph_launch_p90_ms=spans["sqair.chain.graph_launch"]["p90_ms"],
                   clock=out["clock"], gaps=out["gaps"], **_decompose(tracing, c0, c1))
    return rec


def _decompose(tracing, c0: int, c1: int):
    """Medians over the window's calls after its first, on the aligned
    clock: the fill's part after the last replay ended, the launch, and
    from the launch's start to the replay's first stamp."""
    spans, stamps, host = tracing.records((c0, c1))
    replays = {c: (f, l) for c, f, l in stamps}
    by_call = {}
    for s in spans:
        by_call.setdefault(s.call, {})[s.name] = s
    post, launch, start = [], [], []
    for c in range(c0 + 1, c1):
        if c - 1 not in replays or c not in replays or c not in by_call:
            continue
        fill, gl = by_call[c]["sqair.chain.rates_fill"], by_call[c]["sqair.chain.graph_launch"]
        post.append((fill.end - host(replays[c - 1][1])) / 1e6)
        launch.append((gl.end - gl.start) / 1e6)
        start.append((host(replays[c][0]) - gl.start) / 1e6)
    return dict(post_wait_fill_ms=_median(post), launch_ms=_median(launch),
                launch_to_first_node_ms=_median(start))


def stamps_against_profiler(training, tracing, profiling, calls: int, on: bool):
    """A profiled slice: the stamps' gaps between its replays against the
    profiler's, and the device time of events named after the program's
    spans."""
    if on:
        tracing.enable()
    c0 = tracing.mark()
    sliced = profiling.profile_calls(training.chain, calls, training.chain.steps,
                                     training.sync)
    c1 = tracing.mark()
    tracing.disable()
    replays = tracing.records((c0, c1))[1]
    by_stamps = [(b[1] - a[2]) / 1e3 for a, b in zip(replays, replays[1:])]
    stamps = sorted((s, e) for n, s, e in sliced.device if n.startswith(STAMP_KERNEL))
    by_profiler, offsets = [], []
    if len(stamps) == 2 * len(replays):  # else the profiler lost a record
        # each replay: its first and last stamp kernel, in order
        pairs = list(zip(stamps[0::2], stamps[1::2]))
        by_profiler = [b[0][0] - a[1][1] for a, b in zip(pairs, pairs[1:])]
        # each stamp on the card's clock less its kernel's start on the
        # profiler's, less the smallest such: equal where the clocks agree
        d = [ns / 1e3 - k[0] for (_, first, last), (k1, k2) in zip(replays, pairs)
             for ns, k in ((first, k1), (last, k2))]
        offsets = [x - min(d) for x in d]
    names = {}
    for n, s, e in sliced.device:
        names[n] = names.get(n, 0.0) + (e - s)
    odd = {n: us for n, us in names.items() if n.startswith("sqair.")}
    return dict(part="slice", tracing=on, calls=calls, stamp_kernels=len(stamps),
                gaps_us_stamps=by_stamps, gaps_us_profiler=by_profiler,
                worst_us=max((abs(a - b) for a, b in zip(by_stamps, by_profiler)),
                             default=None),
                stamp_offsets_us=offsets,
                device_idle_share=100.0 * (1.0 - sliced.busy_us() / sliced.window_us),
                program_span_device_us=odd, idle_gaps=sliced.idle_gaps())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--profiled_calls", type=int, default=4)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from harness import profiling, runner, spec
    from sqair_tpu_torch import tracing

    t_start = time.perf_counter()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=args.workload, seed=args.seed))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    cell = spec.cell(args.workload)
    device = torch.device("cuda")
    phases = dict(start=time.perf_counter() - t_start)
    training = runner.set_up(cell, args.seed, device, phases, t_start)[3]
    setup = tracing.summary()
    prepare = next(s for s in setup["setup"] if s["name"] == "sqair.chain.prepare")
    emit(dict(part="setup", setup_s=time.perf_counter() - t_start, phases=phases,
              capture_s=prepare["s"], spans=setup["setup"], launches=training.chain.launches,
              long_k_calls=training.chain.long_k_calls,
              card=torch.cuda.get_device_name(device)))
    frames_per_step = int(cell.traffic["batch_size"]) * int(cell.traffic["seq_len"])
    windows = []
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            windows.append(window(training, tracing, args.seconds, on, frames_per_step))
            emit(windows[-1])
    slices = [stamps_against_profiler(training, tracing, profiling, args.profiled_calls, on)
              for on in (False, True)]
    for s in slices:
        emit(s)
    off = [w["frames_per_s"] for w in windows if not w["tracing"]]
    on = [w["frames_per_s"] for w in windows if w["tracing"]]
    traced = [w for w in windows if w["tracing"]]
    # each round's two windows as a pair: the cost with tracing on
    paired = sorted(100.0 * (1.0 - b / a) for a, b in zip(off, on))
    quartiles = statistics.quantiles(paired, n=4) if len(paired) > 1 else paired * 3
    emit(dict(part="summary", capture_s=prepare["s"],
              frames_per_s_off=_median(off), frames_per_s_on=_median(on),
              cost_pct=100.0 * (1.0 - _median(on) / _median(off)),
              cost_pct_paired_median=_median(paired),
              cost_pct_paired_quartiles=[quartiles[0], quartiles[2]],
              gap_ms_off=_median([w["gap_ms_median"] for w in windows if not w["tracing"]]),
              gap_ms_on=_median([w["gap_ms_median"] for w in traced]),
              replay_gap_share=_median([w["gap_share_pct"] for w in windows]),
              rates_fill_ms_per_call=_median([w["rates_fill_ms"] for w in traced]),
              graph_launch_ms_per_call=_median([w["graph_launch_ms"] for w in traced]),
              call_ms_median=_median([w["call_ms_median"] for w in windows]),
              stamps_vs_profiler_worst_us=[s["worst_us"] for s in slices],
              clock_uncertainty_ms=max(w["clock"]["uncertainty_ms"] for w in traced)))
    training.release()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
