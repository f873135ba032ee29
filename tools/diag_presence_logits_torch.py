"""The distribution of discovery presence LOGITS at early frames of one
checkpoint of the port (the counterpart of tools/diag_presence_logits.py).

Per early frame, the logit quantiles of the kept (presence 1) slots, split
by scenes whose inferred count is right and those whose count is too high,
and of the dropped slots: how saturated the early discoveries' Bernoulli
is.

Usage:
    python tools/diag_presence_logits_torch.py <run_dir> <step> \
        [json-flag-overrides] [--device cpu]

One batch of 32 of the run's valid set (after the example batch), the
model's full record with the noise of a generator seeded with 1.  Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqair_tpu_torch.device import resolve_device  # noqa: E402
from sqair_tpu_torch.experiment.experiment_tools import load_run  # noqa: E402
from sqair_tpu_torch.scripts.eval import default_noise  # noqa: E402
from sqair_tpu_torch.training.checkpoint import find_checkpoints, restore_params  # noqa: E402

BATCH = 32
QUANTILES = [5, 25, 50, 75, 95]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir")
    p.add_argument("step", type=int)
    p.add_argument("overrides", nargs="?", default="{}",
                   help="a JSON dict of flags over the run's flags.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    _, data, model = load_run(args.run_dir, BATCH, device, json.loads(args.overrides))
    restore_params(find_checkpoints(args.run_dir)[args.step], model.sequence)
    batcher = data["valid_iter"]
    next(batcher)
    b = next(batcher)
    with torch.inference_mode():
        out = model.forward(torch.as_tensor(b["imgs"], device=device), default_noise(device)())
    logit = out["presence_logit"].cpu().numpy()  # [T, B*k, S]
    pres = out["presence"].cpu().numpy()
    # true counts per scene, tiled as the particles are: row b*k + particle
    nums = np.asarray(b["nums"]).sum(-1)  # [T, B]
    k = logit.shape[1] // nums.shape[1]
    nums_tiled = np.repeat(nums, k, axis=1)
    inferred = pres.sum(-1)  # [T, B*k]
    print(f"record shapes: logit {logit.shape}, presence {pres.shape}, "
          f"true nums {nums.shape} (k={k})")
    report = {}
    for t in range(min(3, logit.shape[0])):
        kept = pres[t] > 0.5
        over = (inferred[t] > nums_tiled[t])[:, None] & kept
        ok = (inferred[t] == nums_tiled[t])[:, None] & kept
        lo, lk = logit[t][over], logit[t][ok]
        dropped = (~kept) & (np.abs(logit[t]) > 1e-6)
        report[t] = dict(kept=int(kept.sum()), on_count=lk, over_count=lo,
                         dropped=logit[t][dropped])
        print(f"\nt={t}: kept slots {kept.sum()}, on-count scenes' kept logits n={lk.size}, "
              f"over-count scenes' kept logits n={lo.size}")
        for name, v in (("on-count", lk), ("over-count", lo), ("dropped", logit[t][dropped])):
            if v.size:
                print(f"  {name:10s} q{QUANTILES}: "
                      + " ".join(f"{x:8.2f}" for x in np.percentile(v, QUANTILES)))
        if lo.size:
            print(f"  over-count min {lo.min():.2f} max {lo.max():.2f}")
    return report


if __name__ == "__main__":
    main()
