"""Warm-start a --disc_coverage_signal run of the port from a flag-off
checkpoint (the port's counterpart of tools/pad_coverage_params.py).

The coverage signal (sqair_tpu_torch/models/core.py, DiscoveryCore)
appends COVERAGE_RES^2 = 16 features to the DISCOVERY steps predictor's
input, growing its first-layer kernel ``w_0`` [d_in, d_out] by 16 input
rows.  The new features are concatenated last, so zero rows make the
padded model compute what the original did; training then learns the
coverage weights from a function-preserving start.  The optimizer's state
of that kernel is padded with zero rows too, as the JAX package's tool pads
its optax state.

Library use:   params, hits = pad_for_coverage(state_dict)
CLI use:       python tools/pad_coverage_params_torch.py <run_dir> <step> <out_dir>
  reads <run_dir>/ckpt-<step> (the port's checkpoint format,
  sqair_tpu_torch/training/checkpoint.py), pads it and writes
  <out_dir>/ckpt-<step>.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Mapping, Tuple

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sqair_tpu_torch.training.checkpoint import CKPT_PREFIX, load_checkpoint  # noqa: E402
from sqair_tpu_torch.training.train import is_disc_steps_kernel  # noqa: E402

N_EXTRA = 16


def _pad(tensors: Mapping[str, torch.Tensor], n_extra: int
         ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The tensors with n_extra zero rows under each discovery steps
    predictor kernel name; the names padded."""
    out, hits = {}, []
    for name, t in tensors.items():
        if is_disc_steps_kernel(name) and t.ndim == 2:
            hits.append(name)
            t = torch.cat([t, t.new_zeros((n_extra, t.shape[1]))], 0)
        out[name] = t
    return out, hits


def pad_for_coverage(params: Mapping[str, torch.Tensor], n_extra: int = N_EXTRA
                     ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Appends ``n_extra`` zero input rows to the discovery steps
    predictor's first-layer kernel of a state_dict; everything else is
    unchanged.  Raises unless exactly one such kernel is found."""
    out, hits = _pad(params, n_extra)
    if len(hits) != 1:
        raise ValueError(f"expected exactly one discovery steps-predictor kernel, "
                         f"found {len(hits)}: {hits}")
    return out, hits


def pad_optimizer_state(state: Mapping, n_extra: int = N_EXTRA) -> Dict:
    """A checkpoint's optimizer state ({"count", slot: {name: tensor}}) with
    each slot's kernel padded by zero rows."""
    return {k: v if k == "count" else _pad(v, n_extra)[0] for k, v in state.items()}


def pad_checkpoint(src: str, dst: str, n_extra: int = N_EXTRA) -> List[str]:
    """Pads the checkpoint file ``src`` into ``dst``; returns the names padded."""
    state = load_checkpoint(src)
    state["params"], hits = pad_for_coverage(state["params"], n_extra)
    if "optimizer" in state:
        state["optimizer"] = pad_optimizer_state(state["optimizer"], n_extra)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(state, dst)
    return hits


def main(argv):
    if len(argv) != 4:
        print(__doc__)
        return 1
    run_dir, step, out_dir = argv[1], int(argv[2]), argv[3]
    name = f"{CKPT_PREFIX}{step}"
    hits = pad_checkpoint(os.path.join(run_dir, name), os.path.join(out_dir, name))
    print(f"padded {name} -> {out_dir}; padded tensors:")
    for h in hits:
        print(f"  {h}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
