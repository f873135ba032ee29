"""Checkpoints of the port, in the JAX package's run-dir layout
(``<results_dir>/<run_name>/<n>/ckpt-<step>``, sqair_tpu/training/checkpoint.py).

A checkpoint is one file written by ``torch.save`` and read back with
``torch.load(..., weights_only=True)``; it holds tensors and ints only:

  {"step": int,
   "params": {state_dict key: tensor},          # mean_img included
   "optimizer": {"count": int,                  # the optimizer's step count
                 <slot>: {key: tensor}, ...},   # optional
   "rng": {name: generator state}}              # optional

The optimizer's state is kept per slot of its ``STATE`` (RMSProp: "nu" and
"trace"; adam: "mu" and "nu"; momentum: "trace"; sgd: none) and per
parameter name; a parameter that never had a gradient (the decoder's two
stds, where they are not learnable) has none.  ``rng`` holds the
states of the training's ``torch.Generator``s (the experiment CLI's batch
indices and model noise; in a multi-process run every process's noise
generator, under ``rank_noise_key``), so that a resumed run draws what an
uninterrupted one would.
``tools/jax_ckpt_to_torch.py`` writes this format from an orbax checkpoint.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Mapping, Optional, Tuple

import torch

from .train import TrainState

CKPT_PREFIX = "ckpt-"


def find_checkpoints(run_dir: str) -> Dict[int, str]:
    """step -> path of every checkpoint in a run dir."""
    if not os.path.isdir(run_dir):
        return {}
    pat = re.compile(rf"^{CKPT_PREFIX}(\d+)$")
    out = {}
    for name in os.listdir(run_dir):
        m = pat.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(run_dir, name)
    return out


def latest_checkpoint(run_dir: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the run dir's latest checkpoint, or None."""
    ckpts = find_checkpoints(run_dir)
    if not ckpts:
        return None
    step = max(ckpts)
    return step, ckpts[step]


def _optimizer_state(sequence: torch.nn.Module, optimizer) -> Dict:
    """An optimizer's state keyed by slot and by the parameters' names in
    ``sequence``."""
    names = {id(p): n for n, p in sequence.named_parameters()}
    out = dict(count=int(optimizer.count), **{k: {} for k in optimizer.STATE})
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st:
                for k in optimizer.STATE:
                    out[k][names[id(p)]] = st[k].detach().cpu().clone()
    return out


def rank_noise_key(rank: int) -> str:
    """The name of process ``rank``'s noise generator in a checkpoint: that
    of a single-process run for process 0."""
    return "noise" if rank == 0 else f"noise_rank{rank}"


def save_checkpoint(run_dir: str, step: int, sequence: torch.nn.Module,
                    optimizer=None,
                    generators: Optional[Mapping[str, torch.Generator]] = None) -> str:
    """Writes ``<run_dir>/ckpt-<step>`` (under a temporary name first, so a
    reader never sees half a file) and returns its path.

    :param generators: name -> a generator, or the state of one (another
        process's)"""
    state = dict(step=int(step),
                 params={k: v.detach().cpu().clone() for k, v in sequence.state_dict().items()})
    if optimizer is not None:
        state["optimizer"] = _optimizer_state(sequence, optimizer)
    if generators:
        state["rng"] = {name: g.get_state() if isinstance(g, torch.Generator) else g
                        for name, g in generators.items()}
    return write_checkpoint(run_dir, step, state)


def write_checkpoint(run_dir: str, step: int, state: Dict) -> str:
    """Writes a checkpoint's dict as ``<run_dir>/ckpt-<step>``, under a
    temporary name first; returns its path."""
    path = os.path.abspath(os.path.join(run_dir, f"{CKPT_PREFIX}{int(step)}"))
    os.makedirs(run_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=run_dir)
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            torch.save(state, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_checkpoint(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_params(path: str, sequence: torch.nn.Module) -> int:
    """Loads the parameters strictly into ``sequence``; returns the step."""
    state = load_checkpoint(path)
    sequence.load_state_dict(state["params"], strict=True)
    return int(state["step"])


def restore_train_state(path: str, sequence: torch.nn.Module, train_state: TrainState,
                        generators: Optional[Mapping[str, torch.Generator]] = None
                        ) -> TrainState:
    """Loads parameters, the optimizer's state and the step into a train
    state bound to ``sequence``'s parameters (``training.init_train``), and
    the saved state of each of ``generators`` that the checkpoint holds
    (one without keeps its seed)."""
    state = load_checkpoint(path)
    for name, g in (generators or {}).items():
        if name in state.get("rng", {}):
            g.set_state(state["rng"][name])
    sequence.load_state_dict(state["params"], strict=True)
    opt = train_state.optimizer
    saved = state.get("optimizer")
    if saved is None:
        raise KeyError(f"{path} holds no optimizer state")
    params = dict(sequence.named_parameters())
    slots = sorted(set(saved) - {"count"})
    if slots != sorted(opt.STATE):
        raise KeyError(f"{path} holds the optimizer state {slots}, not the "
                       f"{type(opt).__name__}'s {sorted(opt.STATE)}")
    held = [set(saved[k]) for k in opt.STATE]
    unknown = sorted(set().union(*held) - set(params))
    if unknown or any(h != held[0] for h in held):
        raise KeyError(f"{path}: optimizer state for unknown parameters {unknown}")
    opt.state.clear()
    for name in (held[0] if held else ()):
        p = params[name]
        opt.state[p] = {k: saved[k][name].to(p.device, p.dtype).clone() for k in opt.STATE}
    opt.count = int(saved["count"])
    train_state.step = int(state["step"])
    return train_state
