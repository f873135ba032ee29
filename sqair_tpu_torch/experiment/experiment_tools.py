"""Config-module loading and the run-dir protocol (the port of
sqair_tpu/experiment/experiment_tools.py).

- A config is a python module exposing ``load(...)``; importing it defines
  its flags (code as config).  The JAX package's config paths
  (``sqair_tpu/configs/<x>.py``, the defaults and what every flags.json
  holds) name the port's module of the same name
  (``sqair_tpu_torch.configs.<x>``); any other path into ``sqair_tpu/``,
  or one with no port counterpart, raises.  A config file outside both
  packages is imported from its path.
- Run dirs are ``results_dir/run_name/<n>/``, numbered on, holding
  flags.json (with the git commit where there is one) and copies of both
  config files.
- ``--resume`` restores the latest run dir's flags, lets the flags given on
  the command line win (and persists them), and finds its latest
  checkpoint.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from typing import Any, Dict, Optional, Tuple

from . import flags as tf_flags
from ..training.checkpoint import latest_checkpoint

FLAG_FILE = "flags.json"
DEFAULT_CONFIGS = {"data_config": "sqair_tpu/configs/synth_seq_mnist_data.py",
                   "model_config": "sqair_tpu/configs/mlp_mnist_model.py"}
PORT = "sqair_tpu_torch"
JAX_PACKAGE = "sqair_tpu"


def json_store(path: str, data: Dict) -> None:
    with open(path, "w") as f:
        json.dump(data, f, sort_keys=True, indent=4, default=str)


def json_load(path: str) -> Dict:
    with open(path, "r") as f:
        return json.load(f)


def _port_config(name: str, given: str) -> str:
    module = f"{PORT}.configs.{name}"
    if importlib.util.find_spec(module) is None:
        raise ValueError(f"config '{given}' has no counterpart in the port "
                         f"(no module {module})")
    return module


def resolve_config(path_or_name: str) -> str:
    """The module name (or, for a config file outside both packages, the
    file path) that a config path or dotted name means to the port."""
    if path_or_name.endswith(".py"):
        parts = os.path.realpath(path_or_name).split(os.sep)
        name = os.path.splitext(parts[-1])[0]
        if parts[-3:-1] in ([JAX_PACKAGE, "configs"], [PORT, "configs"]):
            return _port_config(name, path_or_name)
        if JAX_PACKAGE in parts[:-1]:
            raise ValueError(f"config '{path_or_name}' lies inside {JAX_PACKAGE}/ and has "
                             f"no counterpart in the port")
        return path_or_name
    parts = path_or_name.split(".")
    if parts[0] in (JAX_PACKAGE, PORT) and parts[1:2] == ["configs"] and len(parts) == 3:
        return _port_config(parts[2], path_or_name)
    if parts[0] == JAX_PACKAGE:
        raise ValueError(f"config '{path_or_name}' names a module of {JAX_PACKAGE} with "
                         f"no counterpart in the port")
    return path_or_name


def _import_module(module_path_or_name: str):
    target = resolve_config(module_path_or_name)
    if not target.endswith(".py"):
        return importlib.import_module(target)
    if not os.path.exists(target):
        raise RuntimeError(f"File {target} does not exist.")
    mod_name = os.path.basename(os.path.splitext(target)[0])
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, target)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def load(conf_path: str, *args, **kwargs):
    """Imports a config module and calls its load()."""
    module = _import_module(conf_path)
    if not hasattr(module, "load"):
        raise ValueError(
            f"The config file should specify a 'load' function but none was "
            f"found in {module.__file__}"
        )
    print(f"Loading '{module.__name__}' from {module.__file__}")
    return module.load(*args, **kwargs)


def parse_flags() -> Dict[str, Any]:
    leftover = tf_flags.FLAGS.parse()
    sys.argv[1:] = leftover
    return tf_flags.FLAGS.as_dict()


def assert_all_flags_parsed():
    not_parsed = [a for a in sys.argv[1:] if a.startswith("--")]
    if not_parsed:
        raise RuntimeError(f"Failed to parse following flags: {not_parsed}")


def get_git_revision_hash() -> str:
    return subprocess.check_output(["git", "rev-parse", "HEAD"],
                                   stderr=subprocess.DEVNULL).decode().strip()


# flags that say where and how a run was started, not what it computes: a
# resume that changes only these leaves flags.json as it is
RESUME_IGNORED = ("resume", "results_dir", "run_name", "device", "coordinator_address",
                  "process_id")


def run_device(checkpoint_dir: str, default: str) -> str:
    """The ``device`` in the flags.json of the newest run dir under
    ``checkpoint_dir``, else ``default``: where a resumed run trained, known
    before ``init_checkpoint`` restores its flags."""
    runs = (sorted((f for f in os.listdir(checkpoint_dir) if f.isdigit()), key=int)
            if os.path.isdir(checkpoint_dir) else [])
    path = os.path.join(checkpoint_dir, runs[-1], FLAG_FILE) if runs else ""
    return (json_load(path).get("device") or default) if os.path.exists(path) else default


def init_checkpoint(checkpoint_dir: str, data_config: str, model_config: str,
                    resume: bool, attach: bool = False) -> Tuple[str, Dict, Optional[str]]:
    """Makes (or, resuming, finds) the run dir; returns (run dir, flags,
    the checkpoint to resume from or None).

    ``attach=True`` joins the newest run dir and writes nothing: the
    processes of a multi-process run other than 0 share process 0's run dir
    (which it made, or found resuming) instead of racing it for the next
    number.  Only process 0 writes flags.json."""
    exists = os.path.exists(checkpoint_dir)
    if not exists:
        if resume or attach:
            raise ValueError(
                f"Can't {'resume' if resume else 'attach'} when the checkpoint dir "
                f"'{checkpoint_dir}' doesn't exist."
            )
        os.makedirs(checkpoint_dir)
    elif not os.path.isdir(checkpoint_dir):
        raise ValueError(f"Checkpoint dir '{checkpoint_dir}' is not a directory.")

    folders = [f for f in os.listdir(checkpoint_dir)
               if not f.startswith("_") and f.isdigit()]
    if folders:
        n = int(sorted(folders, key=int)[-1])
        if not resume and not attach:
            n += 1
    elif attach:
        raise ValueError(f"attach=True but no run dir exists under '{checkpoint_dir}'")
    else:
        if resume:
            raise ValueError(
                f"Can't resume since no experiments were run before in '{checkpoint_dir}'."
            )
        n = 1

    experiment_folder = os.path.join(checkpoint_dir, str(n))
    if not resume and not attach:
        os.mkdir(experiment_folder)

    flag_path = os.path.join(experiment_folder, FLAG_FILE)
    resume_checkpoint = None

    modules = [_import_module(p) for p in (model_config, data_config)]
    flags = parse_flags()
    assert_all_flags_parsed()
    # names given explicitly on the command line (tracked across every
    # parse, the entry script's included)
    cli_names = set(tf_flags.FLAGS._cli_set)

    if resume:
        # a null is a flag the run predates: it keeps its default
        restored = {k: v for k, v in json_load(flag_path).items() if v is not None}
        cli_values = {k: flags[k] for k in cli_names if k in flags}
        flags.update(restored)
        flags.update(cli_values)
        tf_flags.FLAGS.restore(flags)
        changed = [k for k, v in cli_values.items()
                   if k not in RESUME_IGNORED and restored.get(k) != v]
        if changed and not attach:
            # persist the merged flags, so that a later eval of this run dir
            # sees the overrides; the original git_commit stays
            json_store(flag_path, flags)
    elif not attach:
        try:
            flags["git_commit"] = get_git_revision_hash()
        except (subprocess.CalledProcessError, FileNotFoundError):
            pass
        json_store(flag_path, flags)
        for module in modules:
            shutil.copy(module.__file__,
                        os.path.join(experiment_folder, os.path.basename(module.__file__)))
    if resume or attach:
        found = latest_checkpoint(experiment_folder)
        if found is not None:
            resume_checkpoint = found[1]
    return experiment_folder, flags, resume_checkpoint


def load_run(run_dir: Optional[str], batch_size: int, device="cuda",
             overrides: Optional[Dict] = None):
    """(flags, data dict, model) of a run dir, for the tools: its flags.json
    (a null keeps the default) under ``overrides`` in the flag registry, the
    data config's sets in batches of ``batch_size``, and the model config's
    model on ``device`` with fresh weights (its mean_img the train set's),
    for the caller to restore a checkpoint into.  Without a run dir, the
    defaults."""
    saved = {}
    if run_dir:
        saved = {k: v for k, v in json_load(os.path.join(run_dir, FLAG_FILE)).items()
                 if v is not None}
    saved = {**DEFAULT_CONFIGS, **saved, **(overrides or {})}
    F = tf_flags.FLAGS
    # the configs define their flags (the model config first, as the CLIs
    # import them) before the run's values go over them
    for name in ("model_config", "data_config"):
        _import_module(saved[name])
    F.restore(saved)
    data = load(F.data_config, batch_size)
    imgs = data["train_data"]["imgs"]
    model = load(F.model_config, F.as_dict(), imgs.shape[-2:],
                 mean_img=imgs.mean(tuple(range(imgs.ndim - 2))), device=device)
    return F.as_dict(), data, model


def print_flags():
    flags = tf_flags.FLAGS.as_dict()
    print("Flags:")
    print("=" * 60)
    for k in sorted(flags):
        print(f"\t{k}: {flags[k]}")
    print("=" * 60)


def format_integer(number: int, group_size: int = 3) -> str:
    number = str(number)
    parts = []
    while number:
        number, part = number[:-group_size], number[-group_size:]
        parts.append(part)
    return " ".join(reversed(parts))


def print_num_params(module):
    n = sum(p.numel() for p in module.parameters())
    print(f"Number of trainable parameters: {format_integer(n)}")
