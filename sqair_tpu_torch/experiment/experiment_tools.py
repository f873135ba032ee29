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


def init_checkpoint(checkpoint_dir: str, data_config: str, model_config: str,
                    resume: bool) -> Tuple[str, Dict, Optional[str]]:
    """Makes (or, resuming, finds) the run dir; returns (run dir, flags,
    the checkpoint to resume from or None)."""
    exists = os.path.exists(checkpoint_dir)
    if not exists:
        if resume:
            raise ValueError(
                f"Can't resume when the checkpoint dir '{checkpoint_dir}' doesn't exist."
            )
        os.makedirs(checkpoint_dir)
    elif not os.path.isdir(checkpoint_dir):
        raise ValueError(f"Checkpoint dir '{checkpoint_dir}' is not a directory.")

    folders = [f for f in os.listdir(checkpoint_dir)
               if not f.startswith("_") and f.isdigit()]
    if folders:
        n = int(sorted(folders, key=int)[-1])
        if not resume:
            n += 1
    else:
        if resume:
            raise ValueError(
                f"Can't resume since no experiments were run before in '{checkpoint_dir}'."
            )
        n = 1

    experiment_folder = os.path.join(checkpoint_dir, str(n))
    if not resume:
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
        if any(restored.get(k) != v for k, v in cli_values.items()):
            # persist the merged flags, so that a later eval of this run dir
            # sees the overrides; the original git_commit stays
            json_store(flag_path, flags)
        found = latest_checkpoint(experiment_folder)
        if found is not None:
            resume_checkpoint = found[1]
    else:
        try:
            flags["git_commit"] = get_git_revision_hash()
        except (subprocess.CalledProcessError, FileNotFoundError):
            pass
        json_store(flag_path, flags)
        for module in modules:
            shutil.copy(module.__file__,
                        os.path.join(experiment_folder, os.path.basename(module.__file__)))

    return experiment_folder, flags, resume_checkpoint


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
