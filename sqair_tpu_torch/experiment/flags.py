"""A flag registry over argparse (a copy of sqair_tpu/experiment/flags.py).

The contract:

- flags are DEFINEd at import time by whichever config modules get loaded;
- ``parse_flags()`` can be called repeatedly as more flags appear, consuming
  recognised ``--flag=value`` args from sys.argv and leaving the rest;
- the parsed dict round-trips through flags.json (``restore``);
- direct attribute assignment (``F.seq_len = 2``) works for test presets.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple


class _FlagValues:
    def __init__(self):
        object.__setattr__(self, "_defs", {})  # name -> (type, default, help)
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_parsed", False)
        object.__setattr__(self, "_cli_set", set())  # names set via parse()
        object.__setattr__(self, "_tuned", set())  # names moved by set_default

    # -- definition ----------------------------------------------------
    def _define(self, name: str, default, help_str: str, ftype):
        if name in self._defs:
            return  # repeated imports of the same config are fine
        self._defs[name] = (ftype, default, help_str)
        self._values.setdefault(name, default)

    # -- access --------------------------------------------------------
    def __getattr__(self, name):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        defs = object.__getattribute__(self, "_defs")
        if name in defs:  # defined but value cleared (e.g. test isolation)
            return defs[name][1]
        raise AttributeError(f"Unknown flag '{name}'")

    def __setattr__(self, name, value):
        self._values[name] = value

    def __contains__(self, name):
        return name in self._values

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    # -- parsing -------------------------------------------------------
    def parse(self, args: Optional[List[str]] = None) -> List[str]:
        """Parses known flags from ``args`` (default sys.argv[1:]);
        returns leftover args."""
        if args is None:
            args = sys.argv[1:]
        parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
        for name, (ftype, default, help_str) in self._defs.items():
            if ftype is bool:
                parser.add_argument(
                    f"--{name}", nargs="?", const="true", default=None, help=help_str
                )
            else:
                parser.add_argument(f"--{name}", type=ftype, default=None, help=help_str)
        ns, leftover = parser.parse_known_args(args)
        for name in self._defs:
            v = getattr(ns, name, None)
            if v is not None:
                if self._defs[name][0] is bool and isinstance(v, str):
                    v = v.lower() in ("true", "t", "1", "yes")
                self._values[name] = v
                self._cli_set.add(name)
        object.__setattr__(self, "_parsed", True)
        return leftover

    def restore(self, values: Dict[str, Any]) -> None:
        """Overwrites from a flags.json dict."""
        self._values.update(values)
        object.__setattr__(self, "_parsed", True)


FLAGS = _FlagValues()


def DEFINE_string(name, default, help_str=""):
    FLAGS._define(name, default, help_str, str)


def DEFINE_integer(name, default, help_str=""):
    FLAGS._define(name, default, help_str, int)


def DEFINE_float(name, default, help_str=""):
    FLAGS._define(name, default, help_str, float)


def DEFINE_boolean(name, default, help_str=""):
    FLAGS._define(name, default, help_str, bool)


DEFINE_bool = DEFINE_boolean


def define_all(table: Iterable[Tuple[type, str, Any, str]]) -> Dict[str, Any]:
    """DEFINEs every (type, name, default, help) row of ``table``; returns
    {name: default}, so that a module's defaults and its flags have one
    source."""
    defaults = {}
    for ftype, name, default, help_str in table:
        FLAGS._define(name, default, help_str, ftype)
        defaults[name] = default
    return defaults


def set_default(name: str, value) -> None:
    """Changes a flag's default after definition (config-variant helper).

    The current value is updated too unless the user already overrode it
    (by CLI parse or direct assignment) to something other than the old
    default.

    When several config modules retune the same flag, the FIRST one wins:
    configs are imported model-config-first (experiment_tools.py), so a
    model variant's retune beats a data config's generic default.
    """
    if name not in FLAGS._defs:
        raise KeyError(f"Unknown flag '{name}'")
    if name in FLAGS._tuned:
        return
    ftype, old_default, help_str = FLAGS._defs[name]
    FLAGS._defs[name] = (ftype, value, help_str)
    if FLAGS._values.get(name) == old_default and name not in FLAGS._cli_set:
        FLAGS._values[name] = value
    FLAGS._tuned.add(name)


def reset():
    """Puts every flag back to its default and forgets which ones the
    command line set, for a caller that runs the CLI's main() more than once
    in a process.  The definitions stay: the config modules that made them
    are imported once per process."""
    FLAGS._values.clear()
    FLAGS._values.update({name: d[1] for name, d in FLAGS._defs.items()})
    FLAGS._cli_set.clear()
    object.__setattr__(FLAGS, "_parsed", False)
