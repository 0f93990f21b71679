"""The general traffic generator: reads a mix (gpbench/traffic/<mix>.json)
and drives the program with it, one closed loop, each unit after the
last. A cell's unit and its check are found by name from files, as
harness.py finds metrics and counts:

  gpbench/units/<mix["unit"]>.py         the unit: a class `Unit`
  gpbench/checks/<cfg["reference"]>.py   the check of the
                                         configuration's model

`Unit(cfg, mix, seed, device, checks)` has setup(), unit(i) -> {"steps",
"ok"} (one unit of the window), traced_unit() -> {"steps", "units", "ok"}
(what the profiler records after the window), release() (drops the
program's state but what the check judges), and after set-up `n_train`
and `checks`, the check module, whose contract harness.py states. The
mix's keys: "unit", and those its unit reads.

A name with no file is an error that names the missing file: a cell
never runs without its unit, nor without its check.
"""

from __future__ import annotations

import os

from gpbench import harness

_FOUND = {}


def find(kind: str, name: str):
    """The module gpbench/<kind>/<name>.py, loaded once a file."""
    path = os.path.join(harness.HERE, kind, f"{name}.py")
    if path not in _FOUND:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {kind} file {path} for {name!r}")
        _FOUND[path] = harness._load_py(path)
    return _FOUND[path]


def make(cfg, mix, seed: int, device):
    """The cell's unit, with the check that its configuration names."""
    if "reference" not in cfg:
        raise KeyError(f"configuration {cfg.get('name')!r} names no "
                       "reference: its check is gpbench/checks/"
                       "<reference>.py")
    checks = find("checks", cfg["reference"])
    return find("units", mix["unit"]).Unit(cfg, mix, seed, device, checks)
