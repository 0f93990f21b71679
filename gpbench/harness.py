"""One run of one benchmark cell: set-up, the measured window, with
--trace 1 a profiled unit after it, the check against the plain
reference, the metrics.

Everything a cell needs is found by name from BENCHMARK.json: its
configuration (gpbench/configs/<config>.json, the `file` entry), its
traffic mix (gpbench/traffic/<mix>.json), the limits of its check
(gpbench/limits/<workload>.json; `load_cell`) and one reader per metric
(gpbench/metrics/<metric>.py, `read(run) -> float | None`). Counts of
operations and bytes sit in gpbench/counts/<name>.py; `Run.counts`
loads one by name. The mix names its unit (gpbench/units/<unit>.py) and
the configuration its check (gpbench/checks/<reference>.py), which
gpbench/drive.py finds by name; a missing file is an error.

A check module has three functions, each handed the unit:

  recorder(unit)  a context manager entered around set-up's recorded
                  call, which goes through the window's own call and
                  feed; what it yields the unit keeps as `recorded`. It
                  may wrap program functions to keep what they compute,
                  and changes no work
  judged(unit)    what the check judges of the program's state (a dict,
                  kept as `judged`), taken at release() before that
                  state is dropped
  compare(unit, control=None)
                  after the window and release(): the compared numbers,
                  {name: float}, a relative gap or a count each, 0 for
                  an exact match, worked out from the program's outputs
                  (the unit's `record` of its first steps, `recorded`,
                  `judged`) and from a plain reference that imports
                  nothing of the program; with `control` a precision,
                  the reference computed in it in the program's place

The last line on standard output is the result, one JSON object; the
numbers compared, each beside its limit, close standard error and the
result's `compared` entry.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rpagp")
# caches of any library the program pulls in stay inside the checkout
CACHE_DIR = os.path.join(HERE, "_cache")


def _load_py(path: str):
    spec = importlib.util.spec_from_file_location(
        "gpbench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_deep_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _for_cell(metrics, cell: str):
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, overrides: dict | None = None):
    """What BENCHMARK.json's cell `name` runs, found by name: .bench (the
    whole file), .cell (its entry), .cfg (its configuration, with
    `overrides` merged in), .mix (its traffic mix) and .limits (its
    check's limits). KeyError for a name the file lacks."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return types.SimpleNamespace(
        bench=bench, cell=cell,
        cfg=_deep_merge(_json(os.path.join(ROOT, entry["file"])),
                        overrides or {}),
        mix=_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "limits", name + ".json")))


class Run:
    """What the metric readers read: the window, the traced unit, the
    program's counters, the configuration and the counts."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = device
        self.setup_s = None
        self.window = {}  # seconds, units, steps, peak_bytes
        self.trace = None  # trace.Window.summary() plus counters
        self.n_train = None

    def counts(self, name: str):
        return _load_py(os.path.join(HERE, "counts", name + ".py"))


def forbidden_modules():
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _device_info(torch, device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
    limit = _power_limit()
    if limit is not None:
        info["power_limit_w"] = limit
    return info


def _trace_unit(traffic, run, device):
    from gpbench import trace
    from gpbench.probes import Probes

    with Probes() as probes, trace.Window(device) as w:
        out = traffic.traced_unit()
    summary = w.summary()
    summary.update(steps=out["steps"], units=out["units"],
                   **probes.counters())
    run.trace = summary


def _window(traffic, run, seconds, device, torch):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    units = steps = failed = 0
    t0 = time.perf_counter()
    while units == 0 or time.perf_counter() - t0 < seconds:
        try:
            out = traffic.unit(units)
        except (RuntimeError, ValueError, FloatingPointError) as exc:
            print(f"[gpbench] unit {units} failed: {exc!r}", file=sys.stderr)
            out = {"steps": 0, "ok": False}
        units += 1
        steps += out["steps"]
        failed += 0 if out["ok"] else 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.window = {"seconds": time.perf_counter() - t0, "units": units,
                  "steps": steps, "failed": failed}
    if device.type == "cuda":
        run.window["peak_bytes"] = torch.cuda.max_memory_allocated(device)


def _compare(traffic, limits, failed: int):
    got = traffic.checks.compare(traffic)
    got["failed_units"] = failed
    missing = sorted(set(limits) - set(got))
    if missing:
        raise KeyError(f"no number for the limits {missing}")
    correct = all(got[k] <= limits[k] for k in limits)
    # a number that is not finite is printed as a string: the line stays
    # JSON
    compared = {k: {"value": got[k] if math.isfinite(got[k]) else
                    str(got[k]), "limit": limits[k]} for k in limits}
    return correct, compared


def run_cell(argv, t_start: float, overrides: dict | None = None) -> int:
    """Runs one cell; returns the exit code. overrides (tests only): a
    dict merged into the configuration, with "device" to run elsewhere
    than on the card."""
    ap = argparse.ArgumentParser(prog="gpbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    overrides = dict(overrides or {})
    device_name = overrides.pop("device", "cuda")

    try:
        c = load_cell(args.workload, overrides)
    except KeyError:
        print(f"[gpbench] no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell, cfg, mix, limits = c.cell, c.cfg, c.mix, c.limits
    metrics = _for_cell(c.bench["per_layer"] if args.trace
                        else c.bench["end_to_end"], cell["name"])

    for var in ("TRITON_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR"):
        os.environ.setdefault(var, os.path.join(CACHE_DIR, var.lower()))
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    if device_name == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"[gpbench] {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    device = torch.device(device_name)

    from gpbench import drive

    run = Run(cfg, device)
    traffic = drive.make(cfg, mix, args.seed, device)
    traffic.setup()
    run.n_train = traffic.n_train
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    run.setup_s = time.perf_counter() - t_start
    _window(traffic, run, args.seconds, device, torch)
    peak = max(setup_peak, run.window.get("peak_bytes", 0))
    if args.trace:
        # after the window, so that the profiler's hooks touch no
        # measured unit
        _trace_unit(traffic, run, device)
    traffic.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, compared = _compare(traffic, limits, run.window["failed"])
    print(f"[gpbench] set-up {run.setup_s:.3f} s, window "
          f"{run.window['seconds']:.3f} s ({run.window['units']} units, "
          f"{run.window['steps']} steps), check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    values = {}
    for m in metrics:
        v = _load_py(os.path.join(HERE, "metrics", m["name"] + ".py")).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"[gpbench] the run loaded {found}: the benchmark may load "
              f"none of {list(FORBIDDEN)}", file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": run.window["units"],
              "failed": run.window["failed"], "metrics": values,
              "device": _device_info(torch, device, peak)}
    if args.trace and device.type == "cuda":
        result["device"].update(busy_s=run.trace["busy_s"],
                                window_s=run.trace["wall_s"])
    if args.trace:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["compared"] = compared
    for k, v in compared.items():
        print(f"[gpbench] compared {k} = {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
