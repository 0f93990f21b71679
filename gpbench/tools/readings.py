"""The readings a cell's limits are set from (BENCHMARK.json's `correct`):
on each seed, the numbers the check compares for the program, for the
control (the reference computed in TF32, the precision below the float32
with TF32 off that the configuration states, put in the program's
place), and for the faults the cell can have, planted in the program:

  half      the training step sees the first half of the rows: the loss
            on them, its mean over that half scaled to all n rows;
            prepare sees every row
  half_mvm  the SKI MVM's transpose (W^T V) sums the first half of the
            rows alone, scaled by n / (n / 2): K2 leaving out half of
            the batch and taking the mean over the rest

A step that leaves the state unchanged reads 1 by the change number's
measure and needs no run. One process reads every seed, so set-up's
imports and kernel loads are paid once:

  python3 gpbench/tools/readings.py --workload he_j20_bbmm.train \
      --seeds 11 12 13 --control-seeds 11 12 13 --fault-seeds 11 12 13

Each seed's readings go to standard output as one JSON line; the last
line is the summary: per number the largest program reading, the
smallest control reading and the smallest reading of each fault.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gpbench import drive, harness  # noqa: E402


def _first_rows(state, h: int):
    """The dense SKI geometry of the first h points (the same grid)."""
    return state._replace(**{f: getattr(state, f)[..., :h].contiguous()
                             for f in ("tfrac", "i0", "w4")
                             if getattr(state, f) is not None})


@contextlib.contextmanager
def _half_rows():
    """The loss on the first half of the training rows, prepare intact."""
    mll_mod = importlib.import_module("rpagp_torch.mll")
    mll0 = mll_mod.mll

    def mll(spec, p, b, x, y, *g):
        h = x.shape[0] // 2
        b = dict(b)
        if b.get("ski_state") is not None:
            b["ski_state"] = _first_rows(b["ski_state"], h)
        return mll0(spec, p, b, x[:h], y[:h], *g) * (x.shape[0] / h)

    mll_mod.mll = mll
    try:
        yield
    finally:
        mll_mod.mll = mll0


@contextlib.contextmanager
def _half_mvm():
    """W^T V over the first half of the rows, times n / (n / 2)."""
    from rpagp_torch.ops import ski

    orig = ski.ski_mvm

    def mvm(spec, kparams, state, V, state_rhs=None):
        h = V.shape[0] // 2
        Vh = V.new_zeros(V.shape)
        Vh[:h] = V[:h] * (V.shape[0] / h)
        return orig(spec, kparams, state, Vh, state_rhs=state_rhs)

    ski.ski_mvm = mvm
    try:
        yield
    finally:
        ski.ski_mvm = orig


FAULTS = {"half": _half_rows, "half_mvm": _half_mvm}


def _program(cfg, mix, seed, device, fault=None):
    """Set-up of the program on `seed`, optionally with a fault planted;
    returns the released traffic."""
    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        traffic = drive.make(cfg, mix, seed, device)
        traffic.setup()
    traffic.release()
    gc.collect()
    return traffic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=list(FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default="{}",
                    help="JSON merged into the configuration (small runs)")
    args = ap.parse_args(argv)
    import torch

    c = harness.load_cell(args.workload, json.loads(args.override))
    device = torch.device(args.device)
    summary = {"program": {}, "control": {}}
    worst = lambda key, nums, pick: summary.setdefault(key, {}).update(
        {k: pick(v, summary[key].get(k, v)) for k, v in nums.items()})
    for seed in args.seeds:
        t0 = time.perf_counter()
        tr = _program(c.cfg, c.mix, seed, device)
        line = {"seed": seed, "program": tr.checks.compare(tr)}
        if hasattr(tr.checks, "leaves"):
            line["leaves"] = tr.checks.leaves(tr)
        worst("program", line["program"], max)
        if seed in args.control_seeds:
            line["control"] = tr.checks.compare(tr, control="tf32")
            worst("control", line["control"], min)
        del tr
        for fault in args.faults if seed in args.fault_seeds else ():
            try:
                trf = _program(c.cfg, c.mix, seed, device, fault)
            except (RuntimeError, ValueError) as exc:
                # a fault that crashes the program has failed the check
                line[fault] = {"crashed": repr(exc)[:300]}
                continue
            line[fault] = trf.checks.compare(trf)
            worst(fault, line[fault], min)
            del trf
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "kind": (torch.cuda.get_device_name(0)
                               if device.type == "cuda" else "cpu"),
                      "power_limit_w": harness._power_limit()}), flush=True)


if __name__ == "__main__":
    main()
