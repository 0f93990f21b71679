"""The program's spans over one profiled unit of a cell, read from the
trace's events (gpbench/spans.py), with the checks that the spans are
whole: every device event tied to its launch, the training steps' device
time against the unit's busy time, every synchronizing call of a step
inside an `rpagp.sync` span. The per-span numbers are those that the
harness's result line cannot carry yet (its trace summary keeps no
events): CG's own device time a step, the preconditioner's apply and
build, launches a step, the idle gaps put down to spans; beside them
K2's and K3's roofline shares with the device time taken from the spans
and from the kernels' names.

  python3 gpbench/tools/span_check.py --workload he_j20_bbmm.train \
      --seeds 11 12 --out spans_out

Set-up, one unit as the window makes it, then the harness's profiled
unit. Each seed prints one JSON line; with --out the whole reduction
goes to <out>/<workload>.<seed>.json.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gpbench import drive, harness, spans, trace  # noqa: E402
from gpbench.metrics import _records, _roofline  # noqa: E402

K2_SPAN, K3_SPAN = "rpagp.op.interp_transpose", "rpagp.op.interp_apply_sum"


def _metric(run, name):
    return harness._load_py(os.path.join(harness.HERE, "metrics",
                                         name + ".py")).read(run)


def _traced(traffic, run, device) -> list:
    """harness._trace_unit, keeping the trace's events it reduces."""
    seen = []
    reduce_events = trace.reduce_events
    trace.reduce_events = lambda ev, wall_s: (seen.append(ev)
                                              or reduce_events(ev, wall_s))
    try:
        harness._trace_unit(traffic, run, device)
    finally:
        trace.reduce_events = reduce_events
    return seen[0]


def measure(c, traffic, device) -> dict:
    """One warm unit, then the profiled unit: the checks and the
    per-step numbers of the reduction."""
    import torch

    from rpagp_torch.utils import profiling

    traffic.unit(0)
    profiling.take_records()
    profiling.take_counts()
    run = harness.Run(c.cfg, device)
    red = spans.reduce(_traced(traffic, run, device))
    sp, steps, busy = red["spans"], run.trace["steps"], run.trace["busy_s"]
    get = lambda name, key: sp.get(name, {}).get(key, 0.0)
    per_step = lambda s: 1e3 * s / steps
    step_dev = get(spans.STEP, "device_s")

    def from_span(calls_key, counts, name):
        # the share with the span's inclusive device time for the kernels'
        kernels = {name: get(name, "device_s")}
        return _roofline.share(
            SimpleNamespace(device=device, counts=run.counts,
                            trace=dict(run.trace, kernels=kernels)),
            calls_key, counts, (name,))

    k2_spans = _records.calls(run, K2_SPAN)
    k3 = _metric(run, "k3_roofline")  # puts the K3 calls on run.trace
    return {
        "steps": steps, "step_spans": get(spans.STEP, "count"),
        "wall_ms_a_step": per_step(run.trace["wall_s"]),
        "busy_ms_a_step": per_step(busy),
        "metrics": {
            "k3_roofline": k3,
            "cg_update_ms.bbmm": per_step(get("rpagp.bbmm.cg",
                                              "self_device_s")),
            "precond_apply_ms.bbmm": per_step(get("rpagp.precond.apply",
                                                  "device_s")),
            "precond_build_ms.bbmm": per_step(get("rpagp.precond.build",
                                                  "device_s")),
            "host_syncs_per_step.bbmm": red["syncs_in_step"] / steps,
            "launches_per_step.bbmm": get(spans.STEP, "device_events")
            / steps,
        },
        "k3_roofline_from_span": from_span("k3_calls", "k3", K3_SPAN),
        "k2_roofline": _metric(run, "k2_roofline"),
        "k2_roofline_from_span": from_span("k2_calls", "k2", K2_SPAN),
        "k2_calls_equal": sorted(k2_spans) == sorted(
            tuple(c) for c in run.trace.get("k2_calls", [])),
        "checks": {
            "unmatched_events": red["unmatched"],
            "device_events": red["device_events"],
            "outside_steps_pct_of_busy": 100.0 * (red["device_s"]
                                                  - step_dev) / busy
            if busy else None,
            "steps_device_vs_busy_pct": 100.0 * (step_dev - busy) / busy
            if busy else None,
            "stray_syncs": red["stray_syncs"],
        },
        "ms_a_step": {name: [v["count"] / steps, per_step(v["host_s"]),
                             per_step(v["device_s"]),
                             per_step(v["self_device_s"])]
                      for name, v in sorted(sp.items())},
        "idle_by_span": red["idle_by_span"],
        "idle_gaps": run.trace["idle_gaps"],
        "reduction": red,
        "device": harness._device_info(torch, device, 0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    c = harness.load_cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        traffic = drive.make(c.cfg, c.mix, seed, device)
        traffic.setup()
        line = measure(c, traffic, device)
        traffic.release()
        del traffic
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        red = line.pop("reduction")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{args.workload}.{seed}.json"),
                      "w") as f:
                json.dump(dict(line, reduction=red), f)
        line.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
