"""The exact dense training step of `sml_j20_dense` (specs/rp_poly_j20.json
on sml split 0, n_train 3,723) as the trainer runs it, and what the host
spends issuing it, in one process on one card.

    python scripts/torch_dense_step_host.py [--reps 6] [--steps 40]

After 8 warm-up steps, `--reps` reps of `--steps` steps each (a loss read
every 8 steps, as the trainer's), each rep with a pure-Python probe of the
core's speed first (ms for 3M loop turns); per rep the wall ms a step
(ending in a synchronize) and the host's issue ms a step (the time the
step's Python calls take, no sync inside). Then 3 steps under
torch.profiler: the device's kernels and copies a step (the spans' ranges
left out) and their busy ms. Where wall equals issue the host, not the
card, sets the step. Prints the card's name and power limit, then one JSON
line. Run it in several processes, or under `taskset`, to compare hosts.

The profiled eager steps also give the device ms a step of each `rpagp.*`
span (gpbench/spans.py), which a trainer call cannot: there the graph's
replays hold every kernel of the loss and its backward. Last, the
trainer's own calls of 100 steps (`train_to_convergence`, which replays
the step as a CUDA graph on this route): wall ms a step, the replays, and
under the profiler the host's launch calls a step (kernel and graph
launches, copies and sets) and the device's busy ms a step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def core_probe_ms() -> float:
    t = time.perf_counter()
    s = 0
    for i in range(3_000_000):
        s += i & 7
    return (time.perf_counter() - t) * 1e3


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpbench import spans
    from rpagp_torch.mll import mll
    from rpagp_torch.models import exact_gp
    from rpagp_torch.train import train_to_convergence
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    exp = load_spec(os.path.join(ROOT, "specs", "rp_poly_j20.json"))
    split = next(datasets.kfold_splits(datasets.load_dataset("sml"), k=10,
                                       seed=0, equal_train=True))
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    params, buffers = exact_gp.init_model(
        exp.model, x.shape[1], generator=torch.Generator().manual_seed(0),
        device=dev)
    leaves = [params["raw_noise"], params["mean_const"],
              *params["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=exp.train.lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -mll(exp.model, params, buffers, x, y) / n
        loss.backward()
        opt.step()
        return loss

    for _ in range(8):
        step()
    torch.cuda.synchronize()
    reps = []
    for _ in range(args.reps):
        probe = core_probe_ms()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        issue = 0.0
        for i in range(args.steps):
            a = time.perf_counter()
            loss = step()
            issue += time.perf_counter() - a
            if i % 8 == 7:
                float(loss)
        torch.cuda.synchronize()
        reps.append({"core_probe_ms": probe,
                     "wall_ms": (time.perf_counter() - t0) / args.steps * 1e3,
                     "issue_ms": issue / args.steps * 1e3})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("rpagp.")]
    launches = len(ops) / 3
    by_span = spans.reduce(_chrome_events(prof))["spans"]

    def call():
        return train_to_convergence(
            lambda p, b, xx, yy: -mll(exp.model, p, b, xx, yy) / n,
            params, dataclasses.replace(exp.train, max_iters=100,
                                        patience=100),
            loss_args=(buffers, x, y), sync_every=8)

    call()
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) / res.iterations * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = call()
        torch.cuda.synchronize()
    host = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith("cuda")
            and ("Launch" in e.name or "Memcpy" in e.name
                 or "Memset" in e.name)]
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("rpagp.")]
    issue = statistics.median(r["issue_ms"] for r in reps)
    print(json.dumps({
        "cpus": len(os.sched_getaffinity(0)),
        "launches_a_step": launches,
        "busy_ms": sum(e.device_time for e in ops) / 3 / 1e3,
        "wall_ms": statistics.median(r["wall_ms"] for r in reps),
        "issue_ms": issue, "issue_us_a_launch": 1e3 * issue / launches,
        "device_ms_by_span": {k: 1e3 * v["device_s"] / 3
                              for k, v in sorted(by_span.items())},
        "reps": reps,
        "trainer_call": {
            "wall_ms_a_step": calls, "replays": res.replays,
            "host_launch_calls_a_step": len(host) / res.iterations,
            "busy_ms_a_step": sum(e.device_time for e in dev)
            / res.iterations / 1e3}}), flush=True)
    return 0


def _chrome_events(prof):
    """The profiler's Chrome-trace events (written to a temporary file
    and read back)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


if __name__ == "__main__":
    sys.exit(main())
