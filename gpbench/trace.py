"""Reduction of a torch.profiler window to what the per-layer metrics
read: device busy time (the union of kernel, copy and set intervals),
device time by kernel name, and the longest idle gaps of the device,
each labelled by the innermost host op running at its middle.

The profiler's Chrome trace is written under TMPDIR and read back; its
"X" events carry start and duration in microseconds on one clock for
host and device.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10  # entries of each breakdown list


class Window:
    """A profiled region: `with Window(device) as w: ...` then w.summary()."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.wall_s = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """{"wall_s", "busy_s", "kernels": {name: s}, "device_ops":
        [[name, s]], "idle_gaps": [[label, s]]}."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_events(events, self.wall_s)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, wall_s: float) -> dict:
    dev, host, kernels = [], [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, d = float(ev["ts"]), float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in _DEVICE:
            dev.append((s, s + d))
            kernels[ev["name"]] = kernels.get(ev["name"], 0.0) + d * 1e-6
        elif cat in _HOST:
            host.append((s, s + d, ev["name"]))
    busy = _union(dev)
    gaps = [(b[0] - a[1], 0.5 * (a[1] + b[0]))
            for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]

    def label(t):
        # the host op that started last among those running at t
        i = bisect.bisect_right(starts, t)
        for s, e, name in reversed(host[max(0, i - 4096):i]):
            if e >= t:
                return name
        return "host: no op recorded"

    device_ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "wall_s": wall_s,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": kernels,
        "device_ops": [[k, v] for k, v in device_ops],
        "idle_gaps": [[label(mid), g * 1e-6] for g, mid in gaps[:TOP]],
    }
