"""The program's spans in a profiled unit's Chrome trace: what each
`rpagp.*` span (rpagp_torch.utils.profiling.SPANS) cost on the host and
on the device, and which span held the host through each idle gap of
the device.

A span is a `user_annotation` event on a host thread. A device event
(kernel, copy, set) belongs to the spans open around the runtime or
driver call that launched it: the call carries the same `correlation`
id, and it lies inside a span on its own thread. A thread's outermost
span, or a launch outside any span of its thread, lies inside the
innermost span that another thread has open at that time (the autograd
thread's backward runs while the trainer's thread waits in its
`rpagp.train.backward`).

  reduce(events) -> {
    "spans": {name: {"count", "host_s", "device_s", "self_device_s",
                     "device_events"}},
    "idle_by_span": [[label, s]],   the TOP labels by idle seconds
    "device_s", "device_events",    every device event of the list
    "unmatched": [events, s],       device events with no launch found
    "syncs_in_step",                rpagp.sync spans in rpagp.train.step
    "stray_syncs": [[call, label]], synchronizing calls in a step that
                                    lie in no rpagp.sync span
  }

device_s counts every device event launched inside an instance of the
span; self_device_s those launched inside no child span of it. An idle
gap (as gpbench.trace.reduce_events takes them) goes to the innermost
span around the launch of the device event that ends it, or to
OUTSIDE.
"""

from __future__ import annotations

import bisect

from gpbench.trace import _DEVICE, TOP

PREFIX = "rpagp."
STEP, SYNC = "rpagp.train.step", "rpagp.sync"
OUTSIDE = "outside rpagp spans"
_LAUNCH = ("cuda_runtime", "cuda_driver")
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "cuStreamSynchronize",
               "cuCtxSynchronize", "cuEventSynchronize")


class _Thread:
    """One host thread's spans: starts, ends, names, each span's
    enclosing spans on the thread (innermost first)."""

    def __init__(self, spans):
        spans.sort(key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in spans]
        self.ends = [s[1] for s in spans]
        self.names = [s[2] for s in spans]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(spans):
            while stack and self.ends[stack[-1]] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, t):
        """The innermost span open at time t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            if self.ends[i] >= t:
                return i
            i = self.parent[i]
        return None

    def chain(self, i):
        out = []
        while i is not None:
            out.append(i)
            i = self.parent[i]
        return out


def _key(ev):
    return (ev.get("pid"), ev.get("tid"))


def reduce(events) -> dict:
    threads, launches, device, syncs = {}, {}, [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev["ts"]), float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            threads.setdefault(_key(ev), []).append((s, s + d, name))
        elif cat in _LAUNCH:
            if corr is not None:
                launches[corr] = (_key(ev), s, name)
            if name in _SYNC_CALLS or "Memcpy" in name:
                syncs.append((_key(ev), s, name, corr))
        elif cat in _DEVICE:
            device.append((s, d, name, corr))
    threads = {k: _Thread(v) for k, v in threads.items()}

    def names_at(key, t):
        """The span names open around time t on thread key, innermost
        first, continued on another thread (module docstring)."""
        th = threads.get(key)
        own = [] if th is None else th.chain(th.innermost(t))
        root = th.starts[own[-1]] if own else t
        host, start = None, None
        for k, other in threads.items():
            i = None if k == key else other.innermost(root)
            if i is not None and (start is None or other.starts[i] > start):
                host, start = (other, i), other.starts[i]
        out = [th.names[i] for i in own]
        if host is not None:
            out += [host[0].names[i] for i in host[0].chain(host[1])]
        return out

    spans = {}
    for th in threads.values():
        for s, e, name in zip(th.starts, th.ends, th.names):
            st = spans.setdefault(name, {"count": 0, "host_s": 0.0,
                                         "device_s": 0.0,
                                         "self_device_s": 0.0,
                                         "device_events": 0})
            st["count"] += 1
            st["host_s"] += (e - s) * 1e-6
    syncs_in_step = 0
    for key, th in threads.items():
        for i, name in enumerate(th.names):
            if name == SYNC and STEP in names_at(key, th.starts[i]):
                syncs_in_step += 1

    labels, unmatched, total = [], [0, 0.0], 0.0
    for s, d, name, corr in device:
        total += d
        launch = launches.get(corr)
        chain = [] if launch is None else names_at(launch[0], launch[1])
        if launch is None:
            unmatched[0] += 1
            unmatched[1] += d * 1e-6
        for n in set(chain):
            spans[n]["device_s"] += d * 1e-6
            spans[n]["device_events"] += 1
        if chain:
            spans[chain[0]]["self_device_s"] += d * 1e-6
        labels.append(chain[0] if chain else OUTSIDE)

    # the device's idle gaps, each put down to the label of the event
    # that ends it
    order = sorted(range(len(device)), key=lambda i: device[i][0])
    idle, end = {}, None
    for i in order:
        s, d = device[i][0], device[i][1]
        if end is not None and s > end:
            idle[labels[i]] = idle.get(labels[i], 0.0) + (s - end) * 1e-6
        end = s + d if end is None else max(end, s + d)

    dtoh = {corr for _, _, name, corr in device if "DtoH" in name}
    stray = []
    for key, t, name, corr in syncs:
        if name not in _SYNC_CALLS and corr not in dtoh:
            continue
        chain = names_at(key, t)
        if STEP in chain and SYNC not in chain:
            stray.append([name, chain[0]])
    return {
        "spans": spans,
        "idle_by_span": [[k, v] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]],
        "device_s": total * 1e-6,
        "device_events": len(device),
        "unmatched": unmatched,
        "syncs_in_step": syncs_in_step,
        "stray_syncs": stray,
    }
