"""Tracing and per-phase timers (port of rpagp/utils/profiling.py).

  * `trace(logdir, device)`: a context manager on torch.profiler that
    writes a Chrome-trace JSON (`*.pt.trace.json`, readable by
    TensorBoard's profiler plugin or chrome://tracing) into logdir; it
    records the card's kernels whenever the device is CUDA, and raises
    rather than write a trace without them;
  * `PhaseTimer`: named-phase wall-clock totals, each phase ending in a
    synchronize of the device it names;
  * `annotate(name)`: a decorator that names a function's region in a
    trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity


def _on_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(logdir: str | None = None, device=None):
    """Profile the enclosed block into `logdir` (a directory under the
    temporary directory when None); yields logdir. device: the device the
    block runs on (None: the card when there is one). On a CUDA device the
    trace records the card's activity too, and a trace that recorded no
    device event raises RuntimeError."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "rpagp_torch_trace")
    cuda = _on_cuda(device)
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity "
                               "here")
        activities.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    with prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError(f"the trace in {logdir} recorded no CUDA "
                           "activity")


def _sync_devices(tree):
    """torch.cuda.synchronize every CUDA device that a tensor in `tree` (a
    tensor, or a dict / list / tuple of them) lies on."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            _sync_devices(leaf)
    elif isinstance(tree, torch.Tensor) and tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)


class PhaseTimer:
    """Accumulate wall-clock per named phase (waits for the device work of
    `block_on`)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _sync_devices(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase               total_s   calls   s/call"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<18} {t:8.3f} {c:7d} {t / max(c, 1):8.4f}")
        return "\n".join(lines)


def annotate(name: str):
    """Decorator: name a function's region in profiler traces."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)

        return wrapped

    return deco
