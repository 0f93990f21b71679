"""Tracing, spans and per-phase timers (port of rpagp/utils/profiling.py).

  * `trace(logdir, device)`: a context manager on torch.profiler that
    writes a Chrome-trace JSON (`*.pt.trace.json`, readable by
    TensorBoard's profiler plugin or chrome://tracing) into logdir; it
    records the card's kernels whenever the device is CUDA, and raises
    rather than write a trace without them; on exit it drops the op
    records and counts the block left;
  * `span(name, record=None)`: the program's named regions. While a
    torch profiler records, a span is a `torch.profiler.record_function`
    range, a `user_annotation` event in the same trace as the kernels,
    so host spans and device events share one clock and each kernel is
    tied by its `correlation` id to the launch inside the span. Entering
    it appends `(name, *record)` to the op records when the caller
    passes a record (the K2 / K3 dispatchers pass their (J, n, t, m)),
    and counts the entry when the name is one of `COUNTED` (the
    training steps and the host reads). Otherwise it returns one shared
    no-op, after a single read of torch's profiler flag: there is no
    setting, tracing is on exactly while a profiler records (the
    benchmark's traced unit, the runner's --profile, `trace`). A span
    adds no host read, no synchronize, no copy and no allocation, and
    changes no result;
  * `SPANS`: every span name with its layer;
  * `take_records()` / `take_counts()`: the op records and the counts
    since the last take, cleared (`trace` clears both on exit);
  * `PhaseTimer`: named-phase wall-clock totals, each phase ending in a
    synchronize of the device it names;
  * `annotate(name)`: `span` as a decorator.
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
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

# (span name, layer): every span the program opens. PERF.md's layer map
# mirrors this list.
SPANS = (
    ("rpagp.split.prepare", "runner"),
    ("rpagp.split.train", "runner"),
    ("rpagp.split.posterior", "runner"),
    ("rpagp.train.step", "trainer"),
    ("rpagp.train.refresh", "trainer"),
    ("rpagp.train.loss", "trainer"),
    ("rpagp.train.backward", "trainer"),
    ("rpagp.train.update", "trainer"),
    ("rpagp.sync", "host"),
    ("rpagp.bbmm.cg", "CG"),
    ("rpagp.bbmm.operator", "SKI + BBMM step"),
    ("rpagp.bbmm.slq", "SKI + BBMM step"),
    ("rpagp.bbmm.backward", "SKI + BBMM step"),
    ("rpagp.precond.apply", "preconditioner"),
    ("rpagp.precond.build", "preconditioner"),
    ("rpagp.op.interp_transpose", "kernels"),
    ("rpagp.op.interp_apply_sum", "kernels"),
    ("rpagp.op.toeplitz", "kernels"),
    ("rpagp.love.lanczos", "posterior"),
)

# the spans whose entries are counted while a profiler records
COUNTED = ("rpagp.train.step", "rpagp.sync")

_records: list = []
_counts = dict.fromkeys(COUNTED, 0)

_NO_SPAN = contextlib.nullcontext()  # what `span` returns with no profiler


def span(name: str, record: tuple | None = None):
    """A context manager naming a region of the program (module
    docstring). Off: one flag read, the shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if record is not None:
        _records.append((name, *record))
    elif name in _counts:
        _counts[name] += 1
    return torch.profiler.record_function(name)


def take_records() -> list:
    """The op records since the last take (module docstring), cleared."""
    out = _records[:]
    _records.clear()
    return out


def take_counts() -> dict:
    """{name: entries} of the `COUNTED` spans since the last take,
    cleared."""
    out = dict(_counts)
    _counts.update(dict.fromkeys(COUNTED, 0))
    return out


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
    try:
        with prof:
            yield logdir
            if cuda:
                torch.cuda.synchronize()
    finally:
        take_records()
        take_counts()
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
    """Decorator: `span(name)` around each call of the function."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(name):
                return fn(*a, **kw)

        return wrapped

    return deco
