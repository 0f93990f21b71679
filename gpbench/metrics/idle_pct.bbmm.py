"""Device idle share of the bbmm training cells' steps (see
_idle.py)."""

from gpbench.metrics import _idle


def read(run):
    return _idle.idle_pct(run, "steps")
