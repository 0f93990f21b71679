"""The bbmm training cells' step time (see _step.py)."""

from gpbench.metrics import _step


def read(run):
    return _step.step_ms(run)
