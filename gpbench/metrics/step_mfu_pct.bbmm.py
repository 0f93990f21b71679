"""The whole bbmm training step's share of the card's float32 peak
(see _mfu.py)."""

from gpbench.metrics import _mfu


def read(run):
    return _mfu.step_mfu_pct(run)
