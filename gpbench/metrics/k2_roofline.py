"""K2's share of its roofline over the profiled unit (see _roofline.py)."""

from gpbench.metrics import _roofline


def read(run):
    return _roofline.share(run, "k2_calls", "k2",
                           ("transpose_own_kernel", "transpose_slots_kernel",
                   "reduce_partials_kernel"))
