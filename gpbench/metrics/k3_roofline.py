"""K3's share of its roofline over the profiled unit (see _roofline.py):
its calls' shapes are those the program's `rpagp.op.interp_apply_sum`
span recorded (see _records.py)."""

from gpbench.metrics import _records, _roofline


def read(run):
    if run.trace:
        run.trace.setdefault(
            "k3_calls", _records.calls(run, "rpagp.op.interp_apply_sum"))
    return _roofline.share(run, "k3_calls", "k3", ("apply_sum_",))
