"""K1's share of its roofline over the profiled unit (see _roofline.py):
its calls' shapes are those the program's `rpagp.op.chol_linv` span
recorded, (B, b) a call (see _records.py); its kernel is the cooperative
one, csrc/chol_linv_coop.cu."""

from gpbench.metrics import _records, _roofline


def read(run):
    if run.trace:
        run.trace.setdefault("k1_calls",
                             _records.calls(run, "rpagp.op.chol_linv"))
    return _roofline.share(run, "k1_calls", "k1", ("chol_linv_coop_kernel",))
