"""K6 / K7's share of their roofline over the profiled unit (see
_roofline.py): the calls' shapes are those the program's
`rpagp.op.dense_gram` span recorded, (J, n, m, direction) a call (see
_records.py), counted by counts/gram.py; the kernels are every kernel
whose name holds `dense_gram` (csrc/gram_mvm.cu: the forward, the
backward and its slot sums)."""

from gpbench.metrics import _records, _roofline


def read(run):
    if run.trace:
        run.trace.setdefault("gram_calls",
                             _records.calls(run, "rpagp.op.dense_gram"))
    return _roofline.share(run, "gram_calls", "gram", ("dense_gram",))
