"""A kernel's share of its roofline over the profiled unit: the least
time its calls could take (each call's bytes and operations from its
shapes, gpbench/counts/<kernel>.py, against the card's peaks) over the
device time of its kernels in the trace."""


def share(run, calls_key: str, counts: str, names):
    tr = run.trace
    if run.device.type != "cuda" or not tr or not tr.get(calls_key):
        return None
    t = sum(s for k, s in tr["kernels"].items() if any(n in k for n in names))
    if t <= 0:
        return None
    peaks, work = run.counts("peaks"), run.counts(counts).work
    least = sum(peaks.bound_s(*work(*c)) for c in tr[calls_key])
    return 100.0 * least / t
