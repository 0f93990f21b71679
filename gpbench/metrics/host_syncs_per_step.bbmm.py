"""The program's annotated device->host reads a training step in the
profiled unit: entries of the `rpagp.sync` span over entries of the
`rpagp.train.step` span (see _records.py). It counts annotations, not
synchronizing calls: a read added without a span reads as no change,
and a sync span entered outside a step counts too (in this cell's unit
every one lies in a step). gpbench/tools/span_check.py checks, from the
trace's runtime calls, that no synchronizing call of a step lies outside
a sync span."""

from gpbench.metrics import _records


def read(run):
    counts = _records.span_counts(run)
    steps = counts.get("rpagp.train.step")
    return counts.get("rpagp.sync", 0) / steps if steps else None
