"""The program's op records and span counts of the profiled unit
(rpagp_torch.utils.profiling.take_records: a tuple for each K2 / K3
dispatcher call entered while the profiler recorded, the span's name
then (J, n, t, m); take_counts: the entries of the `rpagp.train.step`
and `rpagp.sync` spans), taken once a run and kept on it. A program
without them gives none, and the metrics that read them stay silent."""


def _take(run):
    if hasattr(run, "records"):
        return
    run.records, run.span_counts = [], {}
    try:
        from rpagp_torch.utils import profiling
    except ImportError:
        return
    if run.trace and hasattr(profiling, "take_records"):
        run.records = profiling.take_records()
    if run.trace and hasattr(profiling, "take_counts"):
        run.span_counts = profiling.take_counts()


def records(run) -> list:
    _take(run)
    return run.records


def span_counts(run) -> dict:
    """{span name: entries} of the counted spans."""
    _take(run)
    return run.span_counts


def calls(run, span: str) -> list:
    """The recorded shapes of `span`'s entries."""
    return [r[1:] for r in records(run) if r[0] == span]
