"""The share of the profiled unit's training steps that replayed the
trainer's captured CUDA graph of the loss and its backward: 100 x the
entries of the `rpagp.train.replay` span over those of the
`rpagp.train.step` span (see _records.py). A program that counts no
replay span gives none."""

from gpbench.metrics import _records


def read(run):
    counts = _records.span_counts(run)
    steps = counts.get("rpagp.train.step")
    if not steps or "rpagp.train.replay" not in counts:
        return None
    return 100.0 * counts["rpagp.train.replay"] / steps
