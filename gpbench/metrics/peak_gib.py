"""torch.cuda.max_memory_allocated over the window (reset as it opens),
in GiB: which n fits one card."""


def read(run):
    peak = run.window.get("peak_bytes")
    return None if peak is None else peak / 2 ** 30
