"""The window's wall time over every training step it completed (the
window ends in a device synchronize), in ms."""


def step_ms(run):
    w = run.window
    return 1e3 * w["seconds"] / w["steps"] if w.get("steps") else None
