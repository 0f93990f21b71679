"""The device's idle share of a unit: 1 - (the device's busy time a unit
in the profiled units: the union of kernel, copy and set intervals) /
(the wall time a unit in the window, which runs without the profiler).
The profiler's own host work lengthens a launch-bound step (a grid step
at n = 1.8M: 71 against 35 ms on an H100), so the profiled units' wall
time would overstate the idle share."""


def idle_pct(run, per: str):
    """per: "steps" (a training step) or "units" (a unit of the mix)."""
    tr, w = run.trace, run.window
    if not tr or not tr.get("busy_s") or not tr.get(per) or not w.get(per):
        return None
    busy = tr["busy_s"] / tr[per]
    return 100.0 * (1.0 - busy / (w["seconds"] / w[per]))
