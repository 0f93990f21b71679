"""The whole training step's share of the card's float32 peak: the
step's operations (gpbench/counts/<config>_step.py, at the
configuration's shapes) times the window's steps, over the window's wall
time times 67 TFLOP/s."""


def step_mfu_pct(run):
    w = run.window
    if run.device.type != "cuda" or not w.get("steps"):
        return None
    peaks = run.counts("peaks")
    step = run.counts(run.cfg["name"] + "_step")
    flops = step.flops(run.cfg, run.n_train)
    return 100.0 * flops * w["steps"] / (w["seconds"] * peaks.F32_FLOPS_S)
