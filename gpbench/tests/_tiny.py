"""A cell run end to end on the CPU at tiny n."""

import io
import json
import time
from contextlib import redirect_stdout

# J = 4 projections on a 32-point grid, 3,000 rows, 6 steps a call
TINY = {"device": "cpu", "data": {"n": 3000},
        "kernel": {"J": 4, "grid_size": 32},
        "training": {"max_iters": 6, "patience": 6}}


def run(workload: str, seed: int = 2147483700, trace: int = 0,
        seconds: float = 0.5, overrides=None):
    """(exit code, the result's JSON object or None, stdout)."""
    from gpbench import harness

    out = io.StringIO()
    with redirect_stdout(out):
        rc = harness.run_cell(["--workload", workload, "--seed", str(seed),
                               "--seconds", str(seconds), "--trace",
                               str(trace)], time.perf_counter(),
                              overrides or dict(TINY))
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, out.getvalue()
