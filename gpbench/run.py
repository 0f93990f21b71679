"""Runs one cell of the rpagp_torch benchmark once and prints its result
as the last line of standard output, one JSON object:

  python3 gpbench/run.py --workload he_j20_bbmm.train --seed 7 \
      --seconds 10 --trace 0

--trace 1 also profiles one unit and reports the cell's per-layer
metrics in place of its end-to-end ones. Run from the checkout's root;
the program's kernels build into rpagp_torch/_build/ on the first run.
"""

import os
import sys
import time


def _process_start() -> float:
    """perf_counter() at this process's start (Linux /proc; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    T_START = _process_start()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from gpbench import harness

    sys.exit(harness.run_cell(sys.argv[1:], T_START))
