"""The benchmark's own tests: CPU runs of whole cells at tiny n (through
harness.run_cell's test-only overrides), the reference against the
port's plain CPU path, the counts, discovery of new cells by file name,
the modules a run loads, and the faults the check has to catch. Tests
marked `cuda` decide inside themselves whether a card is present."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
