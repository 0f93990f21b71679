"""The count functions against counts made by hand."""

import json
import math
import os

import pytest

from gpbench import harness
from gpbench.counts import k2, peaks


def _count(name):
    return harness.Run(None, None).counts(name)


def _cfg(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_k2_at_the_bbmm_width():
    J, n, t, m = 20, 1844352, 9, 256
    nbytes, flops = k2.work(J, n, t, m)
    assert nbytes == 4 * (20 * 1844352 + 1844352 * 9 + 20 * 9 * 256)
    assert flops == 8 * 20 * 1844352 * 9
    # PERF.md section 6: 0.0639 ms at t = 9
    assert peaks.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0639,
                                                              rel=2e-3)


def test_bbmm_step_at_the_flagship():
    n, J, m, t, k = 1844352, 20, 256, 9, 15
    fft = J * t * (2 * 5 * 2 * m * math.log2(2 * m) + 6 * (m + 1))
    per_iter = 16 * J * n * t + fft + 4 * n * k * t + 12 * n * t
    # 100 steps: fresh builds at steps 0-9, refreshes at 10, 20, ..., 90
    build = k * (4 * J * n + 2 * n * k) * 19 / 100
    want = 20 * per_iter + 24 * J * n * t + fft + build
    got = _count("he_j20_bbmm_step").flops(_cfg("he_j20_bbmm"), n)
    assert got == pytest.approx(want)
