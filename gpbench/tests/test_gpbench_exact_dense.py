"""sml_j20_dense.train's check (gpbench/checks/exact_dense_gram.py) on
the CPU at a small n, through the whole of a run: a sound run reads
`correct`, and each fault planted in the program reads not correct, by
the number that should catch it. The reference loads nothing of the
program. The counts of K1 and of the dense step at shapes worked by
hand. On the card, the control (the reference in TF32 put in the
program's place) fails the limits."""

import contextlib
import gc

import pytest
import torch

from gpbench import drive, harness
from gpbench.tools import readings

from _tiny import run
from test_gpbench_imports import _top

CELL = "sml_j20_dense.train"
# J = 20, D = 26 as configured; n_train 720, above the 512 block, so the
# blocked factor and K1's plain version run; 6 steps a call
SMALL = {"device": "cpu", "data": {"n": 800},
         "training": {"max_iters": 6, "patience": 6}}


@contextlib.contextmanager
def _nineteen_components():
    """The Gram sums 19 of its 20 components: the last one's weight 0."""
    from rpagp_torch.ops import kernels

    orig = kernels._component_scales

    def scales(spec, params):
        w = orig(spec, params)
        keep = torch.ones_like(w)
        keep[-1] = 0.0
        return w * keep

    kernels._component_scales = scales
    try:
        yield
    finally:
        kernels._component_scales = orig


@contextlib.contextmanager
def _state_unchanged():
    """Adam's step leaves the state unchanged."""
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


# each fault with the number that has to catch it
FAULTS = {"half": (readings.FAULTS["half"], "gram"),
          "nineteen": (_nineteen_components, "gram"),
          "unchanged": (_state_unchanged, "change")}


def test_a_sound_run_passes():
    rc, res, _ = run(CELL, overrides=dict(SMALL))
    assert rc == 0 and res["correct"] is True
    assert set(res["compared"]) == {"loss", "grad", "change", "gram",
                                    "failed_units"}
    assert set(res["metrics"]) == {"step_ms.bbmm", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_reads_not_correct(fault):
    plant, number = FAULTS[fault]
    with plant():
        rc, res, _ = run(CELL, overrides=dict(SMALL))
    assert rc == 0 and res["correct"] is False
    got = res["compared"][number]
    assert got["value"] > got["limit"], res["compared"]


_REF = """
import sys
sys.path.insert(0, {root!r})
import torch
from gpbench.reference import data, exact_dense
x = torch.rand(300, 5, dtype=torch.float64)
exact_dense.first_steps(x, torch.rand(300), data.gaussian_projection(5, 3, 0),
                        0.1, 2, torch.float64)
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_reference_loads_nothing_of_the_program():
    _, top = _top(_REF)
    assert "rpagp_torch" not in top
    assert not set(top) & set(harness.FORBIDDEN)


def test_k1_counts_at_the_leaf():
    from gpbench.counts import k1, peaks

    nbytes, flops = k1.work(1, 512)
    assert nbytes == 4 * 3 * 512 * 512  # A in, L and L^-1 out
    assert flops == pytest.approx(2 * 512 ** 3 / 3)
    # PERF.md section 6 row 1a: 0.0013 ms, bound by the operations
    assert peaks.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0013,
                                                              rel=3e-2)
    assert k1.work(20, 256) == (20 * 3 * 4 * 256 ** 2,
                                pytest.approx(20 * 2 * 256 ** 3 / 3))


def test_dense_step_counts_at_sml():
    c = harness.load_cell(CELL)
    n, J, D = 3723, 20, 26
    gram = 12 * J * n * n + 2 * n * D * J + 2 * n * J
    factor_and_vjp = (1 / 3 + 2 / 3) * n ** 3  # the VJP twice the factor
    want = gram + factor_and_vjp + 5 * n * n
    got = harness.Run(None, None).counts("sml_j20_dense_step").flops(c.cfg, n)
    assert got == pytest.approx(want)
    assert got == pytest.approx(5.5003e10, rel=1e-4)


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 is a property of the card")
    c = harness.load_cell(CELL)
    tr = drive.make(c.cfg, c.mix, 12345, torch.device("cuda"))
    tr.setup()
    tr.release()
    gc.collect()
    got = tr.checks.compare(tr, control="tf32")
    assert any(got[k] > v for k, v in c.limits.items() if k in got), got
