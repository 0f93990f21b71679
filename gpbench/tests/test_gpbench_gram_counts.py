"""counts/gram.py (K6 / K7, the dense Gram and its backward) against a
count made by hand."""

import pytest

from gpbench import harness
from gpbench.counts import peaks


def test_dense_gram_at_the_exact_cell():
    """K6 / K7 at sml_j20_dense's K(x, x): both directions bound by their
    operations, 24.8 us each against the float32 peak."""
    gram = harness.Run(None, None).counts("gram")
    J, n = 20, 3723
    fwd, bwd = gram.work(J, n, n, "fwd"), gram.work(J, n, n, "bwd")
    assert fwd == (4 * (J * 2 * n + n * n), 6 * J * n * n)
    assert bwd == (4 * (2 * J * 2 * n + n * n), 6 * J * n * n)
    for w in (fwd, bwd):
        assert w[1] / peaks.F32_FLOPS_S > w[0] / peaks.HBM_BYTES_S
        assert peaks.bound_s(*w) * 1e6 == pytest.approx(24.82, rel=1e-3)
    with pytest.raises(ValueError):
        gram.work(J, n, n, "both")
