"""The check of the dense exact GP with its Gram compared (a
configuration's "reference": "exact_dense_gram"), against
gpbench/reference/exact_dense.py, a plain float64 exact marginal
likelihood worked out again from x, y and the projection. (The name
"exact_dense" is the one test_gpbench_discovery.py gives the smaller
check it adds to a copy of the benchmark.) Its contract is harness.py's:

  recorder(unit)  FirstGram: entered around set-up's recorded call, it
                  keeps the first Gram of the points with themselves that
                  the program computes (step 0's K(x, x)), by a wrapper
                  around the name rpagp_torch.ops.kernels.gram that the
                  step calls; it changes no work
  judged(unit)    nothing
  compare(unit, control=None)
                  the training numbers of reference/check.py (loss, grad,
                  change, change_worst) and gram: the worst row's
                  ||K_prog - K_ref|| / ||K_ref||, the program's rows and
                  columns that it never produced read as zeros (a Gram of
                  half of the points reads 1)

grad is compared here: the dense step has no CG iterations whose stopping
turns rounding into a choice, as the SKI + BBMM step has.
"""

from __future__ import annotations

import torch

from gpbench.reference import check


class FirstGram:
    """While entered, keeps the first K(x, x) the program computes, held
    on the host once the call is over, so that the window's device peak
    is the program's alone."""

    def __enter__(self):
        from rpagp_torch.ops import kernels

        self.mod, self.orig = kernels, kernels.gram
        self.K = None

        def gram(spec, params, buffers, x1, x2):
            out = self.orig(spec, params, buffers, x1, x2)
            if self.K is None and x2 is x1:
                self.K = out.detach().clone()
            return out

        kernels.gram = gram
        return self

    def __exit__(self, *exc):
        self.mod.gram = self.orig
        if exc[0] is None:
            if self.K is None:
                raise RuntimeError("the recorded call made no Gram of the "
                                   "points with themselves: the "
                                   "exact_dense_gram check needs one")
            self.K = self.K.cpu()
        return False


def recorder(unit):
    return FirstGram()


def judged(unit) -> dict:
    return {}


def worst_row(a, b) -> float:
    """max_i ||a_i - b_i|| / ||b_i|| in float64, a (r, c) zero-padded to
    b's (n, n)."""
    b = b.double()
    pad = torch.zeros_like(b)
    pad[:a.shape[0], :a.shape[1]] = a.to(b.device).double()
    gap = torch.linalg.vector_norm(pad - b, dim=1)
    return float(torch.max(gap / torch.linalg.vector_norm(b, dim=1)))


def compare(unit, control: str | None = None) -> dict:
    """The compared numbers: the program's, or with `control` a
    precision, those of the reference computed in it and put in the
    program's place."""
    from gpbench.reference import common, exact_dense

    steps = lambda dtype: exact_dense.first_steps(
        unit.x, unit.y, unit.proj, unit.exp.train.lr,
        len(unit.record["losses"]), dtype)
    with common.precision("f64") as f64:
        ref = steps(f64)
    if control is None:
        got, K = unit.record, unit.recorded.K
    else:
        with common.precision(control) as lo:
            got = steps(lo)
        K = got["gram"]
    out = check.training(got, ref)
    out["gram"] = worst_row(K, ref["gram"])
    return out
