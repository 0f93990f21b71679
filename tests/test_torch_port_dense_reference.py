"""rpagp_torch's dense exact branch against the benchmark's plain float64
reference (gpbench/reference/exact_dense.py), on the CPU at the
sml_j20_dense configuration's widths (J = 20 degree-1 RBF projections, D
= 26): mll.mll's value and gradient, and the first three Adam steps of
train_to_convergence. n = 300 factors with the builtin Cholesky; n = 700
is above the 512 block, so block_chol.blocked_cholesky's elimination and
K1's plain CPU version run."""

import os
import sys

import pytest
import torch

from rpagp_torch.mll import _solver, mll as mll_fn
from rpagp_torch.models import exact_gp
from rpagp_torch.ops import kernels
from rpagp_torch.train import train_to_convergence
from rpagp_torch.utils.config import experiment_spec_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpbench.reference import check, common, data, exact_dense  # noqa: E402
from gpbench.units.train_call import StepRecorder  # noqa: E402

torch.set_num_threads(2)
J, D, SEED = 20, 26, 2147483811
SPEC = {"model": "exact_gp",
        "kernel": {"type": "projection", "J": J, "d": 1, "base": "rbf",
                   "proj_dist": "gaussian"},
        "training": {"lr": 0.1, "max_iters": 4, "patience": 4},
        "inference": {"max_cholesky_size": 4096}}
# float32 against float64: the loss sums n log-pivots and a quadratic
# form, each good to a few float32 roundings (6e-8), so 1e-5 relative
# leaves room at n = 700; the gradient goes back through the factor and
# n^2 Gram entries, and 1e-4 is ROADMAP's bar for the port's gradients
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
# the change of each moving leaf over three Adam steps: Adam's first
# steps are close to lr * sign(gradient), so a float32 gradient good to
# 1e-4 moves a leaf by the same amount to well under 1e-3 of its change
CHANGE_TOL = 1e-3


def _problem(n):
    """(spec, x, y, proj, params, buffers) on seeded synthetic data at SML's
    width, z-scored as the benchmark makes it."""
    exp = experiment_spec_from_dict(SPEC)
    X, y = data.synthetic(n, D, SEED, "cpu")
    s = data.zscored_split(X, y, torch.arange(n), torch.arange(0))
    x, y = s["train_x"], s["train_y"]
    proj = data.gaussian_projection(D, J, SEED)
    params, buffers = exact_gp.init_model(exp.model, D, proj=proj,
                                          device="cpu")
    assert _solver(exp.model, n) == "exact"
    return exp, x, y, proj, params, buffers


@pytest.mark.parametrize("n", [300, 700])
def test_mll_value_and_gradient(n):
    """At seeded raw hyperparameters away from the initial ones (every
    lengthscale its own)."""
    exp, x, y, proj, params, buffers = _problem(n)
    g = torch.Generator().manual_seed(n)
    raw = {"raw_lengthscale": 0.5 * torch.randn(J, generator=g),
           "raw_outputscale": 0.3 * torch.randn((), generator=g),
           "mean_const": 0.1 * torch.randn((), generator=g),
           "raw_noise": -1.0 + 0.2 * torch.randn((), generator=g)}
    p = {"raw_noise": raw["raw_noise"].clone().requires_grad_(True),
         "mean_const": raw["mean_const"].clone().requires_grad_(True),
         "kernel": {k: raw[k].clone().requires_grad_(True)
                    for k in ("raw_lengthscale", "raw_outputscale")}}
    loss = -mll_fn(exp.model, p, buffers, x, y) / n
    loss.backward()
    loss = float(loss.detach())
    got = {k: v.grad for k, v in [*p["kernel"].items(),
                                  ("raw_noise", p["raw_noise"]),
                                  ("mean_const", p["mean_const"])]}

    with common.precision("f64") as f64:
        z = common.project(x, proj, f64)
        want_loss, want = exact_dense.loss_and_grad(
            z, y.to(f64), {k: v.to(f64) for k, v in raw.items()})
    assert abs(loss - float(want_loss)) <= VALUE_TOL * abs(float(want_loss))
    gp = torch.cat([got[k].double().reshape(-1) for k in want])
    gr = torch.cat([want[k].reshape(-1) for k in want])
    assert float((gp - gr).norm() / gr.norm()) <= GRAD_TOL


@pytest.mark.parametrize("n", [300, 700])
def test_three_training_steps(n):
    """train_to_convergence's first three Adam steps from the initial
    hyperparameters, read as the benchmark's check reads them."""
    exp, x, y, proj, params, buffers = _problem(n)
    rec = StepRecorder(params)
    res = train_to_convergence(
        lambda p, b, xx, yy: -mll_fn(exp.model, p, b, xx, yy) / n, params,
        exp.train, loss_args=(buffers, x, y), sync_every=8, grad_hook=rec)
    got = rec.record(res.losses)
    with common.precision("f64") as f64:
        ref = exact_dense.first_steps(x, y, proj, exp.train.lr, 3, f64)
    nums = check.training(got, ref)
    assert nums["loss"] <= VALUE_TOL, nums
    assert nums["grad"] <= GRAD_TOL, nums
    assert nums["change_worst"] <= CHANGE_TOL, nums
    # step 0's Gram, as the check's recorder keeps it
    K = kernels.gram(exp.model.kernel, params["kernel"], buffers["kernel"],
                     x, x)
    assert check.columns(K, ref["gram"]) <= 1e-6  # float32 rounding
