"""Marginal log-likelihood and posterior with the JAX package's size
dispatch (subset of rpagp/mll.py): the exact grid-solver branch and the
BBMM branch (CG + SLQ, LOVE). The dense Cholesky branch (n <=
max_cholesky_size without SKI) is ROADMAP slice 8."""

from __future__ import annotations

from .models.exact_gp import ModelSpec
from .ops import grid_solve


def _solver(spec: ModelSpec, n: int) -> str:
    """"grid" or "iterative", as rpagp/mll.py dispatches."""
    if n <= spec.max_cholesky_size and not spec.kernel.ski:
        raise NotImplementedError(
            "dense Cholesky MLL/posterior: ROADMAP slice 8")
    return "grid" if grid_solve.use_grid_solver(spec, n) else "iterative"


def mll(spec: ModelSpec, params, buffers, x, y, generator=None):
    """Marginal log-likelihood (total, not per point). The grid branch needs
    buffers from exact_gp.prepare_buffers on this split; the BBMM branch
    draws its probes from `generator` (a torch.Generator on x's device;
    seed 0 when None)."""
    if _solver(spec, x.shape[0]) == "grid":
        return grid_solve.grid_mll(spec, params, buffers, x, y)
    from .ops.iterative import iterative_mll

    return iterative_mll(spec, params, buffers, x, y, generator)


def posterior(spec: ModelSpec, params, buffers, x_train, y_train, x_test,
              observation_noise: bool = True):
    """Posterior predictive (mean, var)."""
    if _solver(spec, x_train.shape[0]) == "grid":
        return grid_solve.grid_posterior(spec, params, buffers, x_train,
                                         y_train, x_test,
                                         observation_noise=observation_noise)
    from .ops.iterative import iterative_posterior

    return iterative_posterior(spec, params, buffers, x_train, y_train, x_test,
                               observation_noise=observation_noise)


def make_predictor(spec: ModelSpec, params, buffers, x_train, y_train,
                   observation_noise: bool = True):
    """Cached predictor of the BBMM branch (mean cache + LOVE cache, then
    one cross-kernel MVM per call): predict(x_test) -> (mu, var). The grid
    branch's make_grid_predictor is ROADMAP slice 5c."""
    if _solver(spec, x_train.shape[0]) == "grid":
        raise NotImplementedError(
            "grid_solve.make_grid_predictor: ROADMAP slice 5c")
    from .ops.iterative import make_predictor as _iter_mp

    return _iter_mp(spec, params, buffers, x_train, y_train,
                    observation_noise=observation_noise)
