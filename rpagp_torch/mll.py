"""Marginal log-likelihood and posterior with the JAX package's size
dispatch (subset of rpagp/mll.py). Only the exact grid-solver branch is
ported; the dense Cholesky branch is ROADMAP slice 8 and the BBMM branch
slice 10."""

from __future__ import annotations

from .models.exact_gp import ModelSpec
from .ops import grid_solve


def _route(spec: ModelSpec, n: int) -> None:
    if n <= spec.max_cholesky_size and not spec.kernel.ski:
        raise NotImplementedError(
            "dense Cholesky MLL/posterior: ROADMAP slice 8")
    if not grid_solve.use_grid_solver(spec, n):
        raise NotImplementedError("BBMM CG+SLQ path: ROADMAP slice 10")


def mll(spec: ModelSpec, params, buffers, x, y):
    """Marginal log-likelihood (total, not per point). buffers must come
    from exact_gp.prepare_buffers on this split."""
    _route(spec, x.shape[0])
    return grid_solve.grid_mll(spec, params, buffers, x, y)


def posterior(spec: ModelSpec, params, buffers, x_train, y_train, x_test,
              observation_noise: bool = True):
    """Posterior predictive (mean, var)."""
    _route(spec, x_train.shape[0])
    return grid_solve.grid_posterior(spec, params, buffers, x_train, y_train,
                                     x_test,
                                     observation_noise=observation_noise)
