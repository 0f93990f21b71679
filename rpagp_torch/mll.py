"""Marginal log-likelihood and posterior with the JAX package's size
dispatch (port of rpagp/mll.py): the dense Cholesky branch (n <=
max_cholesky_size without SKI), the exact grid-solver branch (every
product SKI spec, and degree-1 SKI within its budget) and the BBMM
branch (CG + SLQ, LOVE). `observe_routes` reports the branch each
`mll` call took."""

from __future__ import annotations

import contextlib

from .models import exact_gp
from .models.exact_gp import ModelSpec
from .ops import grid_solve


def _solver(spec: ModelSpec, n: int) -> str:
    """"exact", "grid" or "iterative", as rpagp/mll.py dispatches."""
    if n <= spec.max_cholesky_size and not spec.kernel.ski:
        return "exact"
    return "grid" if grid_solve.use_grid_solver(spec, n) else "iterative"


_observers: list = []  # the route lists of the open observe_routes blocks


@contextlib.contextmanager
def observe_routes():
    """Yields a list to which every `mll` call made inside the block
    appends its route, _solver's "exact", "grid" or "iterative" (the
    trainer watches its first step with it: train._graphable)."""
    seen: list = []
    _observers.append(seen)
    try:
        yield seen
    finally:
        _observers.pop()  # blocks nest: this one is the last opened


def mll(spec: ModelSpec, params, buffers, x, y, generator=None):
    """Marginal log-likelihood (total, not per point). The grid branch needs
    buffers from exact_gp.prepare_buffers on this split; the BBMM branch
    draws its probes from `generator` (a torch.Generator on x's device;
    seed 0 when None)."""
    solver = _solver(spec, x.shape[0])
    for seen in _observers:
        seen.append(solver)
    if solver == "exact":
        return exact_gp.exact_mll(spec, params, buffers, x, y)
    if solver == "grid":
        return grid_solve.grid_mll(spec, params, buffers, x, y)
    from .ops.iterative import iterative_mll

    return iterative_mll(spec, params, buffers, x, y, generator)


def posterior(spec: ModelSpec, params, buffers, x_train, y_train, x_test,
              observation_noise: bool = True):
    """Posterior predictive (mean, var)."""
    solver = _solver(spec, x_train.shape[0])
    if solver == "exact":
        return exact_gp.predict(spec, params, buffers, x_train, y_train,
                                x_test, observation_noise=observation_noise)
    if solver == "grid":
        return grid_solve.grid_posterior(spec, params, buffers, x_train,
                                         y_train, x_test,
                                         observation_noise=observation_noise)
    from .ops.iterative import iterative_posterior

    return iterative_posterior(spec, params, buffers, x_train, y_train, x_test,
                               observation_noise=observation_noise)


def make_predictor(spec: ModelSpec, params, buffers, x_train, y_train,
                   observation_noise: bool = True):
    """Cached predictor: factor once (the Cholesky and mean cache of the
    exact branch; the p x p factor and grid-space mean weights of the grid
    branch; the CG mean cache and LOVE cache of the BBMM branch), then
    predict(x_test) -> (mu, var) per batch."""
    solver = _solver(spec, x_train.shape[0])
    if solver == "exact":
        return exact_gp.make_predictor(spec, params, buffers, x_train,
                                       y_train,
                                       observation_noise=observation_noise)
    if solver == "grid":
        return grid_solve.make_grid_predictor(
            spec, params, buffers, x_train, y_train,
            observation_noise=observation_noise)
    from .ops.iterative import make_predictor as _iter_mp

    return _iter_mp(spec, params, buffers, x_train, y_train,
                    observation_noise=observation_noise)


def posterior_cov(spec: ModelSpec, params, buffers, x_train, y_train, x_test,
                  observation_noise: bool = False):
    """Posterior (mean, full covariance) at a modest test batch: the exact
    Cholesky, the grid solver's factored form, or the BBMM path's LOVE
    cache or CG solves."""
    solver = _solver(spec, x_train.shape[0])
    if solver == "grid":
        return grid_solve.grid_posterior_cov(
            spec, params, buffers, x_train, y_train, x_test,
            observation_noise=observation_noise)
    if solver == "iterative":
        from .ops.iterative import iterative_posterior_cov

        return iterative_posterior_cov(spec, params, buffers, x_train,
                                       y_train, x_test,
                                       observation_noise=observation_noise)
    return exact_gp.predict_cov(spec, params, buffers, x_train, y_train,
                                x_test, observation_noise=observation_noise)


def sample_posterior(spec: ModelSpec, params, buffers, x_train, y_train,
                     x_test, generator=None, num_samples: int = 8,
                     observation_noise: bool = False, eps=None):
    """Joint posterior draws at x_test, (num_samples, n_test): normals from
    `generator` (on x_test's device), or `eps` (num_samples, n_test)."""
    from .ops.exact import mvn_sample

    mu, cov = posterior_cov(spec, params, buffers, x_train, y_train, x_test,
                            observation_noise=observation_noise)
    return mvn_sample(mu, cov, num_samples, jitter=spec.jitter,
                      generator=generator, eps=eps)
