"""Exact GP model: mean + kernel + Gaussian likelihood (port of
rpagp/models/exact_gp.py: the dense Cholesky branch, and the prepare step
of the grid-solver and BBMM paths).

The model is a static `ModelSpec` plus two dicts of tensors:
  params:  {"raw_noise", "mean_const", "kernel": {"raw_lengthscale",
            "raw_outputscale"[, "proj"]}}
  buffers: {"kernel": {"proj"}} (projection kernels) plus, after
           prepare_buffers, the SKI geometry, the per-dataset grid
           caches or the cached preconditioner.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import exact, kernels
from ..ops.kernels import KernelSpec
from ..utils.profiling import span
from ..utils.transforms import softplus

NOISE_FLOOR = 1e-4


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model configuration; the same fields as the JAX package's
    ModelSpec (see its docstring for their meaning)."""

    kernel: KernelSpec
    mean: str = "constant"
    jitter: float = 1e-6
    max_cholesky_size: int = 4096
    cg_tol: float = 1e-2
    cg_max_iters: int = 100
    precond_rank: int = 15
    num_probes: int = 10
    mvm_block_rows: int = 4096
    love_rank: int = 0
    precond_refresh: int = 1
    solver: str = "auto"
    grid_jitter: float = 1e-6


def init_model(spec: ModelSpec, D: int, generator=None, proj=None,
               device="cuda"):
    """(params, buffers) for a fresh model on `device` (the card unless the
    caller asks for the CPU); raw values start at 0 (the GPyTorch
    defaults). proj: an explicit projection matrix, else one is drawn from
    `generator`."""
    kp, kb = kernels.init_kernel_params(spec.kernel, D, generator=generator,
                                        proj=proj, device=device)
    params = {"raw_noise": torch.zeros((), device=device), "kernel": kp}
    if spec.mean == "constant":
        params["mean_const"] = torch.zeros((), device=device)
    return params, {"kernel": kb}


@torch.no_grad()
def prepare_buffers(spec: ModelSpec, params, buffers, x_train, y_train=None):
    """Attach the per-dataset caches (hyperparameter-free, except the
    preconditioner's):
    - a SKI spec on the grid solver: the SKI geometry and S = U^T U; with
      y_train also U^T y, U^T 1 and the anchored value cache, after which
      the MLL step does no work that scales with n. Only evaluate grid_mll
      on this same split afterwards. A product SKI spec (degree * sub_dim
      > 1) always takes this branch, with one geometry row per 1-D factor
      and S of shape (J, m^F, J, m^F);
    - a SKI spec on SKI + BBMM: the SKI geometry alone (`ski_state`);
    - a spec without SKI and with precond_refresh > 1: the pivoted-Cholesky
      preconditioner at these params (`precond_cache`,
      refresh_preconditioner). A SKI spec builds none here, as the JAX
      package: its MLL builds one per step until the trainer's first
      refresh.
    Otherwise the buffers come back unchanged."""
    from ..ops import grid_solve

    if not spec.kernel.ski:
        if spec.precond_refresh > 1 and spec.precond_rank > 0:
            buffers = refresh_preconditioner(spec, params, buffers, x_train)
        return buffers
    kspec = spec.kernel
    state = grid_solve._build_geometry(kspec, params["kernel"],
                                       buffers["kernel"], x_train,
                                       kspec.grid_size)
    if not grid_solve.use_grid_solver(spec, x_train.shape[0]):
        return {**buffers, "ski_state": state}
    S4 = grid_solve._build_gram(kspec, state)
    out = {**buffers, "ski_state": state, "ski_uu": S4}
    if y_train is not None:
        uy, u1 = grid_solve.build_interp_y(kspec, state, y_train)
        vc = grid_solve.build_value_cache(kspec, state, S4, y_train, uy)
        out.update(ski_uy=uy, ski_u1=u1, ski_vc=vc)
    return out


@torch.no_grad()
def _build_precond_cache(spec: ModelSpec, params, kbuffers, x_train):
    from ..ops import precond

    kp = {k: v.detach() for k, v in params["kernel"].items()}
    return precond.build_preconditioner(
        spec.kernel, kp, kbuffers, x_train, noise_value(params).detach(),
        spec.precond_rank)


def refresh_preconditioner(spec: ModelSpec, params, buffers, x_train):
    """Rebuild the cached pivoted-Cholesky preconditioner
    (buffers["precond_cache"]) at the current hyperparameters. With
    spec.precond_refresh = k > 1 the trainer calls this every k steps
    instead of the MLL rebuilding it every evaluation: the estimator
    draws its probes from N(0, M), applies the same M^{-1} and adds the
    same logdet(M), so it stays unbiased for any SPD M; a stale M only
    slows CG as the hyperparameters drift."""
    pre = _build_precond_cache(spec, params, buffers["kernel"], x_train)
    return {**buffers, "precond_cache": pre}


def noise_value(params):
    return softplus(params["raw_noise"]) + NOISE_FLOOR


def mean_fn(spec: ModelSpec, params, x):
    n = x.shape[0]
    ones = torch.ones(n, dtype=x.dtype, device=x.device)
    if spec.mean == "constant":
        return ones * params["mean_const"]
    return ones * 0.0


def exact_mll(spec: ModelSpec, params, buffers, x, y):
    """Exact Cholesky marginal log-likelihood (the total over n points)."""
    with span("rpagp.exact.gram"):
        K = kernels.gram(spec.kernel, params["kernel"], buffers["kernel"], x,
                         x)
    yc = y - mean_fn(spec, params, x)
    return exact.cholesky_mll(K, yc, noise_value(params), spec.jitter)


def _posterior_cache(spec: ModelSpec, params, buffers, x_train, y_train):
    """(noise, L, alpha) of the exact posterior at these params."""
    K = kernels.gram(spec.kernel, params["kernel"], buffers["kernel"],
                     x_train, x_train)
    yc = y_train - mean_fn(spec, params, x_train)
    noise = noise_value(params)
    L, alpha = exact.cholesky_posterior_cache(K, yc, noise, spec.jitter)
    return noise, L, alpha


def make_predictor(spec: ModelSpec, params, buffers, x_train, y_train,
                   observation_noise: bool = True):
    """Cached exact predictor: factor K + s^2 I and the mean cache once,
    return predict(x_test) -> (mu, var) for repeated test batches."""
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    noise, L, alpha = _posterior_cache(spec, params, buffers, x_train,
                                       y_train)

    def predict(x_test):
        K_star = kernels.gram(kspec, kp, kb, x_test, x_train)
        k_diag = kernels.gram_diag(kspec, kp, kb, x_test)
        mean_delta, var = exact.posterior_from_cache(
            K_star, k_diag, L, alpha,
            noise=noise if observation_noise else None)
        return mean_delta + mean_fn(spec, params, x_test), var

    return predict


def predict(spec: ModelSpec, params, buffers, x_train, y_train, x_test,
            observation_noise: bool = True):
    """Posterior predictive (mean, var) at x_test by the exact Cholesky
    path: the mean cache, the cross-covariance mean, the whitened
    variance, and the observation noise when asked for."""
    return make_predictor(spec, params, buffers, x_train, y_train,
                          observation_noise=observation_noise)(x_test)


def predict_cov(spec: ModelSpec, params, buffers, x_train, y_train, x_test,
                observation_noise: bool = False):
    """Posterior (mean, full covariance) at x_test by the exact Cholesky
    path."""
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    noise, L, alpha = _posterior_cache(spec, params, buffers, x_train,
                                       y_train)
    K_star = kernels.gram(kspec, kp, kb, x_test, x_train)
    K_ss = kernels.gram(kspec, kp, kb, x_test, x_test)
    cov = exact.posterior_cov_from_cache(
        K_star, K_ss, L, noise=noise if observation_noise else None)
    return K_star @ alpha + mean_fn(spec, params, x_test), cov
