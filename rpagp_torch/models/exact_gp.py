"""Exact GP model: mean + kernel + Gaussian likelihood (port of
rpagp/models/exact_gp.py: the dense Cholesky branch, and the prepare step
of the grid-solver and BBMM paths).

The model is a static `ModelSpec` plus two dicts of tensors:
  params:  {"raw_noise", "mean_const", "kernel": {"raw_lengthscale",
            "raw_outputscale"[, "proj"]}}
  buffers: {"kernel": {"proj"}} (projection kernels) plus, after
           prepare_buffers, the SKI geometry and the per-dataset grid
           caches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import exact, kernels
from ..ops.kernels import KernelSpec
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
    """Attach the per-dataset grid-solver caches (hyperparameter-free):
    the SKI geometry and S = U^T U; with y_train also U^T y, U^T 1 and
    the anchored value cache, after which the MLL step does no work that
    scales with n. Only evaluate grid_mll on this same split afterwards.
    A spec without SKI needs no cache: its buffers come back unchanged."""
    from ..ops import grid_solve

    if not spec.kernel.ski:
        if spec.precond_refresh > 1 and spec.precond_rank > 0:
            raise NotImplementedError(
                "precond_refresh > 1 (the cached preconditioner): ROADMAP "
                "slice 10")
        return buffers
    if not grid_solve.use_grid_solver(spec, x_train.shape[0]):
        raise NotImplementedError(
            "SKI + BBMM (the SKI geometry cache, ski.ski_mvm): ROADMAP "
            "slice 3")
    kspec = spec.kernel
    state = grid_solve.ski.build_ski(kspec, params["kernel"],
                                     buffers["kernel"], x_train,
                                     kspec.grid_size)
    S4 = grid_solve.build_interp_gram(state)
    out = {**buffers, "ski_state": state, "ski_uu": S4}
    if y_train is not None:
        uy, u1 = grid_solve.build_interp_y(kspec, state, y_train)
        vc = grid_solve.build_value_cache(kspec, state, S4, y_train, uy)
        out.update(ski_uy=uy, ski_u1=u1, ski_vc=vc)
    return out


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
    K = kernels.gram(spec.kernel, params["kernel"], buffers["kernel"], x, x)
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
