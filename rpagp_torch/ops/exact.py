"""Exact GP inference: the dense Cholesky marginal log-likelihood and
posterior (port of rpagp/ops/exact.py).

The factor is block_chol.blocked_cholesky: above its 512 block, GEMMs
around K1 on each diagonal leaf (ops/cuda_chol.py); at or below it, the
builtin Cholesky, as in the JAX package. The MLL records no autograd
graph through the factor: its gradient is the closed form
d mll / d Khat = 1/2 (alpha alpha^T - Khat^{-1}), d mll / d y = -alpha,
with Khat^{-1} from the forward's factor (blocked_cholesky itself stays
differentiable for its other callers). The MLL's factor, its solve and
logdet, and its backward sit in the `rpagp.exact.factor`,
`rpagp.exact.solve` and `rpagp.exact.backward` spans
(exact_gp.exact_mll's Gram in `rpagp.exact.gram`).
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span
from .block_chol import blocked_cholesky, blocked_solve_triangular

LOG_2PI = 1.8378770664093453


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def add_jitter(K, noise, jitter: float = 1e-6):
    """K + (noise + jitter) I."""
    return K + (noise + jitter) * _eye(K.shape[-1], K)


class _CholeskyMLL(torch.autograd.Function):
    """mll(Khat, y) with its closed-form VJP from the forward's factor L
    and alpha = Khat^{-1} y. An indefinite Khat gives a NaN factor, so a
    NaN loss and NaN gradients, with no host read."""

    @staticmethod
    def forward(ctx, Khat, y):
        with span("rpagp.exact.factor"):
            L = blocked_cholesky(Khat)
        with span("rpagp.exact.solve"):
            alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
            inv_quad = y @ alpha
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        ctx.save_for_backward(L, alpha)
        return -0.5 * (inv_quad + logdet + y.shape[0] * LOG_2PI)

    @staticmethod
    def backward(ctx, g):
        L, alpha = ctx.saved_tensors
        with span("rpagp.exact.backward"):
            # Khat^{-1} = L^{-T} L^{-1} by two triangular solves: a float32
            # GEMM L^{-T} L^{-1} sums its diagonal too coarsely for the
            # noise's gradient, alpha^T alpha - tr(Khat^{-1}), which cancels
            Kinv = torch.linalg.solve_triangular(
                L.mT, torch.linalg.solve_triangular(
                    L, _eye(L.shape[0], L), upper=False), upper=True)
            grad_K = Kinv.addr_(alpha, alpha, alpha=-1.0).mul_(-0.5 * g)
            return grad_K, -g * alpha


def cholesky_mll(K, y_centered, noise, jitter: float = 1e-6):
    """Exact marginal log-likelihood (the total, not per point):
    -1/2 [y^T (K + s^2 I)^{-1} y + logdet(K + s^2 I) + n log 2 pi].
    The noise's gradient flows through add_jitter."""
    return _CholeskyMLL.apply(add_jitter(K, noise, jitter), y_centered)


def cholesky_posterior_cache(K_train, y_centered, noise,
                             jitter: float = 1e-6):
    """(L, alpha): the factor of K + s^2 I and the mean cache
    alpha = (K + s^2 I)^{-1} y_c, computed once per evaluation."""
    L = blocked_cholesky(add_jitter(K_train, noise, jitter))
    alpha = torch.cholesky_solve(y_centered[:, None], L)[:, 0]
    return L, alpha


def posterior_from_cache(K_star, k_diag_star, L, alpha, noise=None):
    """Posterior (mean_delta, var) at the test points from the (L, alpha)
    cache. K_star: (n_test, n_train); k_diag_star: (n_test,) prior
    diagonal. mean_delta leaves out the mean function; var is the latent
    variance, floored at 1e-10, plus `noise` when given."""
    mean = K_star @ alpha
    v = blocked_solve_triangular(L, K_star.T)  # L^{-1} K_star^T
    var = torch.clamp(k_diag_star - torch.sum(v * v, dim=0), min=1e-10)
    if noise is not None:
        var = var + noise
    return mean, var


def posterior_cov_from_cache(K_star, K_star_star, L, noise=None):
    """Full latent posterior covariance K** - v^T v, v = L^{-1} K*^T,
    symmetrised, plus `noise` on the diagonal when given."""
    v = blocked_solve_triangular(L, K_star.T)
    cov = K_star_star - v.T @ v
    cov = 0.5 * (cov + cov.T)
    if noise is not None:
        cov = cov + noise * _eye(cov.shape[0], cov)
    return cov


def mvn_sample(mean, cov, num_samples: int, jitter: float = 1e-6,
               generator=None, eps=None):
    """(num_samples, n) draws from N(mean, cov) through the builtin Cholesky
    of cov + jitter I (NaN where it fails, as the JAX package's). The
    standard normals are `eps` (num_samples, n) when given, else drawn
    from `generator` (a torch.Generator on mean's device)."""
    n = mean.shape[0]
    L, info = torch.linalg.cholesky_ex(cov + jitter * _eye(n, cov))
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    if eps is None:
        eps = torch.randn(num_samples, n, generator=generator,
                          dtype=mean.dtype, device=mean.device)
    return mean[None, :] + eps @ L.T


def gaussian_nll(y_true, mean, var):
    """Average predictive negative log-likelihood (the runner's NLL column)."""
    return 0.5 * torch.mean(torch.log(2.0 * math.pi * var)
                            + (y_true - mean) ** 2 / var)
