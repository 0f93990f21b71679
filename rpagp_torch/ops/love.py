"""LOVE cached predictive (co)variances from a Lanczos cache (port of
rpagp/ops/love.py; Pleiss et al. 2018).

Once after training, A = K + s^2 I ~= Q T Q^T from r Lanczos iterations
(Q (n, r) orthonormal, T (r, r) tridiagonal). Each test batch then costs
one cross-kernel MVM:

  var*(X*) ~= k**_diag - rowsum((K* Q) T^{-1} (K* Q)^T)

Lanczos runs with full reorthogonalization and restarts on breakdown.
The start vector is the centered y, the Krylov space CG explores for the
mean solve. With `rsum` (a psum over the data axis) `lanczos` runs on the
local rows of a row-sharded operator: the parallel path's sharded LOVE
(parallel/sharding.distributed_posterior).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .precond import cho_solve, cholesky_nan


class LoveCache(NamedTuple):
    Q: torch.Tensor  # (n, r) orthonormal Lanczos basis of A
    T_chol: torch.Tensor  # (r, r) Cholesky of the (SPD) tridiagonal T
    alpha: torch.Tensor  # (n,) mean cache A^{-1} y_c
    noise: torch.Tensor  # ()


@torch.no_grad()
def lanczos(A_mvm: Callable, v0, rank: int, fresh=None, rsum=None):
    """Lanczos tridiagonalization of the SPD operator A with full
    reorthogonalization and breakdown restarts; returns (Q (n, r), T (r, r)).

    On breakdown (beta < 1e-6: in f32 the Krylov space of a kernel matrix
    often exhausts before `rank` steps) the next direction restarts from
    row i of `fresh`, a (rank, n) table of normals, orthogonalized against
    the whole basis, and the connecting beta is 0. fresh=None draws the
    table from a generator of v0's device seeded 0 (the JAX package draws
    it from key 0; the streams differ, so tests pass the same table to
    both).

    Row-sharded mode: v0 holds this rank's rows of the start vector and
    A_mvm maps local rows to local rows; `rsum` (a psum over the data
    axis) reduces every row-space contraction (Q^T v, q . v, the norms),
    and `fresh` is this rank's (rank, n_local) columns of one global
    table, so every rank restarts alike. Q comes back row-local, T
    replicated."""
    n = v0.shape[0]
    if rsum is None:
        rsum, nrm = (lambda s: s), torch.linalg.norm
    else:
        nrm = lambda v: torch.sqrt(rsum(torch.sum(v * v)))
    q = v0 / nrm(v0)
    if fresh is None:
        gen = torch.Generator(device=v0.device).manual_seed(0)
        fresh = torch.randn(rank, n, generator=gen, dtype=v0.dtype,
                            device=v0.device)

    def orth(Q, v):
        v = v - Q @ rsum(Q.T @ v)
        return v - Q @ rsum(Q.T @ v)  # twice is enough (Parlett)

    Q = torch.zeros(n, rank, dtype=v0.dtype, device=v0.device)
    beta_prev = v0.new_zeros(())
    q_prev = torch.zeros_like(q)
    alphas, betas = [], []
    for i in range(rank):
        v = A_mvm(q[:, None])[:, 0]
        alpha = rsum(q @ v)
        v = v - alpha * q - beta_prev * q_prev
        Q[:, i] = q  # columns past i are still zero
        v = orth(Q, v)
        beta = nrm(v)
        broke = beta < 1e-6
        r = orth(Q, fresh[i])
        r = r / torch.clamp(nrm(r), min=1e-20)
        q_next = torch.where(broke, r,
                             v / torch.where(broke, torch.ones_like(beta), beta))
        beta_out = torch.where(broke, torch.zeros_like(beta), beta)
        q_prev, q, beta_prev = q, q_next, beta_out
        alphas.append(alpha)
        betas.append(beta_out)
    a, b = torch.stack(alphas), torch.stack(betas)
    T = torch.diag(a) + torch.diag(b[:-1], 1) + torch.diag(b[:-1], -1)
    return Q, T


@torch.no_grad()
def build_love_cache(A_mvm: Callable, y_centered, noise, rank: int,
                     alpha=None, fresh=None, rsum=None) -> LoveCache:
    """Lanczos cache plus mean cache; `alpha` (A^{-1} y_c) may come from
    the CG mean solve. fresh, rsum: see `lanczos` (row-sharded mode: Q
    and alpha come back row-local)."""
    Q, T = lanczos(A_mvm, y_centered, rank, fresh=fresh, rsum=rsum)
    # T is similar to A restricted to the Krylov space: SPD; jitter for f32
    T = T + 1e-6 * torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    T_chol = cholesky_nan(T)
    if alpha is None:
        # A^{-1} y ~= Q T^{-1} Q^T y (exact when Lanczos ran to grade)
        qty = Q.T @ y_centered
        if rsum is not None:
            qty = rsum(qty)
        alpha = Q @ cho_solve(T_chol, qty[:, None])[:, 0]
    return LoveCache(Q=Q, T_chol=T_chol, alpha=alpha, noise=noise)


def love_covariance(cache: LoveCache, K_star_Q, K_star_star):
    """Full latent posterior covariance of a test batch from the cache:
    K** - w^T w, w = T_chol^{-1} (K* Q)^T."""
    w = torch.linalg.solve_triangular(cache.T_chol, K_star_Q.T, upper=False)
    cov = K_star_star - w.T @ w
    return 0.5 * (cov + cov.T)


def love_variance(cache: LoveCache, K_star_Q, k_diag_star,
                  observation_noise: bool = True):
    """Predictive variance from the cache. K_star_Q (n_test, r) =
    K(x_test, x_train) @ Q, one cross-kernel MVM per test batch;
    k_diag_star (n_test,) the prior diagonal."""
    w = torch.linalg.solve_triangular(cache.T_chol, K_star_Q.T, upper=False)
    var = torch.clamp(k_diag_star - torch.sum(w * w, dim=0), min=1e-10)
    if observation_noise:
        var = var + cache.noise
    return var
