"""Rank-k pivoted-Cholesky preconditioner and its Woodbury application
(port of rpagp/ops/precond.py).

M = L_k L_k^T + noise I, with L_k a greedy rank-k partial pivoted
Cholesky of K(x, x) built from k row evaluations of the Gram (K is never
formed). M^{-1} r = (r - L (noise I_k + L^T L)^{-1} L^T r) / noise through
a k x k Cholesky, and logdet(M) by the matrix determinant lemma, both
exact.

Nothing here reads a value back to the host: the pivot is an index
tensor on the device (index_select / index_copy_, never .item()), and
the k x k factor is cholesky_ex (no error check, so no sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import annotate
from . import kernels
from .kernels import KernelSpec

_PIVOT_JITTER = 1e-8  # floor of the pivot's residual (rpagp/ops/precond.py:41)


class Preconditioner(NamedTuple):
    """Rank-k pivoted-Cholesky preconditioner M = L L^T + noise I."""

    L: torch.Tensor  # (n, k) partial Cholesky factor
    noise: torch.Tensor  # () likelihood noise
    chol_small: torch.Tensor  # (k, k) chol(noise I_k + L^T L), lower
    logdet: torch.Tensor  # () logdet(M), exact


@torch.no_grad()
def pivoted_cholesky(spec: KernelSpec, kparams, kbuffers, x, rank: int):
    """Greedy rank-`rank` pivoted Cholesky of K(x, x): L (n, rank) with
    K ~= L L^T. The pivot is the argmax of the residual diagonal (the
    first one on ties), the pivot row of K one (1, n) Gram evaluation."""
    n = x.shape[0]
    d = kernels.gram_diag(spec, kparams, kbuffers, x)
    L = torch.zeros(n, rank, dtype=x.dtype, device=x.device)
    for i in range(rank):
        p = torch.argmax(d).reshape(1)
        row = kernels.gram(spec, kparams, kbuffers, x.index_select(0, p), x)[0]
        # Schur complement against the columns built so far (the others
        # are still zero)
        row = row - L @ L.index_select(0, p)[0]
        dp = torch.clamp(d.index_select(0, p), min=_PIVOT_JITTER)
        li = row / torch.sqrt(dp)
        li.index_copy_(0, p, torch.sqrt(dp))  # exact at the pivot
        d = torch.clamp(d - li * li, min=0.0)
        d.index_fill_(0, p, 0.0)
        L[:, i] = li
    return L


def cho_solve(C, B):
    """(C C^T)^{-1} B for a lower Cholesky factor C: two triangular solves
    (cuBLAS trsm: no error flag to read back)."""
    Y = torch.linalg.solve_triangular(C, B, upper=False)
    return torch.linalg.solve_triangular(C.mT, Y, upper=True)


def cholesky_nan(A):
    """Lower Cholesky factor of A, NaN where A is not positive definite
    (what jax.lax.linalg.cholesky returns); never syncs."""
    C, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, C, torch.full_like(C, float("nan")))


@torch.no_grad()
@annotate("rpagp.precond.build")
def build_preconditioner(spec: KernelSpec, kparams, kbuffers, x, noise,
                         rank: int) -> Preconditioner:
    """Pivoted Cholesky plus the k x k factor of the Woodbury system."""
    n = x.shape[0]
    L = pivoted_cholesky(spec, kparams, kbuffers, x, rank)
    k = L.shape[1]
    small = noise * torch.eye(k, dtype=L.dtype, device=L.device) + L.T @ L
    C = cholesky_nan(small)
    # logdet(L L^T + noise I_n) = logdet(noise I_k + L^T L) + (n - k) log noise
    logdet = (2.0 * torch.sum(torch.log(torch.diagonal(C)))
              - k * torch.log(noise) + n * torch.log(noise))
    return Preconditioner(L=L, noise=noise, chol_small=C, logdet=logdet)


@annotate("rpagp.precond.apply")
def apply_inverse(pre: Preconditioner, R):
    """M^{-1} R for R (n, t), Woodbury through the k x k Cholesky."""
    w = cho_solve(pre.chol_small, pre.L.T @ R)
    return (R - pre.L @ w) / pre.noise
