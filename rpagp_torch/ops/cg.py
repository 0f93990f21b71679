"""BBMM-style batched preconditioned conjugate gradients (port of
rpagp/ops/cg.py).

One batched CG run solves A X = B for all right-hand sides at once (y
plus the probe vectors), and its (alpha, beta) recurrences give the
Lanczos tridiagonals that stochastic Lanczos quadrature turns into a
logdet estimate.

  batched_pcg       a fixed number of iterations; collects (alpha, beta)
                    per column. The MLL path: it reads nothing back to the
                    host, so the training step never waits on the device.
  batched_pcg_while stops at the first iteration where every column's
                    relative residual is <= tol; reads that flag once per
                    iteration. The posterior path (once per split).

Converged columns are frozen by a mask (alpha = beta = 0), and both
variants return the iterate with the smallest relative residual seen per
column: in f32 at condition numbers ~1e8 CG can diverge, and the best
iterate bounds the damage.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.profiling import annotate, span

_EPS = 1e-20


class CGResult(NamedTuple):
    solution: torch.Tensor  # (n, t)
    alphas: torch.Tensor  # (iters, t) CG step sizes
    betas: torch.Tensor  # (iters, t) CG direction updates
    residual_norm: torch.Tensor  # (t,) best relative residual norms
    iterations: torch.Tensor  # () iterations run


def _guard(v):
    return torch.where(torch.abs(v) < _EPS, torch.full_like(v, _EPS), v)


def _b_norm(B):
    b_norm = torch.linalg.norm(B, dim=0)
    return torch.where(b_norm < _EPS, torch.ones_like(b_norm), b_norm)


@annotate("rpagp.bbmm.cg")
def batched_pcg(A_mvm: Callable, B, M_inv: Optional[Callable] = None,
                max_iters: int = 100, tol: float = 1e-2) -> CGResult:
    """Batched PCG for exactly max_iters iterations; returns the best
    iterates and the (alpha, beta) of every iteration. tol only sets the
    convergence mask (frozen columns stop updating)."""
    if M_inv is None:
        M_inv = lambda r: r
    b_norm = _b_norm(B)
    X = torch.zeros_like(B)
    R = B
    Z = M_inv(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    resid = torch.ones(B.shape[1], dtype=B.dtype, device=B.device)
    X_best, r_best = X, resid
    alphas, betas = [], []
    for _ in range(max_iters):
        active = resid > tol
        V = A_mvm(P)  # the one kernel MVM of the iteration
        pv = torch.sum(P * V, dim=0)
        alpha = torch.where(active, rz / _guard(pv), torch.zeros_like(rz))
        X = X + alpha * P
        R = R - alpha * V
        Z = M_inv(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(active, rz_new / _guard(rz), torch.zeros_like(rz))
        P = Z + beta * P
        rz = rz_new
        resid = torch.linalg.norm(R, dim=0) / b_norm
        better = resid < r_best
        X_best = torch.where(better[None, :], X, X_best)
        r_best = torch.where(better, resid, r_best)
        alphas.append(alpha)
        betas.append(beta)
    empty = B.new_zeros(0, B.shape[1])
    return CGResult(
        solution=X_best,
        alphas=torch.stack(alphas) if alphas else empty,
        betas=torch.stack(betas) if betas else empty,
        residual_norm=r_best,
        iterations=torch.tensor(max_iters))


@annotate("rpagp.bbmm.cg")
def batched_pcg_while(A_mvm: Callable, B, M_inv: Optional[Callable] = None,
                      max_iters: int = 200, tol: float = 1e-2) -> CGResult:
    """Batched PCG that stops at the first iteration where every column's
    relative residual is <= tol (or at max_iters); no tridiagonals."""
    if M_inv is None:
        M_inv = lambda r: r
    b_norm = _b_norm(B)
    X = torch.zeros_like(B)
    R = B
    Z = M_inv(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    resid = torch.ones(B.shape[1], dtype=B.dtype, device=B.device)
    X_best, r_best = X, resid
    i = 0
    while i < max_iters:
        with span("rpagp.sync"):  # one host read per iteration: the flag
            if not bool(torch.max(resid) > tol):
                break
        V = A_mvm(P)
        pv = torch.sum(P * V, dim=0)
        alpha = rz / _guard(pv)
        X = X + alpha * P
        R = R - alpha * V
        Z = M_inv(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = rz_new / _guard(rz)
        P = Z + beta * P
        rz = rz_new
        resid = torch.linalg.norm(R, dim=0) / b_norm
        better = resid < r_best
        X_best = torch.where(better[None, :], X, X_best)
        r_best = torch.where(better, resid, r_best)
        i += 1
    empty = B.new_zeros(0, B.shape[1])
    return CGResult(solution=X_best, alphas=empty, betas=empty,
                    residual_norm=r_best, iterations=torch.tensor(i))


def lanczos_tridiags_from_cg(alphas, betas):
    """CG (alpha, beta) recurrences (m, t) -> the (t, m, m) symmetric
    Lanczos tridiagonals: diag_i = 1/alpha_i + beta_{i-1}/alpha_{i-1},
    offd_i = sqrt(beta_i)/alpha_i. Frozen iterations (alpha == 0) become
    decoupled unit eigenvalues (diag 1, offdiag 0), which carry no weight
    in e1^T f(T) e1."""
    m, t = alphas.shape
    frozen = alphas == 0.0
    safe_alpha = torch.where(frozen, torch.ones_like(alphas), alphas)
    inv_alpha = 1.0 / safe_alpha
    prev_frozen = torch.cat([torch.ones(1, t, dtype=torch.bool,
                                        device=alphas.device), frozen[:-1]])
    prev_ratio = torch.cat([alphas.new_zeros(1, t),
                            (betas / safe_alpha)[:-1]])
    prev_ratio = torch.where(prev_frozen, torch.zeros_like(prev_ratio),
                             prev_ratio)
    diag = torch.where(frozen, torch.ones_like(alphas), inv_alpha + prev_ratio)
    offd = torch.where(frozen[:-1] | frozen[1:],
                       alphas.new_zeros(()),
                       torch.sqrt(torch.clamp(betas[:-1], min=0.0))
                       * inv_alpha[:-1])  # (m-1, t)
    T = torch.diag_embed(diag.T)
    return T + torch.diag_embed(offd.T, 1) + torch.diag_embed(offd.T, -1)
