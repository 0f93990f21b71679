"""Stochastic Lanczos quadrature log-determinant (port of rpagp/ops/slq.py):

  logdet(A) ~= logdet(M) + (1/t) sum_i (z_i^T M^{-1} z_i) e1^T log(T_i) e1

with probes z_i ~ N(0, M), T_i the Lanczos tridiagonals of preconditioned
CG on A z = z_i, and M the pivoted-Cholesky preconditioner.
"""

from __future__ import annotations

import torch


def slq_logdet_from_tridiags(T, probe_sq_norms, precond_logdet=0.0,
                             eig_floor: float = 1e-10):
    """T (t, m, m) from cg.lanczos_tridiags_from_cg; probe_sq_norms (t,)
    the values z_i^T M^{-1} z_i; precond_logdet the exact logdet(M).
    One batched eigh on the device (cuSOLVER checks its convergence flag,
    which reads one value back to the host)."""
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=eig_floor)  # T is similar to an SPD matrix
    w = evecs[:, 0, :] ** 2  # e1 weight of each eigenpair, (t, m)
    quad = torch.sum(w * torch.log(evals), dim=-1)
    return precond_logdet + torch.mean(probe_sq_norms * quad)
