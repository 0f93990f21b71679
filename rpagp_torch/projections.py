"""Random projections (port of rpagp/projections.py).

Drawn from an explicit `torch.Generator`; the stream differs from the
JAX package's threefry stream, so tests hand both packages the same
numpy projection instead of the same seed, and hold a draw here to its
distribution and shape.
"""

from __future__ import annotations

import math

import torch

DISTRIBUTIONS = ("gaussian", "sphere", "rademacher", "bernoulli", "uniform",
                 "axes")


def gen_rp(D: int, M: int, dist: str = "gaussian", generator=None):
    """(D, M) float32 projection matrix on the CPU; its columns are the 1-D
    projections, x @ P the projected coordinates.

    gaussian   i.i.d. N(0, 1/D) entries;
    sphere     columns uniform on the unit sphere S^{D-1};
    rademacher +-1/sqrt(D) (bernoulli is the same);
    uniform    U(-sqrt(3/D), sqrt(3/D)) (unit expected column norm);
    axes       the standard basis vectors e_{j mod D}, deterministic (the
               axis-aligned additive GP); the generator is not used.
    """
    if dist not in DISTRIBUTIONS:
        raise ValueError(f"unknown projection distribution {dist!r}; one of "
                         f"{DISTRIBUTIONS}")
    if dist == "axes":
        return torch.eye(D)[:, torch.arange(M) % D]
    if dist == "gaussian":
        return torch.randn(D, M, generator=generator) / math.sqrt(D)
    if dist == "sphere":
        g = torch.randn(D, M, generator=generator)
        return g / torch.linalg.norm(g, dim=0, keepdim=True)
    if dist in ("rademacher", "bernoulli"):
        r = 2.0 * torch.randint(0, 2, (D, M), generator=generator) - 1.0
        return r / math.sqrt(D)
    lim = math.sqrt(3.0 / D)
    return (2.0 * torch.rand(D, M, generator=generator) - 1.0) * lim


def _coherence(Q):
    """sum_{i != j} (q_i . q_j)^2 over the columns of Q."""
    G = Q.T @ Q
    off = G - torch.diag_embed(torch.diagonal(G))
    return torch.sum(off ** 2)


def space_equally(P, lr: float = 0.1, niter: int = 500):
    """Push the projection directions apart: `niter` steps of gradient
    descent (by autograd) on the pairwise coherence over unit-norm
    columns, renormalising after each step; a fixed count, no convergence
    test. Returns (P_spaced, final coherence loss)."""
    norm = lambda Q: Q / torch.linalg.norm(Q, dim=0, keepdim=True)
    Q = norm(torch.as_tensor(P).detach())
    with torch.enable_grad():
        for _ in range(niter):
            Q.requires_grad_(True)
            (g,) = torch.autograd.grad(_coherence(Q), Q)
            Q = norm(Q.detach() - lr * g)
    return Q, _coherence(Q)
