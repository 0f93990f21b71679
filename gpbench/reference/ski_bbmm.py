"""Plain reference of the SKI + BBMM training loss the flagship spec states
with "solver": "bbmm" (GPyTorch's estimator, Gardner et al. 2018): the
same stochastic estimate of -mll / n and its probe-estimator gradient,
computed again from x, y, the projection and the probe normals, which
the benchmark's generator makes and hands the program:

    A = sum_j w_j W_j T_j W_j^T + noise I    (T_j the Toeplitz grid Gram)
    M = L L^T + noise I                      (rank-k pivoted Cholesky of
                                              the exact kernel K(x, x))
    probes Z = L e_small + sqrt(noise) e_big, one batched PCG of
    cg_max_iters iterations on [y - mean | Z] keeping each column's best
    iterate; inv_quad = y_c . alpha; logdet by SLQ from the CG
    coefficients; gradient: -alpha^T dA alpha + 2 alpha^T dy_c and
    (1/t) sum_i s_i^T dA M^-1 z_i, with alpha, s_i, M^-1 z_i held fixed.

W is a sparse (n, J m) matrix of the cubic taps (torch.sparse, built
once); T_j products are dense (m, m) matmuls. Everything runs in `dtype`
(float64 for the reference). It imports nothing of the program.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from gpbench.reference import common

_PIVOT_JITTER = 1e-8
_GUARD = 1e-20
_EIG_FLOOR = 1e-10
_ROWS = 65536


class Operator:
    """The SKI geometry of x on its own grid, W as a sparse matrix, and
    the projected coordinates (for the preconditioner's exact rows)."""

    def __init__(self, x, proj, m: int, dtype):
        self.z = common.project(x, proj, dtype)  # (n, J)
        self.glo, self.h = common.grid(self.z.amin(0), self.z.amax(0), m)
        n, J = self.z.shape
        self.n, self.J, self.m, self.dtype = n, J, m, dtype
        self.t = (self.z - self.glo) / self.h  # (n, J) grid coordinates
        rows, cols, vals = [], [], []
        for s in range(0, n, _ROWS):
            t = self.t[s:s + _ROWS]
            c = torch.floor(t)[..., None] + torch.arange(-1, 3,
                                                         device=t.device)
            w = common.cubic(t[..., None] - c)
            keep = (c >= 0) & (c < m) & (w != 0)
            idx = (torch.arange(J, device=t.device)[:, None] * m
                   + c.clamp(0, m - 1).long())
            r = torch.arange(s, s + t.shape[0],
                             device=t.device)[:, None, None].expand_as(c)
            rows.append(r[keep])
            cols.append(idx[keep])
            vals.append(w[keep])
        with warnings.catch_warnings():  # torch's "sparse CSR is beta"
            warnings.simplefilter("ignore", UserWarning)
            W = torch.sparse_coo_tensor(
                torch.stack([torch.cat(rows), torch.cat(cols)]),
                torch.cat(vals), (n, J * m)).coalesce()
            self.W = W.to_sparse_csr()
            self.WT = W.t().coalesce().to_sparse_csr()

    def wt(self, V):
        """W^T V: (n, t) -> (J, m, t)."""
        return (self.WT @ V).reshape(self.J, self.m, -1)

    def toeplitz(self, ls):
        cells = torch.arange(self.m, dtype=ls.dtype, device=ls.device)
        col = torch.exp(-0.5 * (cells[None, :] * self.h[:, None]
                                / ls[:, None]) ** 2)
        return col[:, (cells[:, None] - cells[None, :]).abs().long()]

    def kernel_mvm(self, params, V):
        """K_SKI V = sum_j w_j W_j T_j W_j^T V at raw hyperparameters
        `params` (values only): (n, t)."""
        ls, scale, _ = _hypers(params, self.J)
        TU = torch.bmm(self.toeplitz(ls), self.wt(V)) * scale[:, None, None]
        return self.W @ TU.reshape(self.J * self.m, -1)

    def mvm(self, params, V):
        """A V = K_SKI V + noise V."""
        return self.kernel_mvm(params, V) + _hypers(params, self.J)[2] * V

    def kernel_rows(self, params, idx):
        """Exact kernel rows K(x[idx], x): (len(idx), n)."""
        ls, scale, _ = _hypers(params, self.J)
        u = self.z / ls
        d = u[idx][:, None, :] - u[None, :, :]
        return torch.einsum("j,inj->in", scale, torch.exp(-0.5 * d * d))


def _hypers(params, J):
    ls = F.softplus(params["raw_lengthscale"])
    scale = F.softplus(params["raw_outputscale"]).expand(J) / J
    noise = F.softplus(params["raw_noise"]) + common.NOISE_FLOOR
    return ls, scale, noise


def preconditioner(op: Operator, params, rank: int):
    """(L (n, k), noise, chol(noise I_k + L^T L), logdet M): the greedy
    pivoted Cholesky of the exact kernel, the first pivot of the largest
    residual diagonal on ties."""
    _, scale, noise = _hypers(params, op.J)
    d = torch.full((op.n,), float(scale.sum()), dtype=op.dtype,
                   device=op.z.device)
    L = torch.zeros(op.n, rank, dtype=op.dtype, device=op.z.device)
    for i in range(rank):
        p = torch.argmax(d).reshape(1)
        row = op.kernel_rows(params, p)[0] - L @ L[p][0]
        dp = torch.clamp(d[p], min=_PIVOT_JITTER)
        li = row / torch.sqrt(dp)
        li[p] = torch.sqrt(dp)
        d = torch.clamp(d - li * li, min=0.0)
        d[p] = 0.0
        L[:, i] = li
    small = noise * torch.eye(rank, dtype=op.dtype, device=L.device) + L.T @ L
    Cs = torch.linalg.cholesky(small)
    logdet = (2.0 * torch.log(torch.diagonal(Cs)).sum()
              - rank * torch.log(noise) + op.n * torch.log(noise))
    return L, noise, Cs, logdet


def _m_inv(pre, R):
    L, noise, Cs, _ = pre
    return (R - L @ torch.cholesky_solve(L.T @ R, Cs)) / noise


def _guard(v):
    return torch.where(v.abs() < _GUARD, torch.full_like(v, _GUARD), v)


def pcg(op, params, B, pre, iters: int, tol: float):
    """Batched PCG for exactly `iters` iterations: (best iterates, the
    (alpha, beta) of every iteration)."""
    b_norm = torch.linalg.norm(B, dim=0)
    b_norm = torch.where(b_norm < _GUARD, torch.ones_like(b_norm), b_norm)
    X = torch.zeros_like(B)
    R = B
    Z = _m_inv(pre, R)
    P = Z
    rz = (R * Z).sum(0)
    resid = torch.ones(B.shape[1], dtype=B.dtype, device=B.device)
    X_best, r_best = X, resid
    alphas, betas = [], []
    for _ in range(iters):
        active = resid > tol
        V = op.mvm(params, P)
        alpha = torch.where(active, rz / _guard((P * V).sum(0)),
                            torch.zeros_like(rz))
        X = X + alpha * P
        R = R - alpha * V
        Z = _m_inv(pre, R)
        rz_new = (R * Z).sum(0)
        beta = torch.where(active, rz_new / _guard(rz), torch.zeros_like(rz))
        P = Z + beta * P
        rz = rz_new
        resid = torch.linalg.norm(R, dim=0) / b_norm
        better = resid < r_best
        X_best = torch.where(better[None, :], X, X_best)
        r_best = torch.where(better, resid, r_best)
        alphas.append(alpha)
        betas.append(beta)
    return X_best, torch.stack(alphas), torch.stack(betas)


def slq_logdet(alphas, betas, probe_sq, pre_logdet):
    """logdet(M) + mean_i z_i^T M^-1 z_i e1^T log(T_i) e1, T_i the Lanczos
    tridiagonals of the CG coefficients (a frozen iteration, alpha = 0,
    a decoupled unit eigenvalue)."""
    m, t = alphas.shape
    frozen = alphas == 0.0
    a = torch.where(frozen, torch.ones_like(alphas), alphas)
    inv_a = 1.0 / a
    prev_frozen = torch.cat([torch.ones(1, t, dtype=torch.bool,
                                        device=a.device), frozen[:-1]])
    prev = torch.cat([a.new_zeros(1, t), (betas / a)[:-1]])
    prev = torch.where(prev_frozen, torch.zeros_like(prev), prev)
    diag = torch.where(frozen, torch.ones_like(a), inv_a + prev)
    offd = torch.where(frozen[:-1] | frozen[1:], a.new_zeros(()),
                       torch.sqrt(torch.clamp(betas[:-1], min=0.0))
                       * inv_a[:-1])
    T = (torch.diag_embed(diag.T) + torch.diag_embed(offd.T, 1)
         + torch.diag_embed(offd.T, -1))
    evals, evecs = torch.linalg.eigh(T)
    quad = (evecs[:, 0, :] ** 2 * torch.log(
        torch.clamp(evals, min=_EIG_FLOOR))).sum(-1)
    return pre_logdet + torch.mean(probe_sq * quad)


def loss_and_grad(op, params, y, eps_small, eps_big, rank: int, iters: int,
                  tol: float):
    """(the estimate of -mll / n, {name: its probe-estimator gradient})."""
    p = {k: v.detach() for k, v in params.items()}
    n = op.n
    with torch.no_grad():
        _, _, noise = _hypers(p, op.J)
        yc = y.to(op.dtype) - p["mean_const"]
        pre = preconditioner(op, p, rank)
        Z = pre[0] @ eps_small.to(op.dtype) + torch.sqrt(pre[1]) * \
            eps_big.to(op.dtype)
        X, alphas, betas = pcg(op, p, torch.cat([yc[:, None], Z], 1), pre,
                               iters, tol)
        alpha, S = X[:, 0], X[:, 1:]
        MZ = _m_inv(pre, Z)
        logdet = slq_logdet(alphas[:, 1:], betas[:, 1:], (Z * MZ).sum(0),
                            pre[3])
        loss = 0.5 * (yc @ alpha + logdet + n * common.LOG_2PI) / n
        ua, us, um = op.wt(alpha[:, None]), op.wt(S), op.wt(MZ)
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ls, scale, noise_q = _hypers(q, op.J)
    T = op.toeplitz(ls) * scale[:, None, None]
    quad = -((ua * torch.bmm(T, ua)).sum() + noise_q * (alpha @ alpha)) \
        + 2.0 * (alpha @ (y.to(op.dtype) - q["mean_const"]))
    t = S.shape[1]
    tr = ((us * torch.bmm(T, um)).sum() + noise_q * (S * MZ).sum()) / t
    grads = torch.autograd.grad(0.5 * (quad + tr) / n, list(q.values()))
    return loss, dict(zip(q, grads))


def probe_normals(seed: int, n: int, rank: int, probes: int, steps: int,
                  device):
    """The (e_small, e_big) of each of the first `steps` steps: float32
    normals drawn in order from a generator on `device` seeded with
    `seed`, as the training loss draws them."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(steps):
        es = torch.randn(rank, probes, generator=g, device=device)
        eb = torch.randn(n, probes, generator=g, device=device)
        out.append((es, eb))
    return out
