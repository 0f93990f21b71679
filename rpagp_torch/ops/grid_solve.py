"""Exact grid-space (Woodbury) solver for the degree-1 SKI path
(port of rpagp/ops/grid_solve.py; see its module docstring for the
derivation).

    C          = noise I_p + G^T S G,   G = blockdiag(sqrt(scale_j) L_j)
    logdet A   = (n - p) log noise + logdet C
    y^T A^-1 y = from the anchored value cache (build_value_cache)

with S = U^T U the (p, p) cross-interpolation Gram (once per dataset)
and L_j = chol(T_j + eps_j I) per training step.

Kernels on this path: K1 (ops/cuda_chol.py) factors the J Toeplitz
blocks in `_chol_ladder` and the 512 diagonal leaves of the p x p factor
in `_chol_with_fallback_eps`; K2 / K3 (ops/cuda_interp.py) are the
interpolation passes of prepare and the posterior.

Each `jax.lax.cond` on a device flag of the JAX package is a Python `if`
on a device bool here: `_chol_ladder` and `_chol_with_fallback_eps` read
one flag each, so a training step makes two device->host reads when
neither ladder escalates. `stats` counts them.

Product-SKI components are ROADMAP slice 9.
"""

from __future__ import annotations

import torch

from ..models import exact_gp
from ..models.exact_gp import ModelSpec
from . import ski
from .block_chol import (blocked_cholesky, blocked_cholesky_safe,
                         blocked_solve_triangular)
from .cuda_chol import chol_linv_batched
from .exact import LOG_2PI
from .kernels import _component_scales, gram_diag

# auto-dispatch cap on p = J*m (the JAX package's _P_MAX)
_P_MAX = 6144

# device->host reads of the ladders' flags, and how often each ladder left
# its base level; t_levels / c_levels keep the last chosen multipliers
stats = {"host_reads": 0, "t_escalations": 0, "c_escalations": 0,
         "t_levels": None, "c_level": 0.0}


def reset_stats():
    stats.update(host_reads=0, t_escalations=0, c_escalations=0,
                 t_levels=None, c_level=0.0)


def _host_bool(flag) -> bool:
    stats["host_reads"] += 1
    return bool(flag)


def _check_degree1(kspec):
    if any(d != 1 for d in kspec.degrees) or kspec.sub_dim != 1:
        raise NotImplementedError(
            "product (degree*sub_dim > 1) SKI components are ROADMAP "
            "slice 9; only degree-1 SKI is ported")


def use_grid_solver(spec: ModelSpec, n: int) -> bool:
    """Does this spec/size run the exact grid solver? (degree-1 policy)"""
    if not spec.kernel.ski:
        return False
    _check_degree1(spec.kernel)
    if spec.solver == "bbmm":
        return False
    p = spec.kernel.J * spec.kernel.grid_size
    if spec.solver == "grid":
        return True
    return p <= min(n // 2, _P_MAX)


def build_interp_gram(state: ski.SKIState, block: int = 8192):
    """S = U^T U for the stacked interpolation matrices — (J, m, J, m).
    Blockwise over n: each (J*m, block) slab of W goes through one GEMM."""
    J, n = state.tfrac.shape
    m = state.m
    S = torch.zeros(J * m, J * m, dtype=state.tfrac.dtype,
                    device=state.tfrac.device)
    for s in range(0, n, block):
        W = ski._cubic_kernel(state.tfrac[:, s:s + block, None] - state.cells)
        Wf = W.transpose(1, 2).reshape(J * m, -1)
        S += Wf @ Wf.T
    return S.reshape(J, m, J, m)


def build_interp_y(kspec, state: ski.SKIState, y):
    """(uy, u1) = (U^T y, U^T 1), each (J, m) — hyperparameter-free."""
    uy = ski.dense_interp_transpose(state, y[:, None])[:, 0, :]
    u1 = ski.dense_interp_transpose(state, torch.ones_like(y)[:, None])[:, 0, :]
    return uy, u1


def _cached_U(spec: ModelSpec, params, buffers):
    """U^T yc from the per-dataset cache, or None when not cached."""
    uy = buffers.get("ski_uy")
    if uy is None:
        return None
    if spec.mean == "constant":
        return uy - params["mean_const"] * buffers["ski_u1"]
    return uy


def _anchor_q0(S4, uy):
    """Ridge-LS anchor: (S + delta I) q0 = U^T y, (J, m); q0 = 0 if the
    factor fails."""
    J, M = uy.shape
    p = J * M
    S = S4.reshape(p, p)
    S = 0.5 * (S + S.T)
    delta = 1e-3 * (torch.trace(S) / p) + 1e-12
    eye = torch.eye(p, dtype=S.dtype, device=S.device)
    Ls, ok = blocked_cholesky_safe(S + delta * eye)
    q0 = torch.cholesky_solve(uy.reshape(p, 1), Ls)[:, 0]
    return torch.where(ok, q0, torch.zeros_like(q0)).reshape(J, M)


def build_value_cache(kspec, state, S4, y, uy):
    """Per-dataset anchor for the zero-n-pass MLL value: {"q0", "a0",
    "a1", "sy", "yy"} (see the JAX package's build_value_cache)."""
    q0 = _anchor_q0(S4, uy)
    Vq0 = ski.dense_interp_apply_sum(state, q0[:, None, :])[:, 0]
    r = y - Vq0
    return {"q0": q0, "a0": torch.dot(y, r), "a1": torch.sum(r),
            "sy": torch.sum(y), "yy": torch.dot(y, y)}


def _anchored_iq(spec: ModelSpec, params, vc, U, Gw, n):
    """Inv-quad numerator from the value cache: value = the anchored form,
    gradient = d(the linear form); the two agree in exact arithmetic."""
    mu = (params["mean_const"] if spec.mean == "constant"
          else torch.zeros((), dtype=Gw.dtype, device=Gw.device))
    lin = (vc["yy"] - 2.0 * mu * vc["sy"] + mu * mu * n) - torch.sum(U * Gw)
    val = (vc["a0"] - mu * (vc["a1"] + vc["sy"]) + mu * mu * n
           + torch.sum(U.detach() * (vc["q0"] - Gw).detach()))
    return lin + (val - lin).detach()


def _resid_iq(state, yc, U, Gw):
    """Inv-quad numerator yc^T (yc - Vw): value from the n-space residual,
    gradient from the grid-space linear form (uncached path)."""
    Vw = ski.dense_interp_apply_sum(state, Gw.detach()[:, None, :])[:, 0]
    ycd = yc.detach()
    val = torch.dot(ycd, ycd - Vw)
    lin = torch.dot(yc, yc) - torch.sum(U * Gw)
    return lin + (val - lin).detach()


def _toeplitz_blocks(kspec, kparams, state: ski.SKIState):
    """(J, m, m) full Toeplitz blocks from the first columns."""
    col = ski.toeplitz_columns(kspec, kparams, state)
    m = state.m
    ar = torch.arange(m, device=col.device)
    idx = torch.abs(ar[:, None] - ar[None, :])
    return col[:, idx]


# jitter-ladder multipliers (x sqrt(10) steps), as in the JAX package
_LADDER = (1.0, 3.162278, 10.0, 31.62278, 100.0, 1000.0)


def _chol_ladder_xla(T, eps0, eye):
    """The probe ladder: per-block minimal jitter chosen on detached values
    with cholesky_ex's info (early exit once every block factors), then one
    differentiable Cholesky at the chosen levels."""
    Ts = T.detach()
    chosen = eps0 * _LADDER[-1]
    done = torch.zeros(T.shape[0], dtype=torch.bool, device=T.device)
    for mult in _LADDER:
        e = eps0 * mult
        ok = torch.linalg.cholesky_ex(Ts + e[:, None, None] * eye).info == 0
        chosen = torch.where(ok & ~done, e, chosen)
        done = done | ok
        if _host_bool(done.all()):
            break
    L, info = torch.linalg.cholesky_ex(T + chosen[:, None, None] * eye)
    L = torch.where((info == 0)[:, None, None], L,
                    torch.full_like(L, float("nan")))
    return L, chosen


def _chol_ladder(T, eps0):
    """Per-block minimal-jitter batched Cholesky of T + eps I: one K1 call
    at the base jitter; only when a block fails does the probe ladder run.
    K1's finite primals make the discarded fast factor harmless to the
    gradient. eps0: (J,) absolute base jitters. Returns (L, eps_used)."""
    m = T.shape[-1]
    eye = torch.eye(m, dtype=T.dtype, device=T.device)
    eps0 = eps0.detach()
    L0, _, okf = chol_linv_batched(T + eps0[:, None, None] * eye)
    if _host_bool((okf > 0.5).all()):
        return L0, eps0
    stats["t_escalations"] += 1
    return _chol_ladder_xla(T, eps0, eye)


# C-chol fallback jitter, in units of noise (level 0 is exact)
_C_LEVELS = (0.0, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1)


def _chol_with_fallback_eps(C, noise):
    """Minimal-jitter chol(C + c*noise I); returns (L, eps_chosen). The
    fast path factors C itself with the finite-primal blocked factor; the
    escalation probes each level with the same blocked algorithm."""
    p = C.shape[-1]
    eye = torch.eye(p, dtype=C.dtype, device=C.device)
    L0, ok0 = blocked_cholesky_safe(C)
    if _host_bool(ok0):
        return L0, torch.zeros((), dtype=C.dtype, device=C.device)
    stats["c_escalations"] += 1
    Cs, ns = C.detach(), noise.detach()
    chosen = ns * _C_LEVELS[-1]
    with torch.no_grad():
        for level in _C_LEVELS[1:]:
            _, ok = blocked_cholesky_safe(Cs + ns * level * eye)
            if _host_bool(ok):
                chosen = ns * level
                break
    return blocked_cholesky(C + chosen * eye), chosen


def _grid_chol_G(spec: ModelSpec, kparams, state: ski.SKIState):
    """(G, t_jitter_mult): G (J, m, m) = sqrt(scale_j) chol(T_j + eps)."""
    T = _toeplitz_blocks(spec.kernel, kparams, state)
    # relative jitter: scales with each block's diagonal k(0)
    eps0 = spec.grid_jitter * T[:, 0, 0]
    Lt, eps_t = _chol_ladder(T, eps0)
    scales = _component_scales(spec.kernel, kparams)
    G = torch.sqrt(scales)[:, None, None] * Lt
    return G, eps_t / torch.clamp(eps0, min=1e-30)


def _factor(spec: ModelSpec, kparams, state: ski.SKIState, S4, noise):
    """(G, Lc): the Toeplitz factors and the p x p factor of
    C = noise I + G^T S G (the JAX package's _factor / _factor_diag);
    the jitters the two ladders chose, its diagnostics, go to
    stats["t_levels"] / stats["c_level"]."""
    G, t_mult = _grid_chol_G(spec, kparams, state)
    J, M = G.shape[0], G.shape[1]
    p = J * M
    # G^T S G as two J-batched GEMMs (blockdiag structure)
    S_j = S4.permute(2, 0, 1, 3).reshape(J, J * M, M)  # (j, i*m, n)
    SG_j = torch.bmm(S_j, G)  # (j, i*m, b)
    SG_i = SG_j.reshape(J, J, M, M).permute(1, 2, 0, 3).reshape(J, M, J * M)
    Sg = torch.bmm(G.transpose(1, 2), SG_i).reshape(p, p)
    Sg = 0.5 * (Sg + Sg.T)  # rounding hygiene: the leaf VJP needs symmetry
    C = Sg + noise * torch.eye(p, dtype=Sg.dtype, device=Sg.device)
    Lc, eps_c = _chol_with_fallback_eps(C, noise)
    stats["t_levels"] = t_mult.detach()
    stats["c_level"] = eps_c.detach() / torch.clamp(noise.detach(), min=1e-30)
    return G, Lc


def _G_apply(G, z):
    """blockdiag(G) @ z for z (p,) -> (J, m) grid layout."""
    J, m, _ = G.shape
    return torch.einsum("jab,jb->ja", G, z.reshape(J, m))


def _Gt_apply(G, U):
    """blockdiag(G)^T @ u for U in (J, m) grid layout -> (p,)."""
    return torch.einsum("jab,ja->jb", G, U).reshape(-1)


def grid_mll(spec: ModelSpec, params, buffers, x, y):
    """EXACT marginal log-likelihood of the SKI model (total over n)."""
    _check_degree1(spec.kernel)
    n = x.shape[0]
    state = buffers["ski_state"]
    S4 = buffers["ski_uu"]
    J, M = S4.shape[0], S4.shape[1]
    p = J * M
    noise = exact_gp.noise_value(params)
    yc = y - exact_gp.mean_fn(spec, params, x)

    G, Lc = _factor(spec, params["kernel"], state, S4, noise)
    U = _cached_U(spec, params, buffers)
    if U is None:
        U = ski.dense_interp_transpose(state, yc[:, None])[:, 0, :]
    b = _Gt_apply(G, U)
    w = torch.cholesky_solve(b[:, None], Lc)[:, 0]
    Gw = _G_apply(G, w)
    vc = buffers.get("ski_vc")
    if vc is not None and "ski_uy" in buffers:
        iq = _anchored_iq(spec, params, vc, U, Gw, n) / noise
    else:
        iq = _resid_iq(state, yc, U, Gw) / noise
    ld = (n - p) * torch.log(noise) + 2.0 * torch.sum(
        torch.log(torch.diagonal(Lc)))
    return -0.5 * (iq + ld + n * LOG_2PI)


def _posterior_factor(spec: ModelSpec, params, buffers, x_train, y_train,
                      z_bounds):
    """Geometry and S on the given grid bounds, the factor (G, Lc) and the
    mean-cache weights q = G C^-1 b (the DIRECT form: the residual route
    amplifies f32 cancellation by 1/noise)."""
    noise = exact_gp.noise_value(params)
    yc = y_train - exact_gp.mean_fn(spec, params, x_train)
    st_train = ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"],
                             x_train, spec.kernel.grid_size, z_bounds=z_bounds)
    S4 = build_interp_gram(st_train)
    G, Lc = _factor(spec, params["kernel"], st_train, S4, noise)
    U = ski.dense_interp_transpose(st_train, yc[:, None])[:, 0, :]
    b = _Gt_apply(G, U)
    q = _G_apply(G, torch.cholesky_solve(b[:, None], Lc)[:, 0])
    return st_train, q, (G, Lc), noise


def _explained_chunk(factor, noise, Uc):
    """u_i^T G (I - noise C^-1) G^T u_i for dense interp rows Uc (c, p),
    factored: |G^T u|^2 - noise |Lc^-1 G^T u|^2."""
    G, Lc = factor
    J, m, _ = G.shape
    c = Uc.shape[0]
    t = torch.einsum("jab,cja->cjb", G, Uc.reshape(c, J, m))
    tp = t.reshape(c, J * m)
    s = blocked_solve_triangular(Lc, tp.T)  # (p, c)
    return torch.sum(tp * tp, dim=1) - noise * torch.sum(s * s, dim=0)


def _test_interp_rows(state_test: ski.SKIState, chunk_slice):
    """Dense W* rows for a contiguous test chunk: (c, p)."""
    tf = state_test.tfrac[:, chunk_slice]
    W = ski._cubic_kernel(tf[:, :, None] - state_test.cells)  # (J, c, m)
    J, c, m = W.shape
    return W.transpose(0, 1).reshape(c, J * m)


@torch.no_grad()
def grid_posterior(spec: ModelSpec, params, buffers, x_train, y_train,
                   x_test, observation_noise: bool = True,
                   chunk: int = 8192):
    """Posterior predictive (mean, var), exact within the SKI model, on a
    grid rebuilt over the union of train/test projection bounds."""
    _check_degree1(spec.kernel)
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    z_tr = ski.project(kspec, kp, kb, x_train)
    z_te = ski.project(kspec, kp, kb, x_test)
    lo = torch.minimum(torch.amin(z_tr, dim=1), torch.amin(z_te, dim=1))
    hi = torch.maximum(torch.amax(z_tr, dim=1), torch.amax(z_te, dim=1))
    st_train, q, factor, noise = _posterior_factor(
        spec, params, buffers, x_train, y_train, (lo, hi))
    st_test = ski.build_ski(kspec, kp, kb, x_test, kspec.grid_size,
                            z_bounds=(lo, hi))
    n_test = x_test.shape[0]
    mu = ski.dense_interp_apply_sum(st_test, q[:, None, :])[:, 0]
    mu = mu + exact_gp.mean_fn(spec, params, x_test)
    kd = gram_diag(kspec, kp, kb, x_test)
    explained = torch.cat([
        _explained_chunk(factor, noise,
                         _test_interp_rows(st_test, slice(s, s + chunk)))
        for s in range(0, n_test, chunk)])
    var = torch.clamp(kd - explained, min=1e-10)
    if observation_noise:
        var = var + noise
    return mu, var
