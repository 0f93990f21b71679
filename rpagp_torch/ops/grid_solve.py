"""Exact grid-space (Woodbury) solver for the SKI path (port of
rpagp/ops/grid_solve.py; see its module docstring for the derivation).

    C          = noise I_p + G^T S G,   G = blockdiag(sqrt(scale_j) L_j)
    logdet A   = (n - p) log noise + logdet C
    y^T A^-1 y = from the anchored value cache (build_value_cache)

with S = U^T U the (p, p) cross-interpolation Gram (once per dataset)
and L_j = chol(T_j + eps_j I) per training step.

Kernels on this path: K1 (ops/cuda_chol.py) factors the J Toeplitz
blocks in `_chol_ladder` and the 512 diagonal leaves of the p x p factor
in `_chol_with_fallback_eps`; K2 / K3 (ops/cuda_interp.py) are the
interpolation passes of prepare and the posterior.

Product components (degree * sub_dim > 1, ops/ski_product.py) take the
same solver with per-component grid size M = m^F: their geometry has one
row per 1-D factor, their interpolation is ski_product's Khatri-Rao pair
(plain torch, in place of K2 / K3), and their ladder runs K1 on the
(J * F, m, m) factor Toeplitz blocks, whose Kronecker products are the
(J, M, M) factors. The dispatchers `_interp_T`, `_interp_A`,
`_build_geometry` and `_build_gram` choose between the two.

Each `jax.lax.cond` on a device flag of the JAX package is a Python `if`
on a device bool here: `_chol_ladder` and `_chol_with_fallback_eps` read
one flag each, so a training step makes two device->host reads when
neither ladder escalates. `stats` counts them, and keeps the levels the
last factor chose; `factor_diagnostics` reports them at given params.

Posteriors: `grid_posterior` (mean, variance), `grid_posterior_cov`
(full covariance) and `make_grid_predictor` (factor once, predict per
batch), each exact within the SKI model.
"""

from __future__ import annotations

import torch

from ..models import exact_gp
from ..models.exact_gp import ModelSpec
from ..utils.profiling import span
from . import ski, ski_product
from .block_chol import (blocked_cholesky, blocked_cholesky_safe,
                         blocked_solve_triangular)
from .cuda_chol import chol_linv_batched
from .exact import LOG_2PI
from .kernels import _component_scales, gram, gram_diag

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
    with span("rpagp.sync"):
        return bool(flag)


def use_grid_solver(spec: ModelSpec, n: int) -> bool:
    """Does this spec/size run the exact grid solver? "grid" forces it,
    "bbmm" keeps SKI + BBMM, "auto" takes it while p = J*m is at most
    min(n/2, _P_MAX). Product SKI specs always take it: SKI + BBMM has no
    product wiring, so solver="bbmm" raises, and past p = J*m^F > _P_MAX
    solver="grid" warns of the O(p^3) factor while "auto" raises."""
    kspec = spec.kernel
    if not kspec.ski:
        return False
    if ski_product.is_product(kspec):
        if spec.solver == "bbmm":
            raise ValueError(
                "solver='bbmm' does not support product (degree*sub_dim"
                " > 1) SKI kernels; use solver='grid'/'auto'")
        p = ski_product.grid_rank(kspec)
        if p > _P_MAX:
            if spec.solver != "grid":
                raise ValueError(
                    f"product-SKI grid rank p = J*m^F = {p} exceeds the "
                    f"grid solver budget ({_P_MAX}) and the BBMM path "
                    "has no product wiring: reduce grid_size (p scales "
                    "as m^F) or J, or force solver='grid' to accept the "
                    "O(p^3) factor")
            import warnings

            warnings.warn(
                f"product-SKI grid rank p = J*m^F = {p} exceeds the "
                f"auto-dispatch budget ({_P_MAX}); solver='grid' forces an "
                f"O(p^3) factor (~{8 * p * p / 2**30:.1f} GiB for the p x p "
                "Cholesky alone)", stacklevel=2)
        return True
    if spec.solver == "bbmm":
        return False
    p = kspec.J * kspec.grid_size
    if spec.solver == "grid":
        return True
    return p <= min(n // 2, _P_MAX)


def _interp_T(kspec, state, V):
    """Grid-space interpolation transpose, (n, t) -> (J, t, M): K2 for a
    degree-1 kernel, the Khatri-Rao rows for a product kernel."""
    if ski_product.is_product(kspec):
        return ski_product.interp_transpose(kspec, state, V)
    return ski.dense_interp_transpose(state, V)


def _interp_A(kspec, state, G):
    """Grid-space interpolation apply, (J, t, M) -> (n, t): K3 for a
    degree-1 kernel, the Khatri-Rao rows for a product kernel."""
    if ski_product.is_product(kspec):
        return ski_product.interp_apply_sum(kspec, state, G)
    return ski.dense_interp_apply_sum(state, G)


def _build_geometry(kspec, kp, kb, x, grid_size, z_bounds=None):
    """ski.build_ski, or ski.build_ski_factors for a product kernel."""
    if ski_product.is_product(kspec):
        return ski.build_ski_factors(kspec, kp, kb, x, grid_size,
                                     z_bounds=z_bounds)
    return ski.build_ski(kspec, kp, kb, x, grid_size, z_bounds=z_bounds)


def _build_gram(kspec, state):
    """S = U^T U, (J, M, J, M), for either kind of kernel."""
    if ski_product.is_product(kspec):
        return ski_product.build_interp_gram(kspec, state)
    return build_interp_gram(state)


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
    """(uy, u1) = (U^T y, U^T 1), each (J, M) — hyperparameter-free; one
    transpose of the two columns (each column's sums are those of a
    transpose of it alone)."""
    U = _interp_T(kspec, state, torch.stack([y, torch.ones_like(y)], dim=1))
    return U[:, 0].contiguous(), U[:, 1].contiguous()


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
    Vq0 = _interp_A(kspec, state, q0[:, None, :])[:, 0]
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


def _resid_iq(kspec, state, yc, U, Gw):
    """Inv-quad numerator yc^T (yc - Vw): value from the n-space residual,
    gradient from the grid-space linear form (uncached path)."""
    Vw = _interp_A(kspec, state, Gw.detach()[:, None, :])[:, 0]
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
    K1 keeps a failed block's outputs finite (its failure rule decouples a
    failed pivot), so the discarded fast factor is harmless to the
    gradient: a zero cotangent times a finite primal stays zero, at every
    block size. eps0: (J,) absolute base jitters. Returns (L, eps_used)."""
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
    """(G, t_jitter_mult): G (J, M, M) = sqrt(scale_j) chol(T_j + eps). A
    product component's T_j is the Kronecker product of its F factor
    Toeplitz blocks, so the ladder runs on the (J * F, m, m) factors and
    kron_fold assembles their Choleskys into the (M, M) factor."""
    kspec = spec.kernel
    if ski_product.is_product(kspec):
        T = ski_product.toeplitz_blocks_factors(kspec, kparams, state)
    else:
        T = _toeplitz_blocks(kspec, kparams, state)
    # relative jitter: scales with each block's diagonal k(0)
    eps0 = spec.grid_jitter * T[:, 0, 0]
    Lt, eps_t = _chol_ladder(T, eps0)
    if ski_product.is_product(kspec):
        F, m = ski_product.factors_per_component(kspec), state.m
        Lt = ski_product.kron_fold(Lt.reshape(kspec.J, F, m, m))
    scales = _component_scales(kspec, kparams)
    G = torch.sqrt(scales)[:, None, None] * Lt
    return G, eps_t / torch.clamp(eps0, min=1e-30)


def _factor_diag(spec: ModelSpec, kparams, state: ski.SKIState, S4, noise,
                 chol_fn=None):
    """(G, Lc, diag): the Toeplitz factors, the p x p factor of
    C = noise I + G^T S G, and the jitters the two ladders chose:
    diag["t_jitter_mult"] (J,) in units of the base grid jitter (1.0 = the
    base level), diag["c_jitter_over_noise"] () in units of noise (0.0 =
    exact). chol_fn(C, noise) -> (Lc, eps) replaces the p x p factor's
    ladder (the parallel path's row-banded one, parallel/dist_chol.py)."""
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
    Lc, eps_c = (chol_fn or _chol_with_fallback_eps)(C, noise)
    diag = {"t_jitter_mult": t_mult.detach(),
            "c_jitter_over_noise": (eps_c.detach()
                                    / torch.clamp(noise.detach(), min=1e-30))}
    return G, Lc, diag


def _factor(spec: ModelSpec, kparams, state: ski.SKIState, S4, noise,
            chol_fn=None):
    """(G, Lc) of _factor_diag; its diagnostics go to stats["t_levels"] /
    stats["c_level"]."""
    G, Lc, diag = _factor_diag(spec, kparams, state, S4, noise,
                               chol_fn=chol_fn)
    stats["t_levels"] = diag["t_jitter_mult"]
    stats["c_level"] = diag["c_jitter_over_noise"]
    return G, Lc


@torch.no_grad()
def factor_diagnostics(spec: ModelSpec, params, buffers):
    """Whether the solver left its exact level at these params: the largest
    T-ladder multiplier across blocks and the C-factor's level in units of
    noise, as floats, read from the ladders the factor of prepare_buffers'
    grid ran (no read beyond the ladders' own flags and these two). The
    ladders are silent by design during training; the runner reports
    this once a split."""
    noise = exact_gp.noise_value(params)
    _, _, diag = _factor_diag(spec, params["kernel"], buffers["ski_state"],
                              buffers["ski_uu"], noise)
    return {"t_jitter_mult_max": float(torch.max(diag["t_jitter_mult"])),
            "c_jitter_over_noise": float(diag["c_jitter_over_noise"])}


def _G_apply(G, z):
    """blockdiag(G) @ z for z (p,) -> (J, m) grid layout."""
    J, m, _ = G.shape
    return torch.einsum("jab,jb->ja", G, z.reshape(J, m))


def _Gt_apply(G, U):
    """blockdiag(G)^T @ u for U in (J, m) grid layout -> (p,)."""
    return torch.einsum("jab,ja->jb", G, U).reshape(-1)


def grid_mll(spec: ModelSpec, params, buffers, x, y):
    """EXACT marginal log-likelihood of the SKI model (total over n)."""
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
        U = _interp_T(spec.kernel, state, yc[:, None])[:, 0, :]
    b = _Gt_apply(G, U)
    w = torch.cholesky_solve(b[:, None], Lc)[:, 0]
    Gw = _G_apply(G, w)
    vc = buffers.get("ski_vc")
    if vc is not None and "ski_uy" in buffers:
        iq = _anchored_iq(spec, params, vc, U, Gw, n) / noise
    else:
        iq = _resid_iq(spec.kernel, state, yc, U, Gw) / noise
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
    st_train = _build_geometry(spec.kernel, params["kernel"],
                               buffers["kernel"], x_train,
                               spec.kernel.grid_size, z_bounds=z_bounds)
    S4 = _build_gram(spec.kernel, st_train)
    G, Lc = _factor(spec, params["kernel"], st_train, S4, noise)
    U = _interp_T(spec.kernel, st_train, yc[:, None])[:, 0, :]
    b = _Gt_apply(G, U)
    q = _G_apply(G, torch.cholesky_solve(b[:, None], Lc)[:, 0])
    return st_train, q, (G, Lc), noise


# test points a (c, p) block of the explained variance takes
_TEST_CHUNK = 8192


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


def _test_interp_rows(state_test: ski.SKIState, chunk_slice, kspec=None):
    """Dense W* rows for a contiguous test chunk: (c, p)."""
    if kspec is not None and ski_product.is_product(kspec):
        return ski_product.test_interp_rows(kspec, state_test, chunk_slice)
    tf = state_test.tfrac[:, chunk_slice]
    W = ski._cubic_kernel(tf[:, :, None] - state_test.cells)  # (J, c, m)
    J, c, m = W.shape
    return W.transpose(0, 1).reshape(c, J * m)


def _test_mean(spec: ModelSpec, params, buffers, bounds, q, x_test):
    """(st_test, mu): x_test's geometry on the grid of `bounds` and the
    posterior mean from the cache q (K3)."""
    kspec = spec.kernel
    st_test = _build_geometry(kspec, params["kernel"], buffers["kernel"],
                              x_test, kspec.grid_size, z_bounds=bounds)
    mu = _interp_A(kspec, st_test, q[:, None, :])[:, 0]
    return st_test, mu + exact_gp.mean_fn(spec, params, x_test)


def _test_var(spec: ModelSpec, params, buffers, st_test, factor, noise,
              x_test, observation_noise):
    """The predictive variance k** - explained, in blocks of _TEST_CHUNK
    test points, floored at 1e-10, plus noise if asked."""
    n_test = x_test.shape[0]
    kd = gram_diag(spec.kernel, params["kernel"], buffers["kernel"], x_test)
    explained = torch.cat([
        _explained_chunk(factor, noise, _test_interp_rows(
            st_test, slice(s, s + _TEST_CHUNK), spec.kernel))
        for s in range(0, n_test, _TEST_CHUNK)])
    var = torch.clamp(kd - explained, min=1e-10)
    return var + noise if observation_noise else var


@torch.no_grad()
def grid_posterior(spec: ModelSpec, params, buffers, x_train, y_train,
                   x_test, observation_noise: bool = True):
    """Posterior predictive (mean, var), exact within the SKI model, on a
    grid rebuilt over the union of train/test projection bounds."""
    bounds = ski.union_bounds(spec.kernel, params["kernel"],
                              buffers["kernel"], x_train, x_test)
    _, q, factor, noise = _posterior_factor(spec, params, buffers, x_train,
                                            y_train, bounds)
    st_test, mu = _test_mean(spec, params, buffers, bounds, q, x_test)
    return mu, _test_var(spec, params, buffers, st_test, factor, noise,
                         x_test, observation_noise)


@torch.no_grad()
def grid_posterior_cov(spec: ModelSpec, params, buffers, x_train, y_train,
                       x_test, observation_noise: bool = False):
    """Posterior (mean, full covariance), exact within the SKI model. The
    explained block extends _explained_chunk off the diagonal: with the
    test rows tp = U* blockdiag(G) (c, p) and s = Lc^-1 tp^T,

        cov = K** - (tp tp^T - noise s^T s),

    with (p, c) buffers only. K** is the exact Gram, so the diagonal is
    grid_posterior's variance to rounding. For modest test batches: the
    covariance is (n_test, n_test)."""
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    bounds = ski.union_bounds(kspec, kp, kb, x_train, x_test)
    _, q, (G, Lc), noise = _posterior_factor(spec, params, buffers, x_train,
                                             y_train, bounds)
    st_test, mu = _test_mean(spec, params, buffers, bounds, q, x_test)
    n_test = x_test.shape[0]
    J, m, _ = G.shape
    Ub = _test_interp_rows(st_test, slice(0, n_test), kspec).reshape(
        n_test, J, m)
    tp = torch.einsum("jab,cja->cjb", G, Ub).reshape(n_test, J * m)
    s = blocked_solve_triangular(Lc, tp.T)  # (p, c)
    K_ss = gram(kspec, kp, kb, x_test, x_test)
    cov = K_ss - (tp @ tp.T - noise * (s.T @ s))
    cov = 0.5 * (cov + cov.T)
    if observation_noise:
        cov = cov + noise * torch.eye(n_test, dtype=cov.dtype,
                                      device=cov.device)
    return mu, cov


@torch.no_grad()
def make_grid_predictor(spec: ModelSpec, params, buffers, x_train, y_train,
                        observation_noise: bool = True):
    """Cached predictor on the grid path: factor once on the train grid
    extended by ski.GRID_MARGIN x span on each side; then each test batch
    costs K3 (the mean) and one (c, p) product and solve (the variance).
    Test points beyond the margin get zero taps and so revert to the
    prior mean, with the prior variance."""
    bounds = ski.margin_bounds(spec.kernel, params["kernel"],
                               buffers["kernel"], x_train)
    _, q, factor, noise = _posterior_factor(spec, params, buffers, x_train,
                                            y_train, bounds)

    @torch.no_grad()
    def predict(x_test):
        st_test, mu = _test_mean(spec, params, buffers, bounds, q, x_test)
        return mu, _test_var(spec, params, buffers, st_test, factor, noise,
                             x_test, observation_noise)

    return predict
