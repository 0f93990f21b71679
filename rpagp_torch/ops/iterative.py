"""Iterative (large-n) marginal log-likelihood and posterior: the BBMM path
(port of rpagp/ops/iterative.py).

Forward: one batched preconditioned CG on [y_centered | probes] gives the
inverse-quadratic solve and the Lanczos tridiagonals; SLQ turns those
into the logdet estimate. Backward: a torch.autograd.Function whose
gradient is the probe-based trace estimator, never reverse mode through
the CG iterations:

  d/dθ  y^T A^{-1} y = -α^T (dA/dθ) α + 2 α^T d(y_c)/dθ,   α = A^{-1} y_c
  d/dθ  logdet A    ~= (1/t) Σ_i s_i^T (dA/dθ) m_i,
        s_i = A^{-1} z_i,  m_i = M^{-1} z_i,  z_i ~ N(0, M)

Both are gradients of quadratic forms u^T A(θ) v with u, v constant, taken
through one kernel MVM: K4 forward and K5 backward on the card, or under
SKI the W T W^T operator (K2, the Toeplitz FFT product, K3; its backward
K2 again). The preconditioner is excluded from gradients: it changes the
estimator's variance, not its mean. With spec.precond_refresh > 1 it
comes from buffers["precond_cache"] once the trainer has refreshed it
(models/exact_gp.refresh_preconditioner).
"""

from __future__ import annotations

import torch

from ..models import exact_gp
from ..models.exact_gp import ModelSpec
from ..utils.profiling import annotate, span
from . import cg as cg_mod
from . import kernels, love, precond, ski, slq
from .exact import LOG_2PI

# the chunked-CG variance: test points per batched solve and its CG
# tolerance (rpagp/ops/iterative.py:213-214)
_VAR_CHUNK = 256
_VAR_TOL = 1e-2


def _kernel_mvm(spec: ModelSpec, params, buffers, x1, x2, V, states=None,
                allow_pallas: bool = False):
    """K(x1, x2) @ V: the SKI operator W T W'^T (K2, FFT, K3) when the
    spec asks for SKI and `states` = (x1's geometry, x2's) is given, else
    the blocked kernel MVM (K4/K5 on the card where allow_pallas)."""
    if spec.kernel.ski and states is not None:
        st1, st2 = states
        return ski.ski_mvm(spec.kernel, params["kernel"], st1, V,
                           state_rhs=st2)
    return kernels.mvm(spec.kernel, params["kernel"], buffers["kernel"], x1,
                       x2, V, block_rows=spec.mvm_block_rows,
                       allow_pallas=allow_pallas)


def _ski_state(spec: ModelSpec, params, buffers, x, z_bounds=None,
               use_cache: bool = False):
    """SKI geometry of x (hyperparameter-free), or None without SKI.
    use_cache: take buffers["ski_state"] from prepare_buffers when there
    is one."""
    if not spec.kernel.ski:
        return None
    if use_cache and buffers.get("ski_state") is not None:
        return buffers["ski_state"]
    return ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"], x,
                         spec.kernel.grid_size, z_bounds=z_bounds)


def _make_A_mvm(spec: ModelSpec, params, buffers, x, noise, state=None):
    """A = K(x, x) + noise I as an MVM closure (SKI when `state`)."""
    states = None if state is None else (state, state)

    def A_mvm(V):
        with span("rpagp.bbmm.operator"):
            return _kernel_mvm(spec, params, buffers, x, x, V, states=states,
                               allow_pallas=True) + noise * V

    return A_mvm


def _build_pre(spec: ModelSpec, params, buffers, x, noise):
    """Preconditioner at detached params (a value-only object)."""
    kp = {k: v.detach() for k, v in params["kernel"].items()}
    return precond.build_preconditioner(spec.kernel, kp, buffers["kernel"], x,
                                        noise.detach(), spec.precond_rank)


def _leaves(params):
    """(sorted key paths, tensors) of a dict tree of params."""
    paths, leaves = [], []
    for k in sorted(params):
        if isinstance(params[k], dict):
            for p, t in zip(*_leaves(params[k])):
                paths.append((k,) + p)
                leaves.append(t)
        else:
            paths.append((k,))
            leaves.append(params[k])
    return paths, leaves


def _tree(paths, leaves):
    out = {}
    for path, t in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    return out


def _fwd_impl(spec, params, buffers, x, y, eps_small, eps_big):
    n = x.shape[0]
    noise = exact_gp.noise_value(params)
    yc = y - exact_gp.mean_fn(spec, params, x)
    state = _ski_state(spec, params, buffers, x, use_cache=True)
    A_mvm = _make_A_mvm(spec, params, buffers, x, noise, state=state)
    # probes z ~ N(0, M) from the pre-drawn normals
    if spec.precond_rank > 0:
        cache = buffers.get("precond_cache")
        if spec.precond_refresh > 1 and cache is not None:
            # the stale-but-consistent preconditioner the trainer refreshes
            # every spec.precond_refresh steps (refresh_preconditioner)
            pre = cache
        else:
            pre = _build_pre(spec, params, buffers, x, noise)
        M_inv = lambda R: precond.apply_inverse(pre, R)
        # pre.noise, not the live noise: M = L L^T + pre.noise I is one
        # operator across probes, M_inv and logdet(M)
        Z = pre.L @ eps_small + torch.sqrt(pre.noise) * eps_big
        pre_logdet = pre.logdet
    else:
        nsg = noise.detach()
        M_inv = lambda R: R / nsg
        Z = torch.sqrt(nsg) * eps_big
        pre_logdet = n * torch.log(nsg)
    B = torch.cat([yc[:, None], Z], dim=1)
    res = cg_mod.batched_pcg(A_mvm, B, M_inv, max_iters=spec.cg_max_iters,
                             tol=spec.cg_tol)
    alpha = res.solution[:, 0]
    S = res.solution[:, 1:]  # probe solves A^{-1} z_i
    MZ = M_inv(Z)  # m_i = M^{-1} z_i
    inv_quad = yc @ alpha
    with span("rpagp.bbmm.slq"):
        T = cg_mod.lanczos_tridiags_from_cg(res.alphas[:, 1:],
                                            res.betas[:, 1:])
        logdet = slq.slq_logdet_from_tridiags(T, torch.sum(Z * MZ, dim=0),
                                              pre_logdet)
    return inv_quad, logdet, alpha, S, MZ, res, state


class _InvQuadLogdet(torch.autograd.Function):
    """(params leaves..., y) -> (inv_quad, logdet) with the probe-estimator
    backward. Non-tensor context (spec, key paths, buffers, x, eps) rides
    in `ctx`; `stats`, when a dict, receives the forward's CGResult."""

    @staticmethod
    def forward(ctx, spec, paths, buffers, x, eps_small, eps_big, stats, y,
                *leaves):
        with torch.no_grad():
            params = _tree(paths, leaves)
            iq, ld, alpha, S, MZ, res, state = _fwd_impl(
                spec, params, buffers, x, y, eps_small, eps_big)
        if stats is not None:
            stats["cg"] = res
        ctx.spec, ctx.paths, ctx.buffers, ctx.x = spec, paths, buffers, x
        # the SKI geometry (None without SKI): hyperparameter-free, so
        # the backward reuses it and never differentiates it
        ctx.states = None if state is None else (state, state)
        ctx.save_for_backward(alpha, S, MZ, y, *leaves)
        return iq, ld

    @staticmethod
    @annotate("rpagp.bbmm.backward")
    def backward(ctx, g_iq, g_ld):
        alpha, S, MZ, y, *leaves = ctx.saved_tensors
        spec, x = ctx.spec, ctx.x
        t = S.shape[1]
        p_leaves = [l.detach().requires_grad_(True) for l in leaves]
        yy = y.detach().requires_grad_(True)
        V = torch.cat([alpha[:, None], MZ], dim=1)
        with torch.enable_grad():
            p = _tree(ctx.paths, p_leaves)
            noise = exact_gp.noise_value(p)
            yc = yy - exact_gp.mean_fn(spec, p, x)
            # one batched MVM for both heads
            K_AM = _kernel_mvm(spec, p, ctx.buffers, x, x, V,
                               states=ctx.states, allow_pallas=True)
            Ka, KM = K_AM[:, 0], K_AM[:, 1:]
            # inverse-quadratic total derivative: -α^T A α + 2 α^T y_c
            quad_y = -(alpha @ Ka + noise * (alpha @ alpha)) + 2.0 * (alpha @ yc)
            # logdet trace estimator: (1/t) Σ s_i^T A m_i
            tr = (torch.sum(S * KM) + noise * torch.sum(S * MZ)) / t
            h = g_iq * quad_y + g_ld * tr
        grads = torch.autograd.grad(h, [yy] + p_leaves, allow_unused=True)
        return (None,) * 7 + tuple(grads)


def inv_quad_logdet_eps(spec: ModelSpec, params, buffers, x, y, eps_small,
                        eps_big, stats=None):
    """(y_c^T A^{-1} y_c, logdet A) with estimator-defined gradients, from
    given probe normals eps_small (rank, t) and eps_big (n, t): the JAX
    package's `_make_inv_quad_logdet(spec)(params, buffers, x, y,
    eps_small, eps_big)`."""
    paths, leaves = _leaves(params)
    return _InvQuadLogdet.apply(spec, paths, buffers, x, eps_small, eps_big,
                                stats, y, *leaves)


def inv_quad_logdet(spec: ModelSpec, params, buffers, x, y, generator=None):
    """(y_c^T A^{-1} y_c, logdet A) with probes drawn on x's device from
    `generator` (a torch.Generator of that device; seed 0 when None)."""
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    rank = max(spec.precond_rank, 0)
    eps_small = torch.randn(rank, spec.num_probes, generator=generator,
                            dtype=x.dtype, device=x.device)
    eps_big = torch.randn(x.shape[0], spec.num_probes, generator=generator,
                          dtype=x.dtype, device=x.device)
    return inv_quad_logdet_eps(spec, params, buffers, x, y, eps_small,
                               eps_big)


def iterative_mll(spec: ModelSpec, params, buffers, x, y, generator=None):
    """Large-n marginal log-likelihood by BBMM CG + SLQ."""
    n = x.shape[0]
    iq, ld = inv_quad_logdet(spec, params, buffers, x, y, generator)
    return -0.5 * (iq + ld + n * LOG_2PI)


def _union_states(spec: ModelSpec, params, buffers, x_train, x_test):
    """(train, test) SKI geometries on one grid over both projections, so
    that the cross-covariance W_test T W_train^T is consistent; (None,
    None) without SKI."""
    if not spec.kernel.ski:
        return None, None
    bounds = ski.union_bounds(spec.kernel, params["kernel"],
                              buffers["kernel"], x_train, x_test)
    return (_ski_state(spec, params, buffers, x_train, z_bounds=bounds),
            _ski_state(spec, params, buffers, x_test, z_bounds=bounds))


def _solve_setup(spec, params, buffers, x_train, y_train, state=None):
    """(noise, y_c, A_mvm, M_inv, alpha) for the posterior paths: alpha is
    the mean cache A^{-1} y_c from one tight-tolerance CG solve; `state`,
    the train points' SKI geometry. The preconditioner is built fresh."""
    noise = exact_gp.noise_value(params)
    yc = y_train - exact_gp.mean_fn(spec, params, x_train)
    A_mvm = _make_A_mvm(spec, params, buffers, x_train, noise, state=state)
    M_inv = None
    if spec.precond_rank > 0:
        pre = _build_pre(spec, params, buffers, x_train, noise)
        M_inv = lambda R: precond.apply_inverse(pre, R)
    alpha = cg_mod.batched_pcg_while(A_mvm, yc[:, None], M_inv,
                                     max_iters=4 * spec.cg_max_iters,
                                     tol=1e-4).solution[:, 0]
    return noise, yc, A_mvm, M_inv, alpha


@torch.no_grad()
def iterative_posterior(spec: ModelSpec, params, buffers, x_train, y_train,
                        x_test, observation_noise: bool = True, fresh=None):
    """Posterior predictive (mean, var) by CG solves: the LOVE cache when
    spec.love_rank > 0, else one batched CG per chunk of _VAR_CHUNK test
    points against their K(x_train, chunk) columns. Under SKI every MVM
    is W T W^T on one grid over the train and test projections. fresh:
    the LOVE restart table (love.lanczos)."""
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    n_test = x_test.shape[0]
    st_train, st_test = _union_states(spec, params, buffers, x_train, x_test)
    noise, yc, A_mvm, M_inv, alpha = _solve_setup(spec, params, buffers,
                                                  x_train, y_train, st_train)
    cross = None if st_train is None else (st_test, st_train)
    mu = _kernel_mvm(spec, params, buffers, x_test, x_train, alpha[:, None],
                     states=cross, allow_pallas=True)[:, 0]
    mu = mu + exact_gp.mean_fn(spec, params, x_test)

    if spec.love_rank > 0:
        cache = love.build_love_cache(A_mvm, yc, noise, spec.love_rank,
                                      alpha=alpha, fresh=fresh)
        K_star_Q = _kernel_mvm(spec, params, buffers, x_test, x_train, cache.Q,
                               states=cross, allow_pallas=True)  # (n_test, r)
        kd = kernels.gram_diag(kspec, kp, kb, x_test)
        return mu, love.love_variance(cache, K_star_Q, kd,
                                      observation_noise=observation_noise)

    eye = torch.eye(_VAR_CHUNK, dtype=x_train.dtype, device=x_train.device)
    var = []
    for s in range(0, n_test, _VAR_CHUNK):
        xc = x_test[s:s + _VAR_CHUNK]
        # the last chunk is padded with zero rows, as the JAX package pads
        xc = torch.cat([xc, xc.new_zeros(_VAR_CHUNK - xc.shape[0],
                                         xc.shape[1])])
        if st_train is None:
            Kc = _kernel_mvm(spec, params, buffers, x_train, xc, eye,
                             allow_pallas=True)  # (n, c)
        else:
            # the chunk on the train grid: bounds at its interior cells
            # give back the same grid_lo and h
            h, lo = st_train.h, st_train.grid_lo
            st_c = _ski_state(spec, params, buffers, xc,
                              z_bounds=(lo + 2.0 * h,
                                        lo + (st_train.m - 3) * h))
            Kc = _kernel_mvm(spec, params, buffers, x_train, xc, eye,
                             states=(st_train, st_c))
        sol = cg_mod.batched_pcg_while(A_mvm, Kc, M_inv,
                                       max_iters=2 * spec.cg_max_iters,
                                       tol=_VAR_TOL).solution
        kd = kernels.gram_diag(kspec, kp, kb, xc)
        var.append(kd - torch.sum(Kc * sol, dim=0))
    var = torch.clamp(torch.cat(var)[:n_test], min=1e-10)
    if observation_noise:
        var = var + noise
    return mu, var


@torch.no_grad()
def make_predictor(spec: ModelSpec, params, buffers, x_train, y_train,
                   observation_noise: bool = True, fresh=None):
    """Cached prediction: build the mean cache and the LOVE cache once and
    return predict(x_test) -> (mu, var), one cross-kernel MVM per batch.
    Requires spec.love_rank > 0 (the cache is the variance path).

    SKI: the cached grid covers the train projections extended by
    ski.GRID_MARGIN x span on each side; test points beyond it get zero
    taps and so revert to the prior."""
    if spec.love_rank <= 0:
        raise ValueError("make_predictor requires spec.love_rank > 0 "
                         "(the LOVE cache is the cached variance path)")
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    st_train = bounds = None
    if kspec.ski:
        bounds = ski.margin_bounds(kspec, kp, kb, x_train)
        st_train = _ski_state(spec, params, buffers, x_train, z_bounds=bounds)
    noise, yc, A_mvm, _, alpha = _solve_setup(spec, params, buffers, x_train,
                                              y_train, st_train)
    cache = love.build_love_cache(A_mvm, yc, noise, spec.love_rank,
                                  alpha=alpha, fresh=fresh)
    AQ = torch.cat([alpha[:, None], cache.Q], dim=1)  # (n, 1 + r)

    @torch.no_grad()
    def predict(x_test):
        cross = None
        if st_train is not None:
            cross = (_ski_state(spec, params, buffers, x_test,
                                z_bounds=bounds), st_train)
        # one cross-kernel MVM per batch: columns [alpha | Q]
        C = _kernel_mvm(spec, params, buffers, x_test, x_train, AQ,
                        states=cross, allow_pallas=True)
        mu = C[:, 0] + exact_gp.mean_fn(spec, params, x_test)
        kd = kernels.gram_diag(kspec, kp, kb, x_test)
        return mu, love.love_variance(cache, C[:, 1:], kd,
                                      observation_noise=observation_noise)

    return predict


@torch.no_grad()
def iterative_posterior_cov(spec: ModelSpec, params, buffers, x_train,
                            y_train, x_test, observation_noise: bool = False,
                            fresh=None):
    """Posterior (mean, full covariance) at a modest test batch on the BBMM
    path: from the LOVE cache when spec.love_rank > 0, else n_test CG
    solves against the K(x_train, x_test) columns (identity MVMs). The
    prior test block is the exact Gram, under SKI too."""
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    st_train, st_test = _union_states(spec, params, buffers, x_train, x_test)
    noise, yc, A_mvm, M_inv, alpha = _solve_setup(spec, params, buffers,
                                                  x_train, y_train, st_train)
    cross = None if st_train is None else (st_test, st_train)
    mu = _kernel_mvm(spec, params, buffers, x_test, x_train, alpha[:, None],
                     states=cross)[:, 0]
    mu = mu + exact_gp.mean_fn(spec, params, x_test)

    K_ss = kernels.gram(kspec, kp, kb, x_test, x_test)
    if spec.love_rank > 0:
        cache = love.build_love_cache(A_mvm, yc, noise, spec.love_rank,
                                      alpha=alpha, fresh=fresh)
        K_star_Q = _kernel_mvm(spec, params, buffers, x_test, x_train,
                               cache.Q, states=cross)
        cov = love.love_covariance(cache, K_star_Q, K_ss)
    else:
        eye = torch.eye(x_test.shape[0], dtype=x_train.dtype,
                        device=x_train.device)
        Kc = _kernel_mvm(spec, params, buffers, x_train, x_test, eye,
                         states=None if cross is None else cross[::-1])
        sol = cg_mod.batched_pcg_while(A_mvm, Kc, M_inv,
                                       max_iters=4 * spec.cg_max_iters,
                                       tol=1e-4).solution
        cov = K_ss - Kc.T @ sol
        cov = 0.5 * (cov + cov.T)
    if observation_noise:
        cov = cov + noise * torch.eye(cov.shape[0], dtype=cov.dtype,
                                      device=cov.device)
    return mu, cov
