"""rpagp_torch's SKI + BBMM path against the JAX package, on the CPU: the
Toeplitz FFT product, ski_gram_diag, ski_mvm (self and cross) with its
gradient, the SKI iterative MLL with the same probe normals, the cached
(stale) preconditioner and precond_refresh training, the SKI posteriors
(LOVE, chunked CG, the cached predictor beyond its margin),
iterative_posterior_cov with and without SKI, and run_split on the four
SKI specs that take SKI + BBMM at small n.

Params, projections, probe normals and the Lanczos restart table are
numpy arrays handed to both packages. The port runs K2 and K3's plain
versions here. Tolerances: the operators (FFT product, ski_mvm,
ski_gram_diag) value rel <= 1e-5 in norm, not elementwise (torch.fft and
jnp.fft round differently), gradient relerr <= 1e-4; the MLLs value rel
<= 1e-4 and gradient relerr <= 1e-3, the BBMM bar (f32 CG, another
summation order, PERF.md section 2); the posteriors rel <= 1e-4.
"""

import dataclasses
import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rpagp import train as jtrain
from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops import iterative as jiter
from rpagp.ops import ski as jski
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch import runner, train
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import cuda_interp, iterative, ski
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import datasets
from rpagp_torch.utils.config import TrainConfig, load_spec
from rpagp_torch.utils.convert import to_numpy, to_torch

# the module (the package's `mll` is the function, as rpagp's is)
tmll = importlib.import_module("rpagp_torch.mll")

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_2PI = 1.8378770664093453

N, D, J, M = 300, 4, 4, 64
BASES = {"rbf": ["rbf"] * J, "mixed": ["rbf", "matern32", "rbf", "matern12"]}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_relerr(ga, gb):
    la, lb = jax.tree.leaves(ga), jax.tree.leaves(gb)
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
              for a, b in zip(la, lb))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in lb)
    return math.sqrt(num / max(den, 1e-30))


def _kspecs(bases="rbf", ski_on=True, m=M):
    kw = dict(proj_dist="gaussian", ski=ski_on, grid_size=m if ski_on else 0)
    return (JKernelSpec.generalized([1] * J, BASES[bases], **kw),
            KernelSpec.generalized([1] * J, BASES[bases], **kw))


def _problem(bases="rbf", ski_on=True, seed=0, n=N, **kw):
    """Both packages' (spec, params, buffers), the data, a test batch and
    the probe normals. noise 0.69 against outputscale 0.69: A is well
    enough conditioned that CG converges in a few steps and the two f32
    trajectories stay together."""
    kw = dict(dict(max_cholesky_size=64, cg_max_iters=30, cg_tol=1e-2,
                   precond_rank=10, num_probes=6), **kw)
    jk, tk = _kspecs(bases, ski_on)
    jspec, spec = JModelSpec(kernel=jk, **kw), ModelSpec(kernel=tk, **kw)
    params, buffers = jax.device_get(
        jgp.init_model(jax.random.key(seed), jspec, D))
    rng = np.random.default_rng(seed)
    params = dict(params, raw_noise=np.float32(0.0),
                  mean_const=np.float32(0.1),
                  kernel=dict(params["kernel"],
                              raw_lengthscale=(0.3 * rng.standard_normal(J))
                              .astype(np.float32),
                              raw_outputscale=np.float32(0.0)))
    x = rng.standard_normal((n + 90, D)).astype(np.float32)
    y = (np.sin(x @ rng.standard_normal(D) / 2.0)
         + 0.1 * rng.standard_normal(n + 90)).astype(np.float32)
    es = rng.standard_normal((kw["precond_rank"], kw["num_probes"])).astype(
        np.float32)
    eb = rng.standard_normal((n, kw["num_probes"])).astype(np.float32)
    return jspec, spec, params, buffers, x[:n], y[:n], x[n:], es, eb


def _port_params(params):
    p = to_torch(params, device="cpu")
    for t in (p["raw_noise"], p["mean_const"], *p["kernel"].values()):
        t.requires_grad_(True)
    return p


def _port_grads(p):
    return to_numpy({"raw_noise": p["raw_noise"].grad,
                     "mean_const": p["mean_const"].grad,
                     "kernel": {k: t.grad for k, t in p["kernel"].items()}})


def _far_points(P):
    """Points whose every projection lies far beyond any grid: x = c v with
    P^T v = 1 (J <= D), so z_j = c for each component j."""
    v = P @ np.linalg.solve(P.T @ P, np.ones(P.shape[1]))
    c = np.array([-400.0, -60.0, 60.0, 400.0])
    return (c[:, None] * v[None, :]).astype(np.float32)


# ------------------------------------------------------ operators ----


@pytest.mark.parametrize("m", [16, 64, 128])
def test_sym_toeplitz_matmul_matches(m):
    """The 2m circulant embedding's FFT product: value in norm, and the
    gradient to the columns and to U through autograd of the FFTs."""
    rng = np.random.default_rng(m)
    cells = np.arange(m, dtype=np.float32)
    col = np.exp(-0.5 * (cells[None, :] * rng.uniform(0.05, 0.3, (3, 1)))
                 ** 2).astype(np.float32)
    U = rng.standard_normal((3, 5, m)).astype(np.float32)
    W = rng.standard_normal((3, 5, m)).astype(np.float32)
    oj, (gcj, guj) = jax.value_and_grad(
        lambda c, u: jnp.sum(jski.sym_toeplitz_matmul(c, u) * W),
        argnums=(0, 1))(jnp.asarray(col), jnp.asarray(U))
    c, u = torch.tensor(col, requires_grad=True), torch.tensor(
        U, requires_grad=True)
    out = ski.sym_toeplitz_matmul(c, u)
    dense = np.einsum("jab,jtb->jta", col[:, np.abs(
        np.arange(m)[:, None] - np.arange(m)[None, :])], U)
    assert _rel(out.detach(), jski.sym_toeplitz_matmul(
        jnp.asarray(col), jnp.asarray(U))) <= 1e-5
    assert _rel(out.detach(), dense) <= 1e-5  # the Toeplitz product itself
    torch.sum(out * torch.tensor(W)).backward()
    assert _rel(c.grad, gcj) <= 1e-4
    assert _rel(u.grad, guj) <= 1e-4


def _states(bases, x, z_bounds=None):
    jk, tk = _kspecs(bases)
    _, _, params, buffers, *_ = _problem(bases)
    kpj, kbj = params["kernel"], buffers["kernel"]
    bj = None if z_bounds is None else tuple(jnp.asarray(b) for b in z_bounds)
    bt = None if z_bounds is None else tuple(torch.tensor(b) for b in z_bounds)
    stj = jski.build_ski(jk, kpj, kbj, jnp.asarray(x), M, z_bounds=bj)
    st = ski.build_ski(tk, to_torch(kpj, device="cpu"),
                       to_torch(kbj, device="cpu"), torch.tensor(x), M,
                       z_bounds=bt)
    return jk, tk, kpj, stj, st


@pytest.mark.parametrize("bases", ["rbf", "mixed"])
def test_ski_gram_diag_matches(bases):
    """diag(K_ski) from the (J, 4, 4) local blocks, on a grid narrower than
    the data: points beyond it get zero taps and a zero diagonal."""
    _, _, _, _, x, *_ = _problem(bases)
    jk, tk, kp, stj, st = _states(bases, x, z_bounds=(
        np.full(J, -0.5, np.float32), np.full(J, 0.5, np.float32)))
    dj = jski.ski_gram_diag(jk, kp, stj, x.shape[0])
    d = ski.ski_gram_diag(tk, to_torch(kp, device="cpu"), st)
    assert _rel(d, dj) <= 1e-5
    off = (st.tfrac < -2.0) | (st.tfrac > M + 1.0)  # off the grid's support
    assert bool(off.all(0).any()) and bool((d[off.all(0)] == 0).all())
    _, w4 = ski._tap_geometry(st.tfrac, M)
    _, w4j = jski._tap_geometry(stj.tfrac, M, jnp.float32)
    assert _rel(w4, w4j) <= 1e-5


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("bases", ["rbf", "mixed"])
def test_ski_mvm_value_and_gradient_match(bases, cross):
    """K2 -> Toeplitz FFT -> scales -> K3, and its gradient to the kernel
    params and to V through the autograd pair; the cross MVM puts the test
    and train points on one grid."""
    jk, tk = _kspecs(bases)
    _, _, params, buffers, x, _, xs, *_ = _problem(bases)
    kp, kb = params["kernel"], buffers["kernel"]
    rng = np.random.default_rng(3)
    V = rng.standard_normal((x.shape[0], 7)).astype(np.float32)
    lo = np.minimum(x @ kb["proj"], -4.0).min(0)
    hi = np.maximum(x @ kb["proj"], 4.0).max(0)
    jb_ = (jnp.asarray(lo), jnp.asarray(hi))
    tb_ = (torch.tensor(lo), torch.tensor(hi))
    st_rhs_j = jski.build_ski(jk, kp, kb, jnp.asarray(x), M, z_bounds=jb_)
    st_rhs = ski.build_ski(tk, to_torch(kp, device="cpu"),
                           to_torch(kb, device="cpu"), torch.tensor(x), M,
                           z_bounds=tb_)
    xo = xs if cross else x
    st_j = jski.build_ski(jk, kp, kb, jnp.asarray(xo), M, z_bounds=jb_)
    st = ski.build_ski(tk, to_torch(kp, device="cpu"),
                       to_torch(kb, device="cpu"), torch.tensor(xo), M,
                       z_bounds=tb_)
    Wc = rng.standard_normal((xo.shape[0], 7)).astype(np.float32)

    def jloss(k, v):
        return jnp.sum(jski.ski_mvm(jk, k, st_j, v, state_rhs=st_rhs_j) * Wc)

    vj, (gkj, gvj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        kp, jnp.asarray(V))
    k = {key: t.requires_grad_(True)
         for key, t in to_torch(kp, device="cpu").items()}
    v = torch.tensor(V, requires_grad=True)
    out = ski.ski_mvm(tk, k, st, v, state_rhs=st_rhs)
    assert out.shape == (xo.shape[0], 7)
    assert _rel(out.detach(), jski.ski_mvm(jk, kp, st_j, jnp.asarray(V),
                                           state_rhs=st_rhs_j)) <= 1e-5
    torch.sum(out * torch.tensor(Wc)).backward()
    assert _grad_relerr(to_numpy({key: t.grad for key, t in k.items()}),
                        jax.device_get(gkj)) <= 1e-4
    assert _rel(v.grad, gvj) <= 1e-4


def test_plain_interp_gives_far_points_zero_taps():
    """tfrac beyond [-2, m + 1] lies off every tap's support: W^T and W
    give exact zeros there (the kernels are held to these plain versions
    on the card, tests/test_torch_port_cuda.py)."""
    rng = np.random.default_rng(4)
    tf = torch.tensor(rng.uniform(0.0, M - 1.0, (J, 50)), dtype=torch.float32)
    tf[:, :10] = torch.tensor([-1e4, -50.0, -2.0, -2.5, M + 1.0, M + 1.5,
                               M + 40.0, 1e4, -3.0, M + 3.0])
    V = torch.randn(50, 3)
    U = cuda_interp.interp_transpose(tf, V, M)
    U_in = cuda_interp.interp_transpose(tf[:, 10:].contiguous(), V[10:], M)
    assert torch.equal(U, U_in)
    G = torch.randn(J, 3, M)
    out = cuda_interp.interp_apply_sum(tf, G)
    assert bool((out[:10] == 0).all()) and bool((out[10:] != 0).all())


# ------------------------------------------------------------ MLL ----


def _jax_value_and_grad(jspec, params, buffers, x, y, es, eb):
    iql = jiter._make_inv_quad_logdet(jspec)
    n = x.shape[0]

    def jloss(p, yy):
        iq, ld = iql(p, buffers, jnp.asarray(x), yy, jnp.asarray(es),
                     jnp.asarray(eb))
        return -0.5 * (iq + ld + n * LOG_2PI)

    return jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(y))


def _port_value_and_grad(spec, params, buffers, x, y, es, eb, stats=None):
    p = _port_params(params)
    yt = torch.tensor(y, requires_grad=True)
    iq, ld = iterative.inv_quad_logdet_eps(spec, p, buffers, torch.tensor(x),
                                           yt, torch.tensor(es),
                                           torch.tensor(eb), stats=stats)
    v = -0.5 * (iq + ld + x.shape[0] * LOG_2PI)
    v.backward()
    return float(v.detach()), _port_grads(p), yt.grad


@pytest.mark.parametrize("bases", ["rbf", "mixed"])
def test_ski_iterative_mll_value_and_gradients_match(bases):
    """The SKI + BBMM MLL on the cached geometry (prepare_buffers' SKI
    branch) with the same probe normals; mll() dispatches to it."""
    jspec, spec, params, buffers, x, y, _, es, eb = _problem(bases)
    jb = jgp.prepare_buffers(jspec, params, buffers, jnp.asarray(x))
    b = exact_gp.prepare_buffers(spec, to_torch(params, device="cpu"),
                                 to_torch(buffers, device="cpu"),
                                 torch.tensor(x), y_train=torch.tensor(y))
    assert sorted(b) == ["kernel", "ski_state"]
    st = to_torch(jax.device_get(jb["ski_state"]), device="cpu")
    for f in st._fields:
        if getattr(st, f) is None:  # a dense state: no sorted-plan fields
            assert getattr(b["ski_state"], f) is None, f
            continue
        assert _rel(getattr(b["ski_state"], f), getattr(st, f)) <= 1e-5, f
    vj, (gpj, gyj) = _jax_value_and_grad(jspec, params, jb, x, y, es, eb)
    v, g, gy = _port_value_and_grad(spec, params, b, x, y, es, eb)
    assert _rel(v, float(vj)) <= 1e-4
    assert _grad_relerr(g, jax.device_get(gpj)) <= 1e-3
    assert _rel(gy, gyj) <= 1e-3
    # the dispatcher: SKI at any n without the grid solver is BBMM
    p, xt, yt = to_torch(params, device="cpu"), torch.tensor(x), torch.tensor(y)
    assert tmll._solver(spec, x.shape[0]) == "iterative"
    assert float(tmll.mll(spec, p, b, xt, yt,
                          torch.Generator().manual_seed(5))) == float(
        iterative.iterative_mll(spec, p, b, xt, yt,
                                torch.Generator().manual_seed(5)))


def test_stale_preconditioner_mll_matches():
    """precond_refresh > 1: prepare_buffers caches the preconditioner at the
    initial params, the hyperparameters then move, and the MLL keeps the
    cached M for its probes, M^-1 and logdet(M), as the JAX package's
    does. A SKI spec gets no cache from prepare_buffers (the reference's
    order): its MLL builds M afresh until the trainer's first refresh."""
    jspec, spec, params, buffers, x, y, _, es, eb = _problem(
        "rbf", ski_on=False, precond_refresh=10)
    xt = torch.tensor(x)
    jb = jgp.prepare_buffers(jspec, params, buffers, jnp.asarray(x))
    b = exact_gp.prepare_buffers(spec, to_torch(params, device="cpu"),
                                 to_torch(buffers, device="cpu"), xt)
    pre, prej = b["precond_cache"], jax.device_get(jb["precond_cache"])
    assert _rel(pre.L, prej.L) <= 1e-5
    assert _rel(float(pre.logdet), float(prej.logdet)) <= 1e-5
    moved = dict(params, raw_noise=params["raw_noise"] - 0.5,
                 kernel=dict(params["kernel"], raw_lengthscale=params[
                     "kernel"]["raw_lengthscale"] + 0.5))
    vj, (gpj, _) = _jax_value_and_grad(jspec, moved, jb, x, y, es, eb)
    v, g, _ = _port_value_and_grad(spec, moved, b, x, y, es, eb)
    assert _rel(v, float(vj)) <= 1e-4
    assert _grad_relerr(g, jax.device_get(gpj)) <= 1e-3
    fresh = dataclasses.replace(spec, precond_refresh=1)
    assert v != _port_value_and_grad(fresh, moved, b, x, y, es, eb)[0]
    # SKI: no cache from prepare_buffers, so the fresh M every step
    _, sspec, sparams, sbuf, *_ = _problem("rbf", precond_refresh=10)
    sb = exact_gp.prepare_buffers(sspec, to_torch(sparams, device="cpu"),
                                  to_torch(sbuf, device="cpu"), xt)
    assert "precond_cache" not in sb
    assert _port_value_and_grad(sspec, moved, sb, x, y, es, eb)[0] == \
        _port_value_and_grad(dataclasses.replace(sspec, precond_refresh=1),
                             moved, sb, x, y, es, eb)[0]


def test_args_refresh_follows_the_reference_schedule():
    """train_to_convergence(args_refresh=(5, fn)) replaces loss_args before
    steps 5 and 10 of 12, as the JAX package's trainer: the same loss
    trajectory on a deterministic problem (rel <= 1e-4, the bar of
    tests/test_torch_port_runner.py's trajectory test), and two refreshes
    counted."""
    target = np.array([1.0, -2.0], np.float32)

    def jloss(p, a):
        return jnp.sum((p["w"] - a) ** 2)

    jres = jtrain.train_to_convergence(
        jloss, {"w": jnp.zeros(2)}, max_iters=12, patience=100,
        optimizer=optax.adam(0.1), loss_args=(jnp.asarray(target),),
        args_refresh=(5, lambda p, a: (a[0] + 1.0,)))
    res = train.train_to_convergence(
        lambda p, a: torch.sum((p["w"] - a) ** 2), {"w": torch.zeros(2)},
        TrainConfig(lr=0.1, max_iters=12, patience=100),
        loss_args=(torch.tensor(target),), sync_every=4,
        args_refresh=(5, lambda p, a: (a[0] + 1.0,)))
    assert res.refreshes == 2
    # optax's and torch's Adam round apart by ~1e-5 over the 12 steps
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-4)


def test_precond_refresh_training_matches_fresh():
    """A refresh-every-5 run reaches the loss of a rebuild-every-step run
    (the JAX package's test_precond_refresh_training_matches_fresh), and
    run_split wires the refresh for a spec with precond_refresh > 1."""
    n = 256
    rng = np.random.default_rng(60)
    x = torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32)
    y = torch.sin(2.0 * x[:, 0]) + 0.1 * torch.randn(
        n, generator=torch.Generator().manual_seed(1))
    finals = {}
    for refresh in (1, 5):
        spec = ModelSpec(kernel=KernelSpec.polynomial(J=4, d=1),
                         max_cholesky_size=64, cg_max_iters=60, cg_tol=1e-6,
                         precond_rank=8, num_probes=16,
                         precond_refresh=refresh)
        params, buffers = exact_gp.init_model(
            spec, D, generator=torch.Generator().manual_seed(61),
            device="cpu")
        bufs = exact_gp.prepare_buffers(spec, params, buffers, x)
        assert ("precond_cache" in bufs) == (refresh > 1)
        ref = None
        if refresh > 1:
            ref = (refresh, lambda p, a: (
                exact_gp.refresh_preconditioner(spec, p, a[0], x),))
        res = train.train_to_convergence(
            lambda p, b, g: -iterative.iterative_mll(spec, p, b, x, y, g) / n,
            params, TrainConfig(lr=0.1, max_iters=30, patience=100),
            loss_args=(bufs,), sync_every=8,
            generator=torch.Generator().manual_seed(62), args_refresh=ref)
        assert res.refreshes == (5 if refresh > 1 else 0)
        finals[refresh] = res.losses[-1]
    assert abs(finals[1] - finals[5]) < 0.03, finals


# ----------------------------------------------------- posteriors ----


def _fresh(rank, n):
    """The JAX package's Lanczos restart table (key 0)."""
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.key(0), (rank, n), jnp.float32)))


@pytest.mark.parametrize("love_rank", [40, 0], ids=["love", "chunked_cg"])
def test_ski_iterative_posterior_matches(love_rank):
    """The posterior on one grid over the train and test projections: LOVE,
    or the chunked CG whose chunk geometry sits on the train grid."""
    jspec, spec, params, buffers, x, y, xs, _, _ = _problem(
        love_rank=love_rank)
    muj, varj = jiter.iterative_posterior(jspec, params, buffers,
                                          jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(xs))
    mu, var = iterative.iterative_posterior(
        spec, to_torch(params, device="cpu"), to_torch(buffers, device="cpu"),
        torch.tensor(x), torch.tensor(y), torch.tensor(xs),
        fresh=_fresh(love_rank, N) if love_rank else None)
    assert _rel(mu, muj) <= 1e-4
    assert _rel(var, varj) <= 1e-4


def test_ski_make_predictor_matches_beyond_the_margin():
    """The cached SKI predictor on a grid extended by half the span: test
    points inside match the JAX package's; points beyond the margin get
    zero taps, so the prior mean and the exact prior variance plus
    noise."""
    jspec, spec, params, buffers, x, y, xs, _, _ = _problem(love_rank=40)
    far = _far_points(buffers["kernel"]["proj"])
    xq = np.concatenate([xs, far])
    pj = jiter.make_predictor(jspec, params, buffers, jnp.asarray(x),
                              jnp.asarray(y))
    muj, varj = pj(jnp.asarray(xq))
    p = to_torch(params, device="cpu")
    pt = iterative.make_predictor(spec, p, to_torch(buffers, device="cpu"),
                                  torch.tensor(x), torch.tensor(y),
                                  fresh=_fresh(40, N))
    mu, var = pt(torch.tensor(xq))
    assert _rel(mu, muj) <= 1e-4
    assert _rel(var, varj) <= 1e-4
    k = far.shape[0]
    np.testing.assert_allclose(mu[-k:].numpy(), float(p["mean_const"]),
                               rtol=1e-6)
    noise = float(exact_gp.noise_value(p))
    prior = float(torch.sum(ski._component_scales(spec.kernel, p["kernel"])))
    np.testing.assert_allclose(var[-k:].numpy(), prior + noise, rtol=1e-5)


@pytest.mark.parametrize("love_rank", [40, 0], ids=["love", "cg"])
@pytest.mark.parametrize("ski_on", [True, False], ids=["ski", "dense"])
def test_iterative_posterior_cov_matches(ski_on, love_rank):
    """Mean and full covariance on the BBMM path: the LOVE covariance, or
    n_test CG solves against identity-MVM columns; mll.posterior_cov
    dispatches to it."""
    jspec, spec, params, buffers, x, y, xs, _, _ = _problem(
        ski_on=ski_on, love_rank=love_rank)
    xs = xs[:40]
    muj, covj = jiter.iterative_posterior_cov(
        jspec, params, buffers, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(xs), observation_noise=True)
    args = (spec, to_torch(params, device="cpu"),
            to_torch(buffers, device="cpu"), torch.tensor(x), torch.tensor(y),
            torch.tensor(xs))
    fresh = _fresh(love_rank, N) if love_rank else None
    mu, cov = iterative.iterative_posterior_cov(*args, observation_noise=True,
                                                fresh=fresh)
    assert _rel(mu, muj) <= 1e-4
    assert _rel(cov, covj) <= 1e-4
    assert torch.equal(cov, cov.T)
    assert tmll._solver(spec, N) == "iterative"
    if not love_rank:  # the dispatcher (its LOVE draws its own table)
        mu2, cov2 = tmll.posterior_cov(*args, observation_noise=True)
        assert torch.equal(mu2, mu) and torch.equal(cov2, cov)


# -------------------------------------------------------- runner ----

# (spec, max_points): the flagship's love_rank (512) needs n_train above
# it, as in the JAX package: at love_rank >= n_train Lanczos runs out of
# directions and both packages' LOVE variances come out NaN (ROADMAP.md
# section 3)
SKI_SPECS = [("rp_poly_j20_ski", 440), ("rp_generalized_mixed_ski", 440),
             ("rp_ski_protein", 440), ("rp_ski_houseelectric_j20", 600)]


@pytest.mark.parametrize("name,max_points", SKI_SPECS,
                         ids=[s for s, _ in SKI_SPECS])
def test_run_split_on_each_ski_spec(name, max_points):
    """run_split on the spec's own file (1 step) on a 400-540-point split
    of synthetic sml (D = 26): grid rank p = J m > n / 2, so SKI + BBMM
    end to end, finite metrics."""
    exp = load_spec(os.path.join(ROOT, "specs", f"{name}.json"))
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=1))
    ds = datasets.load_dataset("sml", max_points=max_points)
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    assert tmll._solver(exp.model, split.train_x.shape[0]) == "iterative"
    m = runner.run_split(exp, split, seed=0, device="cpu")
    assert m["iterations"] == 1 and m["n_train"] == split.train_x.shape[0]
    for k in ("rmse", "nll", "mll"):
        assert math.isfinite(m[k]), (k, m)


def test_run_split_refreshes_the_cached_preconditioner():
    """A BBMM spec with precond_refresh = 2: prepare_buffers caches the
    preconditioner and run_split's trainer rebuilds it before step 2."""
    exp = load_spec(os.path.join(ROOT, "specs", "rp_bbmm_elevators.json"))
    model = dataclasses.replace(exp.model, max_cholesky_size=64,
                                cg_max_iters=8, precond_rank=5, num_probes=4,
                                love_rank=8, precond_refresh=2)
    exp = dataclasses.replace(exp, model=model,
                              train=dataclasses.replace(exp.train,
                                                        max_iters=3))
    ds = datasets.load_dataset("elevators", max_points=150)
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    m = runner.run_split(exp, split, seed=0, device="cpu")
    assert m["iterations"] == 3 and m["refreshes"] == 1
    for k in ("rmse", "nll", "mll"):
        assert math.isfinite(m[k]), (k, m)
