"""rpagp_torch's BBMM path as a whole against the JAX package, on the CPU:
the CG + SLQ marginal log-likelihood with its probe-estimator gradient,
the LOVE and chunked-CG posteriors and the cached predictor, and a small
run_split on the BBMM spec. Params, projections, probe normals and the
Lanczos restart table are numpy arrays handed to both packages.

Tolerances. The MLL: value rel <= 1e-4, gradient relerr <= 1e-3. Both
sides run the same algorithm in f32 (30 steps of batched PCG, a rank-10
pivoted Cholesky, eigh of the tridiagonals), but the kernel MVM sums in
another order on each side, and CG carries each step's rounding into
the next, so the two agree to ~1e-6 per step and drift over the run;
the estimator's gradient is a difference of such solves. The problem is
chosen so that no column's residual sits near cg_tol, and the test
asserts both sides froze the same iterations. The posteriors: mean and
variance rel <= 1e-4 (tight-tolerance CG and 40 Lanczos steps).
"""

import dataclasses
import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops import cg as jcg
from rpagp.ops import iterative as jiter
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch import runner
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import iterative
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import datasets
from rpagp_torch.utils.config import load_spec
from rpagp_torch.utils.convert import to_torch

# the module (the package's `mll` is the function, as rpagp's is)
tmll = importlib.import_module("rpagp_torch.mll")

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, D, J = 300, 4, 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_relerr(ga, gb):
    num = sum(float(np.sum((np.asarray(ga[k], np.float64)
                            - np.asarray(gb[k], np.float64)) ** 2)) for k in gb)
    den = sum(float(np.sum(np.asarray(gb[k], np.float64) ** 2)) for k in gb)
    return math.sqrt(num / den)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _problem(love_rank=0, base="rbf", cg_max_iters=30, seed=0):
    kw = dict(max_cholesky_size=64, cg_max_iters=cg_max_iters, cg_tol=1e-2,
              precond_rank=10, num_probes=6, love_rank=love_rank)
    jspec = JModelSpec(kernel=JKernelSpec.polynomial(J=J, d=1, base=base), **kw)
    spec = ModelSpec(kernel=KernelSpec.polynomial(J=J, d=1, base=base), **kw)
    params, buffers = jax.device_get(
        jgp.init_model(jax.random.key(seed), jspec, D))
    rng = np.random.default_rng(seed)
    # noise 0.69 against a kernel of outputscale 0.69: A is well enough
    # conditioned that CG converges in a few steps and the two f32
    # trajectories stay together
    params = dict(params, raw_noise=np.float32(0.0),
                  mean_const=np.float32(0.1),
                  kernel=dict(params["kernel"],
                              raw_lengthscale=(0.3 * rng.standard_normal(J))
                              .astype(np.float32),
                              raw_outputscale=np.float32(0.0)))
    x = rng.standard_normal((N + 40, D)).astype(np.float32)
    y = (np.sin(x @ rng.standard_normal(D) / 2.0)
         + 0.1 * rng.standard_normal(N + 40)).astype(np.float32)
    eps_small = rng.standard_normal((10, 6)).astype(np.float32)
    eps_big = rng.standard_normal((N, 6)).astype(np.float32)
    return (jspec, spec, params, buffers, x[:N], y[:N], x[N:], y[N:],
            eps_small, eps_big)


def _jax_frozen(jspec, params, buffers, x, y, eps_small, eps_big):
    """The JAX package's forward CG of inv_quad_logdet rebuilt from its
    pieces: which iterations its convergence mask froze, per column."""
    noise = jgp.noise_value(params)
    yc = y - jgp.mean_fn(jspec, params, x)
    A_mvm = jiter._make_A_mvm(jspec, params, buffers, x, noise)
    pre = jiter._build_pre(jspec, params, buffers, x, noise)
    from rpagp.ops import precond as jprecond

    Z = (jnp.matmul(pre.L, eps_small, precision=jax.lax.Precision.HIGHEST)
         + jnp.sqrt(pre.noise) * eps_big)
    res = jcg.batched_pcg(A_mvm, jnp.concatenate([yc[:, None], Z], axis=1),
                          lambda R: jprecond.apply_inverse(pre, R),
                          max_iters=jspec.cg_max_iters, tol=jspec.cg_tol)
    return np.asarray(res.alphas) == 0


@pytest.mark.parametrize("base", ["rbf", "matern32"])
def test_iterative_mll_value_and_gradients_match(base):
    (jspec, spec, params, buffers, x, y, _, _, es, eb) = _problem(base=base)
    n = x.shape[0]
    iql = jiter._make_inv_quad_logdet(jspec)

    def jloss(p, yy):
        iq, ld = iql(p, buffers, jnp.asarray(x), yy, jnp.asarray(es),
                     jnp.asarray(eb))
        return -0.5 * (iq + ld + n * 1.8378770664093453)

    vj, (gpj, gyj) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(y))
    p = to_torch(params, device="cpu")
    leaves = [p["raw_noise"], p["mean_const"], *p["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    yt = torch.tensor(y, requires_grad=True)
    stats = {}
    iq, ld = iterative.inv_quad_logdet_eps(spec, p,
                                           to_torch(buffers, device="cpu"),
                                           torch.tensor(x), yt,
                                           torch.tensor(es), torch.tensor(eb),
                                           stats=stats)
    v = -0.5 * (iq + ld + n * 1.8378770664093453)
    v.backward()
    frozen = stats["cg"].alphas.numpy() == 0
    frozen_j = _jax_frozen(jspec, params, buffers, jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(es), jnp.asarray(eb))
    assert frozen.any() and not frozen.all()
    np.testing.assert_array_equal(frozen.sum(0), frozen_j.sum(0))
    assert _rel(float(v.detach()), float(vj)) <= 1e-4
    g = _flat({"raw_noise": p["raw_noise"].grad,
               "mean_const": p["mean_const"].grad,
               "kernel": {k: t.grad for k, t in p["kernel"].items()}})
    assert _grad_relerr(g, _flat(jax.device_get(gpj))) <= 1e-3
    assert _rel(yt.grad.numpy(), gyj) <= 1e-3


def test_mll_dispatch_takes_the_bbmm_branch():
    """mll() above max_cholesky_size without SKI is iterative_mll with
    probes from the generator: the same draws give the same value."""
    (_, spec, params, buffers, x, y, *_rest) = _problem()
    p, b = to_torch(params, device="cpu"), to_torch(buffers, device="cpu")
    xt, yt = torch.tensor(x), torch.tensor(y)
    v1 = tmll.mll(spec, p, b, xt, yt, torch.Generator().manual_seed(5))
    v2 = iterative.iterative_mll(spec, p, b, xt, yt,
                                 torch.Generator().manual_seed(5))
    assert float(v1) == float(v2) and math.isfinite(float(v1))
    # at or below max_cholesky_size the same call is the dense Cholesky MLL
    small = dataclasses.replace(spec, max_cholesky_size=10**6)
    assert float(tmll.mll(small, p, b, xt, yt)) == float(
        exact_gp.exact_mll(small, p, b, xt, yt))
    # precond_refresh > 1 caches the preconditioner at these params
    cached = exact_gp.prepare_buffers(
        dataclasses.replace(spec, precond_refresh=5), p, b, xt)
    assert sorted(cached) == ["kernel", "precond_cache"]
    assert cached["precond_cache"].L.shape == (x.shape[0], spec.precond_rank)
    assert exact_gp.prepare_buffers(spec, p, b, xt, y_train=yt) is b


@pytest.mark.parametrize("love_rank", [40, 0], ids=["love", "chunked_cg"])
def test_iterative_posterior_matches(love_rank):
    (jspec, spec, params, buffers, x, y, xs, _, _, _) = _problem(
        love_rank=love_rank)
    muj, varj = jiter.iterative_posterior(jspec, params, buffers,
                                          jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(xs))
    fresh = None
    if love_rank:  # the JAX package's default restart table (key 0)
        fresh = torch.tensor(np.asarray(jax.random.normal(
            jax.random.key(0), (love_rank, N), jnp.float32)))
    mu, var = iterative.iterative_posterior(
        spec, to_torch(params, device="cpu"),
        to_torch(buffers, device="cpu"), torch.tensor(x),
        torch.tensor(y), torch.tensor(xs), fresh=fresh)
    assert _rel(mu.numpy(), muj) <= 1e-4
    assert _rel(var.numpy(), varj) <= 1e-4
    if love_rank:  # the cached predictor: the same caches, one MVM a batch
        pj = jiter.make_predictor(jspec, params, buffers, jnp.asarray(x),
                                  jnp.asarray(y))
        pt = iterative.make_predictor(spec, to_torch(params, device="cpu"),
                                      to_torch(buffers, device="cpu"),
                                      torch.tensor(x),
                                      torch.tensor(y), fresh=fresh)
        (m2j, v2j), (m2, v2) = pj(jnp.asarray(xs)), pt(torch.tensor(xs))
        assert _rel(m2.numpy(), m2j) <= 1e-4
        assert _rel(v2.numpy(), v2j) <= 1e-4
        m3, v3 = tmll.make_predictor(spec, to_torch(params, device="cpu"),
                                     to_torch(buffers, device="cpu"),
                                     torch.tensor(x), torch.tensor(y))(
            torch.tensor(xs))
        assert _rel(m3.numpy(), m2.numpy()) <= 1e-5


@pytest.mark.parametrize("stochastic", [True, False])
def test_convergence_tracker_matches_jax(stochastic):
    """The patience tracker, with the EMA of the noisy BBMM loss and
    without: the same stopping step and best loss on a noisy descent."""
    from rpagp.train import ConvergenceTracker as JTracker
    from rpagp_torch.train import ConvergenceTracker

    rng = np.random.default_rng(0)
    losses = 1.0 / (1.0 + np.arange(200) / 10.0) + 0.02 * rng.standard_normal(200)
    out = []
    for cls in (JTracker, ConvergenceTracker):
        tr = cls(patience=20, rel_tol=1e-3, stochastic=stochastic)
        stop = next((i for i, lf in enumerate(losses)
                     if tr.update(float(lf), i)), None)
        out.append((stop, tr.best, tr.best_params))
    assert out[0] == out[1] and out[0][0] is not None


def test_run_split_bbmm_smoke_on_cpu():
    """run_split on the BBMM spec, max_cholesky_size lowered so a small
    elevators subsample takes the iterative branch; a few steps, finite
    metrics, and the stochastic (EMA) tracker."""
    exp = load_spec(os.path.join(ROOT, "specs", "rp_bbmm_elevators.json"))
    model = dataclasses.replace(exp.model, max_cholesky_size=128,
                                precond_rank=10, love_rank=32)
    exp = dataclasses.replace(exp, model=model, train=dataclasses.replace(
        exp.train, max_iters=6))
    ds = datasets.load_dataset("elevators", max_points=400)
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    timings = {}
    m = runner.run_split(exp, split, seed=0, device="cpu", timings=timings)
    assert m["n_train"] == 360 and m["n_test"] == 40
    assert m["iterations"] == 6
    for k in ("rmse", "nll", "mll"):
        assert math.isfinite(m[k]), k
    assert set(timings) == {"prepare_s", "train_s", "posterior_s"}
