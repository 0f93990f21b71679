"""rpagp_torch's dense Cholesky branch as a whole against the JAX package,
on the CPU: exact_mll value and gradient for every kernel family the
dense specs use, the posterior (predict, make_predictor, predict_cov,
sample_posterior with given normals), the size dispatch of mll.py, a
5-step training trajectory, and run_split on each dense spec.

Params, projections, points and normals are numpy arrays handed to both
packages. The JAX side runs as its own tests run on the CPU: its blocked
factor takes the XLA leaf there (test_torch_port_dense_kernels.py holds
the Pallas leaf in interpret mode against the port's). The port's factor
is block_chol.blocked_cholesky, K1's plain version on each 512 leaf.
Bars: value rel <= 1e-5, gradient relerr <= 1e-4, posterior mean and
variance rel <= 1e-5, covariance max-abs <= 1e-5 |cov|.
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

from rpagp import train as jtrain
from rpagp.mll import mll as jmll
from rpagp.mll import posterior_cov as jposterior_cov
from rpagp.mll import sample_posterior as jsample_posterior
from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops import iterative as jiter
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp.utils import config as jconfig
from rpagp_torch import runner, train
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import grid_solve, iterative
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import datasets
from rpagp_torch.utils.config import load_spec
from rpagp_torch.utils.convert import to_numpy, to_torch

# the module (the package's `mll` is the function, as rpagp's is)
tmll = importlib.import_module("rpagp_torch.mll")

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 6

# kernel configurations of the dense specs, at test size
KERNELS = {
    "poly_j10": dict(family="projection", J=10, d=1),
    "poly_j5_d2": dict(family="projection", J=5, d=2),
    "generalized_mixed": dict(family="projection", degrees=(1, 1, 2, 3),
                              bases=("rbf", "matern32", "rbf", "matern52")),
    "learned_proj": dict(family="projection", J=5, d=1, learn_proj=True),
    "sphere_percomp": dict(family="projection", J=6, d=1, proj_dist="sphere",
                           per_component_scale=True),
    "axes": dict(family="projection", J=D, d=1, proj_dist="axes"),
    "uniform_space_proj": dict(family="projection", J=4, d=1,
                               proj_dist="uniform", space_proj=True),
    "rbf_ard": dict(family="rbf", ard=True),
    "matern52_ard": dict(family="matern52", ard=True),
    "matern12_shared": dict(family="matern12", ard=False),
    "rp_limit": dict(family="rp_limit_rbf", ard=False),
}


def _kspec(cls, family, J=0, d=1, degrees=None, bases=None, **kw):
    if family != "projection":
        return cls(family=family, **kw)
    if degrees is not None:
        return cls.generalized(degrees, bases, **kw)
    return cls.polynomial(J=J, d=d, **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _grad_relerr(ga, gb):
    ga, gb = _flat(ga), _flat(gb)
    assert sorted(ga) == sorted(gb)
    num = sum(float(np.sum((ga[k].astype(np.float64) - gb[k]) ** 2))
              for k in gb)
    den = sum(float(np.sum(gb[k].astype(np.float64) ** 2)) for k in gb)
    return math.sqrt(num / den)


def _problem(name, n=200, n_test=50, seed=0, **model_kw):
    """(jspec, spec, params, buffers, x, y, xs): the JAX package's initial
    params moved off zero by seeded numpy draws, and a smooth target."""
    kw = KERNELS[name]
    jspec = JModelSpec(kernel=_kspec(JKernelSpec, **kw), **model_kw)
    spec = ModelSpec(kernel=_kspec(KernelSpec, **kw), **model_kw)
    params, buffers = jax.device_get(
        jgp.init_model(jax.random.key(seed), jspec, D))
    rng = np.random.default_rng(seed)
    kp = dict(params["kernel"])
    kp["raw_lengthscale"] = (0.3 * rng.standard_normal(
        kp["raw_lengthscale"].shape) + 0.3).astype(np.float32)
    kp["raw_outputscale"] = (0.2 * rng.standard_normal(
        np.shape(kp["raw_outputscale"]))).astype(np.float32)
    params = dict(params, raw_noise=np.float32(-1.0),
                  mean_const=np.float32(0.1), kernel=kp)
    x = rng.standard_normal((n + n_test, D)).astype(np.float32)
    y = (np.sin(x @ rng.standard_normal(D) / 2.0)
         + 0.1 * rng.standard_normal(n + n_test)).astype(np.float32)
    return jspec, spec, params, buffers, x[:n], y[:n], x[n:]


def _leaves(p):
    return [t for v in p.values()
            for t in (v.values() if isinstance(v, dict) else [v])]


def _port_grad(p):
    return {k: ({kk: t.grad for kk, t in v.items()} if isinstance(v, dict)
                else v.grad) for k, v in p.items()}


def _torch_params(params):
    p = to_torch(params, device="cpu")
    for t in _leaves(p):
        t.requires_grad_(True)
    return p


MLL_CASES = [(name, 200) for name in KERNELS] + [("poly_j10", 600)]


@pytest.mark.parametrize("name,n", MLL_CASES,
                         ids=[f"{k}-n{n}" for k, n in MLL_CASES])
def test_exact_mll_value_and_gradient_match(name, n):
    """exact_mll (the dense Gram, add_jitter, the blocked factor,
    cholesky_solve, the logdet) against the JAX package's: value and the
    gradient wrt every param (the projection too where it is learned).
    At n = 600 the factor runs two 512 leaves, the second padded."""
    jspec, spec, params, buffers, x, y, _ = _problem(name, n=n)
    vj, gj = jax.jit(jax.value_and_grad(
        lambda p: jgp.exact_mll(jspec, p, buffers, jnp.asarray(x),
                                jnp.asarray(y))))(params)
    p = _torch_params(params)
    v = exact_gp.exact_mll(spec, p, to_torch(buffers, device="cpu"),
                           torch.from_numpy(x),
                           torch.from_numpy(y))
    v.backward()
    assert _rel(float(v.detach()), float(vj)) <= 1e-5
    assert _grad_relerr(_port_grad(p), jax.device_get(gj)) <= 1e-4
    if spec.kernel.learn_proj:
        assert float(np.abs(to_numpy(p["kernel"]["proj"].grad)).max()) > 0


@pytest.mark.parametrize("name", ["poly_j5_d2", "generalized_mixed",
                                  "matern52_ard", "rp_limit"])
@pytest.mark.parametrize("observation_noise", [True, False],
                         ids=["noisy", "latent"])
def test_predict_and_cached_predictor_match(name, observation_noise):
    """predict and make_predictor (two test batches through one cache)
    against the JAX package's predict: mean and variance rel <= 1e-5."""
    jspec, spec, params, buffers, x, y, xs = _problem(name)
    muj, varj = jgp.predict(jspec, params, buffers, jnp.asarray(x),
                            jnp.asarray(y), jnp.asarray(xs),
                            observation_noise=observation_noise)
    p, b = to_torch(params, device="cpu"), to_torch(buffers, device="cpu")
    xt, yt, xst = (torch.from_numpy(a) for a in (x, y, xs))
    mu, var = exact_gp.predict(spec, p, b, xt, yt, xst,
                               observation_noise=observation_noise)
    assert _rel(mu, muj) <= 1e-5 and _rel(var, varj) <= 1e-5
    pred = exact_gp.make_predictor(spec, p, b, xt, yt,
                                   observation_noise=observation_noise)
    for sl in (slice(0, 20), slice(20, 50)):
        m2, v2 = pred(xst[sl])
        assert _rel(m2, np.asarray(muj)[sl]) <= 1e-5
        assert _rel(v2, np.asarray(varj)[sl]) <= 1e-5


@pytest.mark.parametrize("name", ["poly_j10", "rbf_ard", "sphere_percomp"])
@pytest.mark.parametrize("observation_noise", [False, True],
                         ids=["latent", "noisy"])
def test_posterior_cov_matches(name, observation_noise):
    """mll.posterior_cov on the exact branch against the JAX package's:
    mean rel <= 1e-5, covariance max-abs <= 1e-5 |cov|, symmetric."""
    jspec, spec, params, buffers, x, y, xs = _problem(name)
    muj, covj = jposterior_cov(jspec, params, buffers, jnp.asarray(x),
                                   jnp.asarray(y), jnp.asarray(xs),
                                   observation_noise=observation_noise)
    mu, cov = tmll.posterior_cov(spec, to_torch(params, device="cpu"),
                                 to_torch(buffers, device="cpu"),
                                 torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(xs),
                                 observation_noise=observation_noise)
    covj = np.asarray(covj, np.float64)
    assert _rel(mu, muj) <= 1e-5
    assert (float(np.max(np.abs(cov.numpy() - covj)))
            <= 1e-5 * np.linalg.norm(covj))
    assert torch.equal(cov, cov.T)


@pytest.mark.parametrize("observation_noise", [True, False],
                         ids=["noisy", "latent"])
def test_sample_posterior_with_given_normals(observation_noise):
    """sample_posterior with the normals the JAX package's mvn_sample draws
    from its key. Noisy (cov + s^2 I, well conditioned): the same draws as
    the JAX package's, rel <= 1e-5. Latent: the covariance's smallest
    eigenvalue is ~5e-5 here, and its f32 rounding, amplified by the
    Cholesky, puts the two packages' draws 4e-5 apart and each 6e-5 from
    a float64 computation of the whole; so the covariance is held to the
    JAX package's in test_posterior_cov_matches, and the draws to the
    float64 draw mu + eps chol(cov + jitter I)^T on the port's own (mu,
    cov), rel <= 1e-5. From a generator: draws of the right shape whose
    mean tends to the posterior mean."""
    jspec, spec, params, buffers, x, y, xs = _problem("poly_j10")
    key = jax.random.key(3)
    sj = jsample_posterior(jspec, params, buffers, jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(xs), key,
                           num_samples=6, observation_noise=observation_noise)
    eps = np.asarray(jax.random.normal(key, (6, xs.shape[0]), jnp.float32))
    args = (spec, to_torch(params, device="cpu"),
            to_torch(buffers, device="cpu"), torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(xs))
    kw = dict(observation_noise=observation_noise)
    s = tmll.sample_posterior(*args, num_samples=6, eps=torch.from_numpy(eps),
                              **kw)
    assert s.shape == (6, xs.shape[0])
    mu, cov = tmll.posterior_cov(*args, **kw)
    if observation_noise:
        assert _rel(s, sj) <= 1e-5
    else:
        L64 = np.linalg.cholesky(cov.double().numpy()
                                 + spec.jitter * np.eye(xs.shape[0]))
        assert _rel(s, mu.double().numpy()[None]
                    + eps.astype(np.float64) @ L64.T) <= 1e-5
    draws = tmll.sample_posterior(*args, torch.Generator().manual_seed(0),
                                  num_samples=4000, **kw)
    sd = torch.sqrt(torch.diagonal(cov))
    assert draws.shape == (4000, xs.shape[0])
    assert float(torch.max(torch.abs(draws.mean(0) - mu) / sd)) < 0.1


def test_mll_dispatch_takes_the_exact_branch():
    """At n <= max_cholesky_size without SKI, mll, posterior and
    make_predictor are the exact branch's, and mll equals the JAX
    package's dispatched mll; above it (or with SKI) posterior_cov is the
    BBMM branch's iterative_posterior_cov (or the grid solver's
    grid_posterior_cov)."""
    jspec, spec, params, buffers, x, y, xs = _problem("poly_j10")
    p, b = to_torch(params, device="cpu"), to_torch(buffers, device="cpu")
    xt, yt, xst = (torch.from_numpy(a) for a in (x, y, xs))
    v = tmll.mll(spec, p, b, xt, yt)
    assert float(v) == float(exact_gp.exact_mll(spec, p, b, xt, yt))
    assert _rel(float(v), float(jmll(jspec, params, buffers,
                                         jnp.asarray(x), jnp.asarray(y)))) \
        <= 1e-5
    mu, var = tmll.posterior(spec, p, b, xt, yt, xst)
    mu2, var2 = exact_gp.predict(spec, p, b, xt, yt, xst)
    assert torch.equal(mu, mu2) and torch.equal(var, var2)
    mu3, var3 = tmll.make_predictor(spec, p, b, xt, yt)(xst)
    assert torch.equal(mu3, mu2) and torch.equal(var3, var2)
    big = dataclasses.replace(spec, max_cholesky_size=100)
    assert tmll._solver(big, 200) == "iterative"
    mu4, cov4 = tmll.posterior_cov(big, p, b, xt, yt, xst)
    mu5, cov5 = iterative.iterative_posterior_cov(big, p, b, xt, yt, xst)
    assert torch.equal(mu4, mu5) and torch.equal(cov4, cov5)
    ski = dataclasses.replace(spec, kernel=dataclasses.replace(
        spec.kernel, ski=True, grid_size=8))
    assert tmll._solver(ski, 200) == "grid"
    bs = exact_gp.prepare_buffers(ski, p, b, xt, y_train=yt)
    mu6, cov6 = tmll.posterior_cov(ski, p, bs, xt, yt, xst)
    mu7, cov7 = grid_solve.grid_posterior_cov(ski, p, bs, xt, yt, xst)
    assert torch.equal(mu6, mu7) and torch.equal(cov6, cov7)


def test_full_d_kernel_above_max_cholesky_size_takes_bbmm():
    """exact_rbf above max_cholesky_size: the BBMM branch through the
    blocked MVM of the full-D Gram (K4 does not apply to it), against the
    JAX package's estimator on the same probe normals: value rel <= 1e-4,
    gradient relerr <= 1e-3 (the BBMM bar, PERF.md section 2)."""
    kw = dict(max_cholesky_size=64, cg_max_iters=40, cg_tol=1e-3,
              precond_rank=10, num_probes=6)
    jspec, spec, params, buffers, x, y, _ = _problem("rbf_ard", n=150, **kw)
    params = dict(params, raw_noise=np.float32(0.0))
    rng = np.random.default_rng(9)
    es = rng.standard_normal((10, 6)).astype(np.float32)
    eb = rng.standard_normal((150, 6)).astype(np.float32)
    iql = jiter._make_inv_quad_logdet(jspec)

    def jloss(p):
        iq, ld = iql(p, buffers, jnp.asarray(x), jnp.asarray(y),
                     jnp.asarray(es), jnp.asarray(eb))
        return -0.5 * (iq + ld + 150 * 1.8378770664093453)

    vj, gj = jax.jit(jax.value_and_grad(jloss))(params)
    assert tmll._solver(spec, 150) == "iterative"
    p = _torch_params(params)
    iq, ld = iterative.inv_quad_logdet_eps(
        spec, p, to_torch(buffers, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(y),
        torch.from_numpy(es), torch.from_numpy(eb))
    v = -0.5 * (iq + ld + 150 * 1.8378770664093453)
    v.backward()
    assert _rel(float(v.detach()), float(vj)) <= 1e-4
    assert _grad_relerr(_port_grad(p), jax.device_get(gj)) <= 1e-3
    vm = tmll.mll(spec, to_torch(params, device="cpu"),
                  to_torch(buffers, device="cpu"),
                  torch.from_numpy(x), torch.from_numpy(y),
                  torch.Generator().manual_seed(0))
    assert math.isfinite(float(vm))


def test_training_trajectory_matches_jax():
    """5 Adam steps of rp_poly_j20 (J = 20, degree-1 RBF) at n = 600 from
    the same initial params and projection: the port's trainer on the
    dense MLL against the JAX package's train_to_convergence."""
    path = os.path.join(ROOT, "specs", "rp_poly_j20.json")
    jexp, exp = jconfig.load_spec(path), load_spec(path)
    jspec, spec = jexp.model, exp.model
    n = 600
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = (np.cos(x @ rng.standard_normal(8) / 2.0)
         + 0.2 * rng.standard_normal(n)).astype(np.float32)
    tr = dataclasses.replace(exp.train, max_iters=5)
    jp, jb = jax.device_get(jgp.init_model(jax.random.key(0), jspec, 8))
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jres = jtrain.train_to_convergence(
        lambda p, b, xx, yy: -jmll(jspec, p, b, xx, yy) / n, jp,
        max_iters=5, patience=tr.patience,
        optimizer=jconfig.make_optimizer(jconfig.TrainConfig(
            **dataclasses.asdict(tr))),
        loss_args=(jb, xj, yj))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    res = train.train_to_convergence(
        lambda p, b, xx, yy: -tmll.mll(spec, p, b, xx, yy) / n,
        to_torch(jp, device="cpu"), tr, loss_args=(to_torch(jb, device="cpu"),
                                                   xt, yt), sync_every=2)
    assert len(res.losses) == len(jres.losses) == 5
    assert res.losses[-1] < res.losses[0]
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-5)
    assert _grad_relerr(to_numpy(res.params), jax.device_get(jres.params)) \
        <= 1e-5


DENSE_SPECS = ["rp_poly_j10", "rp_poly_j10_d2", "rp_poly_j20",
               "rp_generalized_mixed", "rp_learned_proj_j10", "exact_rbf",
               "exact_matern52", "rp_limit", "additive_axes",
               "rp_sphere_j20_percomp", "rp_bbmm_elevators"]


@pytest.mark.parametrize("name", DENSE_SPECS)
def test_run_split_on_each_dense_spec(name):
    """run_split on the spec's own file (3 steps) on a ~300-point split of
    synthetic sml (D = 26): the dense branch end to end, finite metrics."""
    exp = load_spec(os.path.join(ROOT, "specs", f"{name}.json"))
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=3))
    ds = datasets.load_dataset("sml", max_points=330)
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    assert tmll._solver(exp.model, split.train_x.shape[0]) == "exact"
    m = runner.run_split(exp, split, seed=0, device="cpu")
    assert m["iterations"] == 3 and m["n_train"] == split.train_x.shape[0]
    for k in ("rmse", "nll", "mll"):
        assert math.isfinite(m[k]), (k, m)
