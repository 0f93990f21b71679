"""rpagp_torch's grid-path posteriors and diagnostics against the JAX
package, on the CPU: grid_posterior_cov, make_grid_predictor (with test
points beyond its margin), factor_diagnostics, the grid branches of
mll.posterior_cov and mll.make_predictor, train_fixed, and to_torch's
default device.

Both packages get the same numpy data, projections and raw
hyperparameters. The port runs its kernels' plain versions here. Bars:
posterior means, variances and covariances rel <= 1e-4 (as
grid_posterior's in tests/test_torch_port_grid.py: a p x p factor and
triangular solves in f32), the diagnostics' chosen levels rel <= 1e-6,
train_fixed's losses rel <= 1e-5 and final params relerr <= 1e-4.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rpagp import train as jtrain
from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops import grid_solve as jgs
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch import train
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import grid_solve
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import convert
from rpagp_torch.utils.convert import to_numpy, to_torch

# the module (the package's `mll` is the function, as rpagp's is)
tmll = importlib.import_module("rpagp_torch.mll")

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _setup(J, m, n, raw_ls=None, D=5, seed=0, **kw):
    """Both packages' (spec, params, buffers) and the data, the grid
    buffers prepared with y; raw_ls: every raw lengthscale (else drawn in
    [-0.5, 0.5])."""
    k = dict(J=J, d=1, base="rbf", proj_dist="gaussian", ski=True,
             grid_size=m)
    jspec = JModelSpec(kernel=JKernelSpec.polynomial(**k), **kw)
    spec = ModelSpec(kernel=KernelSpec.polynomial(**k), **kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.standard_normal(n)).astype(
        np.float32)
    xt = rng.standard_normal((90, D)).astype(np.float32)
    ls = (rng.uniform(-0.5, 0.5, J) if raw_ls is None
          else np.full(J, raw_ls)).astype(np.float32)
    jp, jb = jgp.init_model(jax.random.key(seed + 1), jspec, D)
    jp = {**jp, "raw_noise": jnp.float32(-1.5), "mean_const": jnp.float32(0.2),
          "kernel": {**jp["kernel"], "raw_lengthscale": jnp.asarray(ls),
                     "raw_outputscale": jnp.float32(0.3)}}
    # prepare_buffers' jitted program, called directly: the persistent AOT
    # cache that prepare_buffers goes through hands back arrays that
    # segfault numpy conversion in this jax build
    state, S4, uy, u1, vc = jgp._prepare_grid_y_jit(
        jspec, jp["kernel"], jb["kernel"], jnp.asarray(x), jnp.asarray(y))
    jb = {**jb, "ski_state": state, "ski_uu": S4, "ski_uy": uy,
          "ski_u1": u1, "ski_vc": vc}
    params = to_torch(jax.device_get(jp), device="cpu")
    kb = to_torch(jax.device_get({"kernel": jb["kernel"]}), device="cpu")
    buffers = exact_gp.prepare_buffers(spec, params, kb, torch.from_numpy(x),
                                       y_train=torch.from_numpy(y))
    return jspec, jp, jb, spec, params, buffers, x, y, xt


def _far_points(P):
    """Points whose every projection lies far beyond any grid: x = c v with
    P^T v = 1 (J <= D), so z_j = c for each component j."""
    v = P @ np.linalg.solve(P.T @ P, np.ones(P.shape[1]))
    c = np.array([-400.0, -60.0, 60.0, 400.0])
    return (c[:, None] * v[None, :]).astype(np.float32)


# (J, m, n, solver): auto-dispatched (p = 96 <= n / 2) and forced
# (p = 512 > n / 2: the p x p factor is one 512 leaf of the blocked
# elimination)
CASES = [(3, 32, 400, "auto"), (4, 128, 400, "grid")]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "J%d-m%d-n%d-%s" % c)
def setup(request):
    J, m, n, solver = request.param
    return _setup(J, m, n, solver=solver)


@pytest.mark.parametrize("observation_noise", [False, True])
def test_grid_posterior_cov_matches(setup, observation_noise):
    """Mean and full covariance against the JAX package; the diagonal is
    grid_posterior's variance, the covariance exactly symmetric, positive
    definite with the observation noise (the latent block is the exact
    K** less the SKI model's explained part, so f32 may leave it a hair
    indefinite, as the JAX package's), and mll.posterior_cov dispatches
    to it."""
    jspec, jp, jb, spec, params, buffers, x, y, xt = setup
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xt))
    muj, covj = jgs.grid_posterior_cov(jspec, jp, jb, jnp.asarray(x),
                                       jnp.asarray(y), jnp.asarray(xt),
                                       observation_noise=observation_noise)
    mu, cov = grid_solve.grid_posterior_cov(
        spec, params, buffers, *args, observation_noise=observation_noise)
    assert _rel(mu, muj) <= 1e-4
    assert _rel(cov, covj) <= 1e-4
    assert torch.equal(cov, cov.T)
    if observation_noise:
        assert bool(torch.linalg.cholesky_ex(cov).info == 0)
    mu2, var2 = grid_solve.grid_posterior(spec, params, buffers, *args,
                                          observation_noise=observation_noise)
    assert _rel(torch.diagonal(cov), var2) <= 1e-4
    assert _rel(mu, mu2) <= 1e-6
    assert tmll._solver(spec, x.shape[0]) == "grid"
    mu3, cov3 = tmll.posterior_cov(spec, params, buffers, *args,
                                   observation_noise=observation_noise)
    assert torch.equal(mu3, mu) and torch.equal(cov3, cov)


def test_make_grid_predictor_matches(setup):
    """The cached predictor against the JAX package's on test points
    inside the train range and far beyond its margin; the far points get
    zero taps, so the prior mean and the prior variance plus noise."""
    jspec, jp, jb, spec, params, buffers, x, y, xt = setup
    far = _far_points(buffers["kernel"]["proj"].numpy())
    xq = np.concatenate([xt, far])
    pj = jgs.make_grid_predictor(jspec, jp, jb, jnp.asarray(x),
                                 jnp.asarray(y))
    muj, varj = pj(jnp.asarray(xq))
    pt = grid_solve.make_grid_predictor(spec, params, buffers,
                                        torch.from_numpy(x),
                                        torch.from_numpy(y))
    mu, var = pt(torch.from_numpy(xq))
    assert _rel(mu, muj) <= 1e-4
    assert _rel(var, varj) <= 1e-4
    n_far = far.shape[0]
    noise = float(exact_gp.noise_value(params))
    prior = float(torch.sum(grid_solve._component_scales(
        spec.kernel, params["kernel"])))
    np.testing.assert_allclose(mu[-n_far:].numpy(),
                               float(params["mean_const"]), rtol=1e-6)
    np.testing.assert_allclose(var[-n_far:].numpy(), prior + noise,
                               rtol=1e-6)
    # inside the range it is the posterior of the margin-extended grid:
    # close to grid_posterior's, not equal (another grid)
    mu2, var2 = grid_solve.grid_posterior(spec, params, buffers,
                                          torch.from_numpy(x),
                                          torch.from_numpy(y),
                                          torch.from_numpy(xt))
    assert _rel(mu[:-n_far], mu2) <= 5e-2
    mu3, var3 = tmll.make_predictor(spec, params, buffers,
                                    torch.from_numpy(x),
                                    torch.from_numpy(y))(torch.from_numpy(xq))
    assert torch.equal(mu3, mu) and torch.equal(var3, var)


@pytest.mark.parametrize("raw_ls", [None, 2.5], ids=["base", "escalated"])
def test_factor_diagnostics_match(raw_ls):
    """The levels the two ladders chose at these params, against the JAX
    package's factor_diagnostics; long lengthscales on a 128-cell grid
    push the T-ladder past its base level."""
    jspec, jp, jb, spec, params, buffers, *_ = _setup(4, 128, 400,
                                                      raw_ls=raw_ls,
                                                      solver="grid")
    want = jgs.factor_diagnostics(jspec, jp, jb)
    got = grid_solve.factor_diagnostics(spec, params, buffers)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-12), k
    if raw_ls is not None:
        assert got["t_jitter_mult_max"] > 1.0
    assert all(type(v) is float for v in got.values())


def test_train_fixed_matches_reference_trajectory():
    """Five Adam steps on the grid MLL with no host read: the losses (left
    on the device) and the final params against the JAX package's
    train_fixed."""
    jspec, jp, jb, spec, params, buffers, x, y, _ = _setup(3, 32, 400)
    n = x.shape[0]
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    jparams, jlosses = jtrain.train_fixed(
        lambda p: -jgs.grid_mll(jspec, p, jb, xj, yj) / n, jp, lr=0.05,
        num_iters=5, optimizer=optax.adam(0.05))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out, losses = train.train_fixed(
        lambda p: -grid_solve.grid_mll(spec, p, buffers, xt, yt) / n, params,
        lr=0.05, num_iters=5)
    assert losses.shape == (5,) and not losses.requires_grad
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    num = den = 0.0
    for a, b in zip(jax.tree.leaves(to_numpy(out)),
                    jax.tree.leaves(jax.device_get(jparams))):
        num += float(np.sum((np.asarray(a, np.float64) - b) ** 2))
        den += float(np.sum(np.asarray(b, np.float64) ** 2))
    assert (num / den) ** 0.5 <= 1e-4
    # the caller's params are not modified
    assert float(params["raw_noise"]) == -1.5


def test_to_torch_defaults_to_the_card():
    """The port's rule: the card unless the caller asks for the CPU."""
    assert inspect.signature(convert.to_torch).parameters[
        "device"].default == "cuda"
    t = to_torch({"a": np.ones(3, np.float64)}, device="cpu")["a"]
    assert t.device.type == "cpu" and t.dtype == torch.float32
