"""rpagp_torch's product SKI (degree * sub_dim > 1 components) against the
JAX package, on the CPU: kron_fold, the two Khatri-Rao interpolation
directions (adjointness and gradients), build_interp_gram, the prepared
grid buffers, grid_mll's value and gradient (degree 2, sub_dim 2 and
mixed bases), grid_posterior, grid_posterior_cov, make_grid_predictor,
factor_diagnostics, the product dispatch's errors and warning, and
run_split on specs/rp_ski_d2_j6.json.

Both packages get the same numpy data, projections and raw
hyperparameters (carried with rpagp_torch.utils.convert). The port runs
K1's plain version here (the product path launches no other kernel). The
JAX package's buffers come from its jitted prepare program, called
directly, as tests/test_torch_port_grid.py does. Bars: values rel
<= 1e-5, gradients relerr <= 1e-4 (tests/test_grid_sharding.py's
measure); the posteriors rel <= 1e-4 (a p x p factor and triangular
solves in f32, as tests/test_torch_port_grid.py holds grid_posterior).
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
from rpagp.ops import grid_solve as jgs
from rpagp.ops import ski_product as jsp
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch import runner
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import grid_solve, ski, ski_product
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import datasets
from rpagp_torch.utils.config import load_spec
from rpagp_torch.utils.convert import to_numpy, to_torch

# the module (the package's `mll` is the function, as rpagp's is)
tmll = importlib.import_module("rpagp_torch.mll")

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_relerr(ga, gb):
    la, lb = jax.tree.leaves(ga), jax.tree.leaves(gb)
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
              for a, b in zip(la, lb))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in lb)
    return (num / max(den, 1e-30)) ** 0.5


def _kspecs(J, d, k, m, bases=None):
    """The same product KernelSpec in both packages: J components of
    degree d and sub_dim k on an m-point grid per factor, one base or
    `bases` (one per component)."""
    kw = dict(proj_dist="gaussian", ski=True, grid_size=m)
    if bases is None:
        return (JKernelSpec.polynomial(J=J, d=d, k=k, base="rbf", **kw),
                KernelSpec.polynomial(J=J, d=d, k=k, base="rbf", **kw))
    return (JKernelSpec.generalized((d,) * J, bases, **kw),
            KernelSpec.generalized((d,) * J, bases, **kw))


def _setup(J=3, d=2, k=1, m=16, n=400, bases=None, D=6, seed=0, **kw):
    """Both packages' (spec, params, buffers) and the data (numpy), the grid
    buffers prepared with y; raw hyperparameters away from their zero
    init."""
    jk, tk = _kspecs(J, d, k, m, bases)
    jspec, spec = JModelSpec(kernel=jk, **kw), ModelSpec(kernel=tk, **kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0] - x[:, 1])
         + 0.3 * rng.standard_normal(n)).astype(np.float32)
    jp, jb = jgp.init_model(jax.random.key(seed + 1), jspec, D)
    ls = rng.uniform(-0.3, 0.3, jk.num_lengthscales).astype(np.float32)
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
    return jspec, jp, jb, spec, params, buffers, x, y


@pytest.fixture(scope="module")
def d2():
    """J = 3 degree-2 RBF components, m = 16: M = 256, p = 768."""
    return _setup()


def _leaves(params):
    """The params tree with every tensor a fresh leaf that wants grad."""
    return {k: (v.clone().requires_grad_(True) if not isinstance(v, dict)
                else {kk: vv.clone().requires_grad_(True)
                      for kk, vv in v.items()})
            for k, v in params.items()}


def _grads(p):
    return {k: (p[k].grad if not isinstance(p[k], dict)
                else {kk: vv.grad for kk, vv in p[k].items()}) for k in p}


# ------------------------------------------------------- the pieces ----


def test_kron_fold_matches_jax():
    """(2, 3, 4, 4) -> (2, 64, 64), three factors folded in order."""
    mats = np.random.default_rng(0).standard_normal((2, 3, 4, 4)).astype(
        np.float32)
    out = ski_product.kron_fold(torch.from_numpy(mats))
    ref = np.asarray(jsp.kron_fold(jnp.asarray(mats)))
    assert _rel(out, ref) <= 1e-6
    np.testing.assert_allclose(
        out[1].numpy(), np.kron(np.kron(mats[1, 0], mats[1, 1]), mats[1, 2]),
        rtol=2e-6, atol=1e-6)


def test_geometry_has_one_row_per_factor(d2):
    """build_ski_factors: Jf = J * F rows, each field as the JAX package's
    (and as to_torch carries the JAX package's state and its per-factor
    lengthscales); build_ski refuses a product spec, as the JAX package's
    does."""
    jspec, jp, jb, spec, params, buffers, x, y = d2
    st, stj = buffers["ski_state"], jb["ski_state"]
    assert st.tfrac.shape == (6, 400) and st.m == 16
    carried = to_torch(jax.device_get(stj), device="cpu")
    for f in ("grid_lo", "h", "cells", "tfrac"):
        assert _rel(getattr(st, f), getattr(stj, f)) <= 1e-5, f
        assert torch.equal(getattr(carried, f),
                           torch.from_numpy(np.array(getattr(stj, f))))
    assert params["kernel"]["raw_lengthscale"].shape == (6,)
    assert _rel(ski_product.factor_lengthscales(spec.kernel, params["kernel"]),
                jsp.factor_lengthscales(jspec.kernel, jp["kernel"])) <= 1e-6
    with pytest.raises(ValueError, match="degree-1"):
        ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"],
                      torch.from_numpy(x), 16)


@pytest.mark.parametrize("direction", ["transpose", "apply_sum"])
def test_interp_matches_jax_with_gradient(d2, direction):
    """Each Khatri-Rao direction at t = 3: value rel <= 1e-5 and the
    gradient of sum(sin(out)) (the other direction, as the JAX package's
    custom_vjp pair) relerr <= 1e-4."""
    jspec, jp, jb, spec, params, buffers, x, y = d2
    st, stj = buffers["ski_state"], jb["ski_state"]
    rng = np.random.default_rng(3)
    if direction == "transpose":
        a = rng.standard_normal((400, 3)).astype(np.float32)
        jf = lambda v: jsp.interp_transpose(jspec.kernel, stj, v)
        tf = lambda v: ski_product.interp_transpose(spec.kernel, st, v)
    else:
        a = rng.standard_normal((3, 3, 256)).astype(np.float32)
        jf = lambda g: jsp.interp_apply_sum(jspec.kernel, stj, g)
        tf = lambda g: ski_product.interp_apply_sum(spec.kernel, st, g)
    vj, gj = jax.value_and_grad(lambda v: jnp.sum(jnp.sin(jf(v))))(
        jnp.asarray(a))
    out = tf(torch.from_numpy(a))
    assert _rel(out.detach(), np.asarray(jf(jnp.asarray(a)))) <= 1e-5
    v = torch.from_numpy(a).requires_grad_(True)
    torch.sum(torch.sin(tf(v))).backward()
    assert abs(float(torch.sum(torch.sin(out))) - float(vj)) <= 1e-5 * max(
        1.0, abs(float(vj)))
    assert _rel(v.grad, np.asarray(gj)) <= 1e-4


def test_interp_directions_are_adjoint(d2):
    """<U, W^T V> = <W U, V> to f32 rounding: the backward of each
    direction is the other."""
    _, _, _, spec, _, buffers, _, _ = d2
    st = buffers["ski_state"]
    g = torch.Generator().manual_seed(5)
    V, U = torch.randn(400, 3, generator=g), torch.randn(3, 3, 256, generator=g)
    lhs = torch.sum(U * ski_product.interp_transpose(spec.kernel, st, V))
    rhs = torch.sum(ski_product.interp_apply_sum(spec.kernel, st, U) * V)
    assert abs(float(lhs - rhs)) <= 1e-5 * float(
        torch.linalg.norm(U) * torch.linalg.norm(V))


def test_prepared_buffers_match(d2):
    """S = U^T U (build_interp_gram), U^T y, U^T 1 and the value cache."""
    jspec, jp, jb, spec, params, buffers, x, y = d2
    assert buffers["ski_uu"].shape == (3, 256, 3, 256)
    for key in ("ski_uu", "ski_uy", "ski_u1"):
        assert _rel(buffers[key], jb[key]) <= 1e-5, key
    S = ski_product.build_interp_gram(spec.kernel, buffers["ski_state"])
    assert _rel(S, jsp.build_interp_gram(jspec.kernel, jb["ski_state"])) \
        <= 1e-5
    vc, vcj = buffers["ski_vc"], jb["ski_vc"]
    for key in ("a0", "sy", "yy"):
        assert _rel(vc[key], vcj[key]) <= 1e-5, key
    # the ridge anchor is a solve against S + delta I (conditioning ~1e3)
    assert _rel(vc["q0"], vcj["q0"]) <= 1e-4


# ------------------------------------------------------- the solver ----


@pytest.mark.parametrize("case", ["d2", "sub_dim2", "mixed_bases"])
def test_grid_mll_value_and_gradient_match(d2, case):
    """degree 2 (the spec's shape at J = 3); degree 1 with sub_dim 2; and
    degree 2 over rbf, matern32 and rbf components (the per-base row split
    of the factor Toeplitz columns)."""
    if case == "d2":
        s = d2
    elif case == "sub_dim2":
        s = _setup(J=3, d=1, k=2, m=16, n=400, seed=1)
    else:
        s = _setup(J=3, d=2, m=12, n=300, seed=2,
                   bases=("rbf", "matern32", "rbf"))
    jspec, jp, jb, spec, params, buffers, x, y = s
    assert grid_solve.use_grid_solver(spec, x.shape[0])
    vj, gj = jax.value_and_grad(lambda p: jgs.grid_mll(
        jspec, p, jb, jnp.asarray(x), jnp.asarray(y)))(jp)
    p = _leaves(params)
    v = grid_solve.grid_mll(spec, p, buffers, torch.from_numpy(x),
                            torch.from_numpy(y))
    v.backward()
    assert abs(float(v.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    assert _grad_relerr(to_numpy(_grads(p)), jax.device_get(gj)) <= 1e-4


def test_grid_mll_without_y_cache_matches(d2):
    """Buffers prepared without y: U^T yc through the Khatri-Rao
    transpose every step and the residual form of the inv-quad value."""
    jspec, jp, jb, spec, params, buffers, x, y = d2
    keep = ("kernel", "ski_state", "ski_uu")
    jbk, bk = {k: jb[k] for k in keep}, {k: buffers[k] for k in keep}
    vj, gj = jax.value_and_grad(lambda p: jgs.grid_mll(
        jspec, p, jbk, jnp.asarray(x), jnp.asarray(y)))(jp)
    p = _leaves(params)
    v = grid_solve.grid_mll(spec, p, bk, torch.from_numpy(x),
                            torch.from_numpy(y))
    v.backward()
    assert abs(float(v.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    assert _grad_relerr(to_numpy(_grads(p)), jax.device_get(gj)) <= 1e-4


def test_factor_diagnostics_match(d2):
    """The two ladders' chosen levels: the factor ladder runs on the
    (J * F, m, m) factor Toeplitz blocks."""
    jspec, jp, jb, spec, params, buffers, x, y = d2
    dj = jgs.factor_diagnostics(jspec, jp, jb)
    dt = grid_solve.factor_diagnostics(spec, params, buffers)
    for k in ("t_jitter_mult_max", "c_jitter_over_noise"):
        assert dt[k] == pytest.approx(dj[k], rel=1e-6, abs=1e-12), k


def test_grid_posteriors_match(d2):
    """grid_posterior (mean, variance), grid_posterior_cov (mean, full
    covariance) on the union grid, and make_grid_predictor on the margin
    grid, each against the JAX package's."""
    jspec, jp, jb, spec, params, buffers, x, y = d2
    xt = np.random.default_rng(7).standard_normal((60, 6)).astype(np.float32)
    args_j = (jspec, jp, jb, jnp.asarray(x), jnp.asarray(y))
    args_t = (spec, params, buffers, torch.from_numpy(x), torch.from_numpy(y))
    xtj, xtt = jnp.asarray(xt), torch.from_numpy(xt)
    muj, varj = jgs.grid_posterior(*args_j, xtj)
    mu, var = grid_solve.grid_posterior(*args_t, xtt)
    assert _rel(mu, muj) <= 1e-4 and _rel(var, varj) <= 1e-4
    muj, covj = jgs.grid_posterior_cov(*args_j, xtj)
    mu, cov = grid_solve.grid_posterior_cov(*args_t, xtt)
    assert _rel(mu, muj) <= 1e-4 and _rel(cov, covj) <= 1e-4
    assert cov.shape == (60, 60)
    muj, varj = jgs.make_grid_predictor(*args_j)(xtj)
    mu, var = grid_solve.make_grid_predictor(*args_t)(xtt)
    assert _rel(mu, muj) <= 1e-4 and _rel(var, varj) <= 1e-4
    # the mll module's dispatch takes the grid branch for a product spec
    assert tmll._solver(spec, x.shape[0]) == "grid"
    mu2, var2 = tmll.posterior(spec, params, buffers, torch.from_numpy(x),
                               torch.from_numpy(y), xtt)
    assert torch.equal(mu2, grid_solve.grid_posterior(*args_t, xtt)[0])


# ----------------------------------------------------- the dispatch ----


def test_dispatch_errors_and_warning():
    """solver="bbmm" raises; p = J m^F past _P_MAX raises under "auto" and
    warns under "grid"; a degree-1 spec keeps its own policy; product
    specs need uniform degrees."""
    _, k = _kspecs(J=6, d=2, k=1, m=16)
    assert ski_product.grid_rank(k) == 1536
    assert grid_solve.use_grid_solver(ModelSpec(kernel=k), 10)
    with pytest.raises(ValueError, match="bbmm"):
        grid_solve.use_grid_solver(ModelSpec(kernel=k, solver="bbmm"), 10)
    _, big = _kspecs(J=10, d=2, k=1, m=32)
    assert ski_product.grid_rank(big) == 10240 > grid_solve._P_MAX
    with pytest.raises(ValueError, match="budget"):
        grid_solve.use_grid_solver(ModelSpec(kernel=big), 10**6)
    with pytest.warns(UserWarning, match="exceeds"):
        assert grid_solve.use_grid_solver(ModelSpec(kernel=big,
                                                    solver="grid"), 10**6)
    _, one = _kspecs(J=20, d=1, k=1, m=512)
    assert not ski_product.is_product(one)
    assert not grid_solve.use_grid_solver(ModelSpec(kernel=one), 10**6)
    mixed = KernelSpec.generalized((1, 2), ("rbf", "rbf"), ski=True,
                                   grid_size=8)
    with pytest.raises(ValueError, match="uniform"):
        ski_product.factors_per_component(mixed)


def test_run_split_on_the_product_spec():
    """run_split on specs/rp_ski_d2_j6.json (J = 6, degree 2, m = 16: p =
    1536 on the grid solver) for 3 steps on a 500-point split of synthetic
    protein (D = 9): the grid path end to end, finite metrics, and the
    loss it returns is -grid_mll / n at the trained params."""
    exp = load_spec(os.path.join(ROOT, "specs", "rp_ski_d2_j6.json"))
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=3))
    ds = datasets.load_dataset("protein", max_points=500)
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    n = split.train_x.shape[0]
    assert tmll._solver(exp.model, n) == "grid"
    grid_solve.reset_stats()
    m = runner.run_split(exp, split, seed=0, device="cpu")
    assert m["iterations"] == 3 and m["n_train"] == n
    assert grid_solve.stats["host_reads"] > 0
    for k in ("rmse", "nll", "mll"):
        assert math.isfinite(m[k]), (k, m)
