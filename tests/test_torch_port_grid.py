"""rpagp_torch's exact grid-solver slice against the JAX package, on the CPU.

Both packages get the same numpy data, projections and raw
hyperparameters (carried across with rpagp_torch.utils.convert). The
port runs its kernels' plain versions here. Compared: the prepared
per-dataset buffers, grid_mll value and gradient, grid_posterior mean and
variance, and the two jitter ladders' chosen levels. Bars: value rel
<= 1e-5, gradient relerr <= 1e-4 (tests/test_grid_sharding.py's
measure), posterior rel <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops import grid_solve as jgs
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import grid_solve
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)

# raw hyperparameters away from the zero init, so every term is exercised
_RAW = {"raw_noise": -1.5, "mean_const": 0.2, "raw_outputscale": 0.3}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_relerr(ga, gb):
    la = jax.tree.leaves(ga)
    lb = jax.tree.leaves(gb)
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
              for a, b in zip(la, lb))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in lb)
    return (num / max(den, 1e-30)) ** 0.5


def _specs(J, m, **kw):
    k = dict(J=J, d=1, base="rbf", proj_dist="gaussian", ski=True,
             grid_size=m)
    return (JModelSpec(kernel=JKernelSpec.polynomial(**k), **kw),
            ModelSpec(kernel=KernelSpec.polynomial(**k), **kw))


def _setup(J, m, n, D=6, seed=0, **kw):
    """Both packages' (spec, params, buffers, x, y), prepared with y."""
    jspec, spec = _specs(J, m, **kw)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.standard_normal(n)).astype(np.float32)
    jp, jb = jgp.init_model(jax.random.key(seed + 1), jspec, D)
    jp = {**jp, "raw_noise": jnp.float32(_RAW["raw_noise"]),
          "mean_const": jnp.float32(_RAW["mean_const"]),
          "kernel": {**jp["kernel"],
                     "raw_lengthscale": jnp.asarray(
                         rng.uniform(-0.5, 0.5, J), jnp.float32),
                     "raw_outputscale": jnp.float32(_RAW["raw_outputscale"])}}
    # prepare_buffers' jitted program, called directly: the persistent AOT
    # cache that prepare_buffers goes through hands back arrays that
    # segfault numpy conversion in this jax build
    state, S4, uy, u1, vc = jgp._prepare_grid_y_jit(
        jspec, jp["kernel"], jb["kernel"], jnp.asarray(x), jnp.asarray(y))
    jb = {**jb, "ski_state": state, "ski_uu": S4, "ski_uy": uy,
          "ski_u1": u1, "ski_vc": vc}
    params = to_torch(jax.device_get(jp))
    buffers = exact_gp.prepare_buffers(
        spec, params, to_torch(jax.device_get({"kernel": jb["kernel"]})),
        torch.from_numpy(x), y_train=torch.from_numpy(y))
    return (jspec, jp, jb, spec, params, buffers, jnp.asarray(x),
            jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y))


# (J, m, n): the second has p = 640 > 512, so the p x p factor goes
# through the blocked elimination with the K1 leaf
SHAPES = [(4, 32, 2048), (5, 128, 4096)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "J%d-m%d-n%d" % s)
def setup(request):
    return _setup(*request.param)


def test_prepared_buffers_match(setup):
    jspec, jp, jb, spec, params, buffers, xj, yj, x, y = setup
    # the JAX geometry, carried across, is the port's SKIState
    st = to_torch(jax.device_get(jb["ski_state"]))
    for f in st._fields:
        assert _rel(getattr(buffers["ski_state"], f), getattr(st, f)) <= 1e-5, f
    for key in ("ski_uu", "ski_uy", "ski_u1"):
        assert _rel(buffers[key], jb[key]) <= 1e-5, key
    vc, vcj = buffers["ski_vc"], jb["ski_vc"]
    for key in ("a0", "sy", "yy"):
        assert _rel(vc[key], vcj[key]) <= 1e-5, key
    # the ridge anchor is a solve against S + delta I, conditioning ~1e3
    assert _rel(vc["q0"], vcj["q0"]) <= 1e-4
    # a1 = sum(r) cancels (|a1| << sum|r|): hold it to the anchor's bar,
    # relative to the size of its summands
    state = buffers["ski_state"]
    r = y - grid_solve.ski.dense_interp_apply_sum(
        state, vc["q0"][:, None, :])[:, 0]
    assert abs(float(vc["a1"]) - float(vcj["a1"])) <= 1e-4 * float(
        torch.sum(torch.abs(r)))


def _check_grid_mll(jspec, jp, jb, spec, params, buffers, xj, yj, x, y):
    vj, gj = jax.value_and_grad(
        lambda p: jgs.grid_mll(jspec, p, jb, xj, yj))(jp)
    p = {k: (v.clone().requires_grad_(True) if not isinstance(v, dict)
             else {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
         for k, v in params.items()}
    v = grid_solve.grid_mll(spec, p, buffers, x, y)
    v.backward()
    g = {k: (p[k].grad if not isinstance(p[k], dict)
             else {kk: vv.grad for kk, vv in p[k].items()}) for k in p}
    assert abs(float(v.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    assert _grad_relerr(to_numpy(g), jax.device_get(gj)) <= 1e-4


def test_grid_mll_value_and_gradient_match(setup):
    _check_grid_mll(*setup)


def test_grid_mll_without_y_cache_matches():
    """Buffers prepared without y: U^T yc costs one interp pass per step
    and the inv-quad value is the n-space residual form (_resid_iq)."""
    jspec, jp, jb, spec, params, buffers, xj, yj, x, y = _setup(3, 32, 1500)
    keep = ("kernel", "ski_state", "ski_uu")
    _check_grid_mll(jspec, jp, {k: jb[k] for k in keep}, spec, params,
                    {k: buffers[k] for k in keep}, xj, yj, x, y)


def test_grid_posterior_matches(setup):
    jspec, jp, jb, spec, params, buffers, xj, yj, x, y = setup
    rng = np.random.default_rng(7)
    xt = rng.standard_normal((300, x.shape[1])).astype(np.float32)
    muj, varj = jgs.grid_posterior(jspec, jp, jb, xj, yj, jnp.asarray(xt))
    mu, var = grid_solve.grid_posterior(spec, params, buffers, x, y,
                                        torch.from_numpy(xt))
    assert _rel(mu, muj) <= 1e-4
    assert _rel(var, varj) <= 1e-4


def test_chol_ladder_handles_flagship_grid_conditioning():
    """m=256: chol(T + 1e-6 I) fails, the ladder keeps value and gradient
    finite, and it picks the same per-block jitter levels as the JAX
    ladder on the same Toeplitz blocks."""
    jspec, jp, jb, spec, params, buffers, xj, yj, x, y = _setup(
        4, 256, 2000, solver="grid")
    Tj = jgs._toeplitz_blocks(jspec.kernel, jp["kernel"], jb["ski_state"])
    T = torch.from_numpy(np.array(Tj))
    assert _rel(grid_solve._toeplitz_blocks(spec.kernel, params["kernel"],
                                            buffers["ski_state"]), Tj) <= 1e-5
    eye = torch.eye(256)
    assert not bool((torch.linalg.cholesky_ex(T + 1e-6 * eye).info == 0).all())

    p = {k: (v.clone().requires_grad_(True) if not isinstance(v, dict)
             else {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
         for k, v in params.items()}
    v = grid_solve.grid_mll(spec, p, buffers, x, y)
    v.backward()
    assert np.isfinite(float(v.detach()))
    assert all(bool(torch.isfinite(t.grad).all())
               for t in (p["raw_noise"], p["mean_const"],
                         *p["kernel"].values()))

    eps0j = jspec.grid_jitter * Tj[:, 0, 0]
    _, eps_j = jgs._chol_ladder(Tj, eps0j)
    _, eps = grid_solve._chol_ladder(T, spec.grid_jitter * T[:, 0, 0])
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_j), rtol=1e-6)
    assert float(torch.max(eps / T[:, 0, 0])) <= 1e-3


def test_chol_with_fallback_handles_rounding_indefiniteness():
    """(a) a healthy C gets no jitter and the plain factor; (b) a
    rounding-indefinite C gets the same level as the JAX ladder and a
    finite factor within the chosen jitter."""
    p, noise = 256, 0.2
    A = np.random.default_rng(0).standard_normal((p, 32)).astype(np.float32)
    C = (A @ A.T + noise * np.eye(p)).astype(np.float32)
    nz = torch.tensor(noise)

    L0, e0 = grid_solve._chol_with_fallback_eps(torch.from_numpy(C), nz)
    assert float(e0) == 0.0
    np.testing.assert_array_equal(
        L0.numpy(), torch.linalg.cholesky(torch.from_numpy(C)).numpy())

    Cbad = (C - 1.1 * noise * np.eye(p)).astype(np.float32)
    assert not bool(torch.linalg.cholesky_ex(torch.from_numpy(Cbad)).info == 0)
    Lf, e = grid_solve._chol_with_fallback_eps(torch.from_numpy(Cbad), nz)
    _, ej = jgs._chol_with_fallback_eps(jnp.asarray(Cbad), jnp.float32(noise))
    assert float(e) == pytest.approx(float(ej), rel=1e-6) and float(e) > 0
    assert bool(torch.isfinite(Lf).all())
    err = torch.max(torch.abs(Lf @ Lf.T - torch.from_numpy(Cbad)))
    assert float(err) <= grid_solve._C_LEVELS[-1] * noise + 1e-4
