"""rpagp_torch's kernels, projections and blocked factor for the dense
Cholesky branch against the JAX package, on the CPU.

The same seeded numpy inputs (params, projections, points) go through
each JAX function and its port: the full-D and limit Grams with their
gradients, the gram diagonal, the parameter trees of every kernel
family, space_equally on the same P, and the blocked factor of a dense
RPA Gram with the Pallas leaf (in interpret mode, as the JAX package's
own tests run it) against the port's (K1's plain version here). The
port's own projection draws are held to their distribution and shape:
RNG streams do not port. Tolerances: values rel <= 1e-5 (norm-wise),
gradients relerr <= 1e-4, the reference's own parity bar.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp import projections as jproj
from rpagp.ops import block_chol as jbc
from rpagp.ops import kernels as jk
from rpagp_torch import projections
from rpagp_torch.models import exact_gp
from rpagp_torch.ops import block_chol, kernels
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_relerr(ga, gb):
    num = sum(float(np.sum((np.asarray(ga[k], np.float64)
                            - np.asarray(gb[k], np.float64)) ** 2)) for k in gb)
    den = sum(float(np.sum(np.asarray(gb[k], np.float64) ** 2)) for k in gb)
    return math.sqrt(num / den)


def _spec_pair(family, ard=True):
    kw = dict(family=family, ard=ard)
    return jk.KernelSpec(**kw), KernelSpec(**kw)


def _params(family, ard, D, rng):
    n_ls = D if (ard and family in kernels.FULL_D_FAMILIES) else 1
    return {"raw_lengthscale": (0.4 * rng.standard_normal(n_ls) + 0.5)
            .astype(np.float32),
            "raw_outputscale": np.float32(0.3)}


def test_entry_points_default_to_the_card():
    """The port's rule: the card unless the caller asks for the CPU."""
    for fn in (exact_gp.init_model, kernels.init_kernel_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# every full-D family with ARD and with one shared lengthscale; the limit
# kernel has one shared lengthscale only
GRAM_CASES = ([(f, True) for f in kernels.FULL_D_FAMILIES]
              + [(f, False) for f in kernels.FULL_D_FAMILIES]
              + [(f, False) for f in kernels.LIMIT_FAMILIES])


@pytest.mark.parametrize("family,ard", GRAM_CASES,
                         ids=[f"{f}-{'ard' if a else 'shared'}"
                              for f, a in GRAM_CASES])
def test_full_d_and_limit_gram_match(family, ard):
    """K(x, x) (exact zeros on the squared distances' diagonal) and
    K(x, x') against the JAX package, values and the gradient of a
    random projection of each, wrt the raw params."""
    jspec, spec = _spec_pair(family, ard)
    rng = np.random.default_rng(3)
    D = 6
    params = _params(family, ard, D, rng)
    x = rng.standard_normal((70, D)).astype(np.float32)
    x2 = rng.standard_normal((40, D)).astype(np.float32)
    R1 = rng.standard_normal((70, 70)).astype(np.float32)
    R2 = rng.standard_normal((70, 40)).astype(np.float32)

    def jloss(p):
        xj = jnp.asarray(x)
        K1 = jk.gram(jspec, p, {}, xj, xj)
        K2 = jk.gram(jspec, p, {}, xj, jnp.asarray(x2))
        return jnp.sum(K1 * R1) + jnp.sum(K2 * R2), (K1, K2)

    (vj, (K1j, K2j)), gj = jax.value_and_grad(jloss, has_aux=True)(params)
    p = to_torch(params, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x)
    K1 = kernels.gram(spec, p, {}, xt, xt)
    K2 = kernels.gram(spec, p, {}, xt, torch.from_numpy(x2))
    (torch.sum(K1 * torch.from_numpy(R1))
     + torch.sum(K2 * torch.from_numpy(R2))).backward()
    assert _rel(K1.detach(), K1j) <= 1e-5
    assert _rel(K2.detach(), K2j) <= 1e-5
    assert torch.all(torch.diagonal(K1) == torch.diagonal(K1)[0])
    assert _grad_relerr({k: t.grad for k, t in p.items()}, gj) <= 1e-4
    d = kernels.gram_diag(spec, p, {}, xt)
    np.testing.assert_allclose(d.detach().numpy(),
                               np.asarray(jk.gram_diag(jspec, params, {},
                                                       jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("family", ["matern12", "matern32", "matern52"])
def test_matern_gradient_at_zero_distance(family):
    """Reverse mode through K(x, x) wrt the inputs: the diagonal's r = 0
    (sqrt(sq + 1e-20), |t| with sign(0) = 0) gives finite gradients equal
    to the JAX package's."""
    jspec, spec = _spec_pair(family)
    rng = np.random.default_rng(4)
    params = _params(family, True, 3, rng)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    R = rng.standard_normal((20, 20)).astype(np.float32)
    gxj = jax.grad(lambda xx: jnp.sum(jk.gram(jspec, params, {}, xx, xx) * R))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sum(kernels.gram(spec, to_torch(params, device="cpu"), {}, xt, xt)
              * torch.from_numpy(R)).backward()
    assert bool(torch.isfinite(xt.grad).all())
    assert _rel(xt.grad, gxj) <= 1e-4


@pytest.mark.parametrize("kind", ["rbf", "matern52", "rp_limit_rbf",
                                  "projection", "learned_percomp"])
def test_init_kernel_params_trees_match(kind):
    """The same keys, shapes and initial values as the JAX package's; an
    explicit projection is used as given."""
    D = 7
    if kind == "projection":
        kw = dict(J=4, d=2, base="rbf")
        jspec, spec = (jk.KernelSpec.polynomial(**kw),
                       KernelSpec.polynomial(**kw))
    elif kind == "learned_percomp":
        kw = dict(J=5, d=1, learn_proj=True, per_component_scale=True)
        jspec, spec = (jk.KernelSpec.polynomial(**kw),
                       KernelSpec.polynomial(**kw))
    else:
        jspec, spec = _spec_pair(kind)
    jp, jb = jax.device_get(jk.init_kernel_params(jax.random.key(0), jspec, D))
    proj = jp.get("proj", jb.get("proj"))
    p, b = kernels.init_kernel_params(spec, D, proj=proj, device="cpu")
    for ref, port in ((jp, p), (jb, b)):
        assert sorted(ref) == sorted(port)
        for k in ref:
            assert tuple(port[k].shape) == tuple(np.shape(ref[k]))
            np.testing.assert_array_equal(to_numpy(port[k]), ref[k])


@pytest.mark.parametrize("dist", projections.DISTRIBUTIONS)
def test_gen_rp_distribution(dist):
    """Shape, dtype and the distribution's moments on a large draw; axes
    bit for bit the JAX package's; the same generator state repeats."""
    D, M = 16, 4000
    P = projections.gen_rp(D, M, dist, torch.Generator().manual_seed(0))
    assert P.shape == (D, M) and P.dtype == torch.float32
    again = projections.gen_rp(D, M, dist, torch.Generator().manual_seed(0))
    assert torch.equal(P, again)
    Pn = P.numpy().astype(np.float64)
    col = np.sum(Pn ** 2, axis=0)
    if dist == "axes":
        np.testing.assert_array_equal(
            Pn, np.asarray(jproj.gen_rp(None, D, M, "axes")))
        return
    if dist == "sphere":
        np.testing.assert_allclose(col, 1.0, rtol=1e-5)
    elif dist in ("rademacher", "bernoulli"):
        np.testing.assert_allclose(np.abs(Pn), 1.0 / math.sqrt(D), rtol=1e-6)
        assert abs(np.mean(Pn > 0) - 0.5) < 0.01
    elif dist == "uniform":
        lim = math.sqrt(3.0 / D)
        assert np.all(np.abs(Pn) <= lim)
        # U(-lim, lim): variance lim^2 / 3 = 1 / D
        assert abs(np.var(Pn) * D - 1.0) < 0.02
    # every family but the sphere's has E|p|^2 = 1 (the sphere's exactly)
    assert abs(np.mean(col) - 1.0) < 0.01
    assert abs(np.mean(Pn)) < 0.01 / math.sqrt(D)


def test_gen_rp_rejects_unknown_distribution():
    with pytest.raises(ValueError, match="unknown projection"):
        projections.gen_rp(3, 2, "cauchy")


@pytest.mark.parametrize("shape", [(6, 10), (26, 20)])
def test_space_equally_matches_jax(shape):
    """500 descent steps from the same P: the spaced directions and the
    final coherence agree with the JAX package's, and the coherence fell."""
    P = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    Qj, lj = jax.device_get(jproj.space_equally(jnp.asarray(P)))
    Q, loss = projections.space_equally(torch.from_numpy(P))
    assert _rel(Q, Qj) <= 1e-5
    assert float(loss) == pytest.approx(float(lj), rel=1e-4)
    P0 = P / np.linalg.norm(P, axis=0, keepdims=True)
    G0 = P0.T @ P0
    assert float(loss) < np.sum((G0 - np.diag(np.diag(G0))) ** 2)
    np.testing.assert_allclose(torch.linalg.norm(Q, dim=0).numpy(), 1.0,
                               rtol=1e-6)


def test_space_proj_init_spaces_the_draw():
    """init_kernel_params with space_proj spaces its own gaussian draw:
    the buffer is space_equally of gen_rp from the same generator state."""
    spec = KernelSpec.polynomial(J=6, d=1, space_proj=True)
    _, b = kernels.init_kernel_params(
        spec, 5, generator=torch.Generator().manual_seed(2), device="cpu")
    P = projections.gen_rp(5, 6, "gaussian",
                           torch.Generator().manual_seed(2))
    assert torch.equal(b["proj"], projections.space_equally(P)[0])


def test_blocked_cholesky_with_pallas_leaf_on_a_dense_rpa_gram():
    """A dense RPA Khat (n = 300, J = 6 degree-1 RBF components + noise):
    the port's blocked factor with block 128 (K1's plain version on three
    leaves, the last padded) against the JAX package's with the Pallas
    leaf in interpret mode; value and gradient of vdot(L, R) + logdet."""
    n, D, J = 300, 5, 6
    rng = np.random.default_rng(6)
    jspec = jk.KernelSpec.polynomial(J=J)
    spec = KernelSpec.polynomial(J=J)
    jp, jb = jax.device_get(jk.init_kernel_params(jax.random.key(1), jspec, D))
    x = rng.standard_normal((n, D)).astype(np.float32)
    K = np.asarray(jk.gram(jspec, jp, jb, jnp.asarray(x), jnp.asarray(x)))
    Khat = (K + 0.1 * np.eye(n)).astype(np.float32)
    R = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    assert _rel(kernels.gram(spec, to_torch(jp, device="cpu"),
                             to_torch(jb, device="cpu"),
                             torch.from_numpy(x), torch.from_numpy(x)),
                K) <= 1e-5

    def jloss(A):
        L = jbc.blocked_cholesky(0.5 * (A + A.T), block=128,
                                 leaf="interpret")
        return jnp.vdot(L, R) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))

    vj, gj = jax.value_and_grad(jloss)(jnp.asarray(Khat))
    A = torch.from_numpy(Khat).requires_grad_(True)
    L = block_chol.blocked_cholesky(0.5 * (A + A.T), block=128)
    v = torch.sum(L * torch.from_numpy(R)) + 2.0 * torch.sum(
        torch.log(torch.diagonal(L)))
    v.backward()
    assert _rel(float(v.detach()), float(vj)) <= 1e-5
    assert _rel(A.grad, gj) <= 1e-4


def test_full_d_mvm_matches_jax():
    """The blocked kernel MVM of a full-D kernel (the BBMM branch's MVM for
    exact_rbf above max_cholesky_size; K4 does not apply to it) against
    the JAX package's, with row blocks smaller than n."""
    jspec, spec = _spec_pair("matern32")
    rng = np.random.default_rng(7)
    params = _params("matern32", True, 4, rng)
    x = rng.standard_normal((90, 4)).astype(np.float32)
    V = rng.standard_normal((90, 3)).astype(np.float32)
    want = jk.mvm(jspec, params, {}, jnp.asarray(x), jnp.asarray(x),
                  jnp.asarray(V), block_rows=32)
    got = kernels.mvm(spec, to_torch(params, device="cpu"), {},
                      torch.from_numpy(x),
                      torch.from_numpy(x), torch.from_numpy(V),
                      block_rows=32)
    assert _rel(got, want) <= 1e-5
