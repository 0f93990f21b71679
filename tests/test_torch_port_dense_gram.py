"""The dense projected Gram's plain twins (rpagp_torch/ops/cuda_gram.py
`dense_gram_plain`, `dense_gram_bwd_plain`, behind `cuda_gram.dense_gram`,
the CPU side of K6 / K7) against the JAX package, on the CPU.

A float32 Gram of a spec that `cuda_gram.dense_supports` accepts, SKI
aside, goes through
`cuda_gram.dense_gram` in `kernels._projection_gram`; on the CPU that is
the twins: the value by row blocks and the gradients by their closed
form. The same seeded numpy inputs go to the JAX package's
`_projection_gram` and `jax.grad`: every base, K(x, x) and a cross Gram
(n != m), the projection learned and fixed, a cotangent that is not
symmetric. Tolerances: values rel <= 1e-5 (norm-wise), gradients relerr
<= 1e-4, the reference's own parity bar. The card's tests hold the
kernels to the twins (tests/test_torch_port_cuda.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import kernels as jk
from rpagp_torch.ops import cuda_gram, kernels
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils.convert import to_torch

torch.set_num_threads(2)

J, D = 6, 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_relerr(ga, gb):
    num = sum(float(np.sum((np.asarray(ga[k], np.float64)
                            - np.asarray(gb[k], np.float64)) ** 2)) for k in gb)
    den = sum(float(np.sum(np.asarray(gb[k], np.float64) ** 2)) for k in gb)
    return math.sqrt(num / den)


def _case(learn_proj, seed=0):
    """(params, buffers) as numpy trees, points x (n, D), x2 (m, D), and
    cotangents of K(x, x) and K(x, x2), neither symmetric."""
    rng = np.random.default_rng(seed)
    proj = (rng.standard_normal((D, J)) / math.sqrt(D)).astype(np.float32)
    params = {"raw_lengthscale": (0.4 * rng.standard_normal(J) - 0.2)
              .astype(np.float32), "raw_outputscale": np.float32(0.3)}
    buffers = {}
    (params if learn_proj else buffers)["proj"] = proj
    x = rng.standard_normal((57, D)).astype(np.float32)
    x2 = rng.standard_normal((31, D)).astype(np.float32)
    R1 = rng.standard_normal((57, 57)).astype(np.float32)
    R2 = rng.standard_normal((57, 31)).astype(np.float32)
    return params, buffers, x, x2, R1, R2


@pytest.mark.parametrize("learn_proj", [False, True],
                         ids=["fixed", "learned"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("base", cuda_gram.BASES)
def test_dense_gram_twin_matches_jax(base, cross, learn_proj):
    """K and the gradient of sum(K * R) wrt the raw params (the
    projection too where it is learned) against the JAX package."""
    jspec = jk.KernelSpec.polynomial(J=J, d=1, base=base,
                                     learn_proj=learn_proj)
    spec = KernelSpec.polynomial(J=J, d=1, base=base, learn_proj=learn_proj)
    assert cuda_gram.dense_supports(spec)
    params, buffers, x, x2, R1, R2 = _case(learn_proj)
    R = R2 if cross else R1

    def jloss(p):
        xj = jnp.asarray(x)
        K = jk._projection_gram(jspec, p, jax.tree.map(jnp.asarray, buffers),
                                xj, jnp.asarray(x2) if cross else xj)
        return jnp.sum(K * R), K

    (_, Kj), gj = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    p = to_torch(params, device="cpu")
    for t in p.values():
        t.requires_grad_(True)
    b = to_torch(buffers, device="cpu")
    xt = torch.from_numpy(x)
    before = dict(cuda_gram.launches)
    K = kernels.gram(spec, p, b, xt, torch.from_numpy(x2) if cross else xt)
    torch.sum(K * torch.from_numpy(R)).backward()
    assert cuda_gram.launches == before  # the CPU runs the twins
    assert _rel(K.detach(), Kj) <= 1e-5
    assert _grad_relerr({k: t.grad for k, t in p.items()}, gj) <= 1e-4
    if not cross:
        assert torch.equal(K, K.T)
        assert torch.all(torch.diagonal(K) == torch.diagonal(K)[0])


def test_dense_gram_twin_matches_the_materialized_path():
    """The twins' value and closed-form gradients (u1, u2, w) against
    autograd through the (J, n, m) path the port keeps for the specs the
    kernels do not take, on a cross Gram with a cotangent that is not
    symmetric, in float64."""
    spec = KernelSpec.polynomial(J=J, d=1, base="matern52")
    rng = np.random.default_rng(4)
    u1, u2 = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
              for s in ((J, 40), (J, 29)))
    w = torch.from_numpy(rng.random(J) + 0.1).requires_grad_(True)
    G = torch.from_numpy(rng.standard_normal((40, 29)))
    out = []
    for fn in (lambda: cuda_gram.dense_gram(u1, u2, w, "matern52"),
               lambda: kernels._materialized_projection_gram(spec, u1, u2, w)):
        K = fn()
        u1.grad = u2.grad = w.grad = None
        torch.sum(K * G).backward()
        out.append([K.detach(), u1.grad, u2.grad, w.grad])
    for a, c in zip(*out):
        assert _rel(a, c) <= 1e-12


def test_supported_specs_never_materialize(monkeypatch):
    """A float32 Gram of a spec that dense_supports() accepts never reaches the
    (J, n, m) path, in either direction; a float64 one and a spec of
    degree 2 do."""
    def refuse(*args):
        raise AssertionError("the (J, n, m) path ran")

    spec = KernelSpec.polynomial(J=J, d=1, base="rbf")
    params, buffers, x, x2, _, _ = _case(False, seed=2)
    p = to_torch(params, device="cpu")
    p["raw_lengthscale"].requires_grad_(True)
    b = to_torch(buffers, device="cpu")
    xt = torch.from_numpy(x)
    with monkeypatch.context() as mp:
        mp.setattr(kernels, "_materialized_projection_gram", refuse)
        kernels.gram(spec, p, b, xt, xt).sum().backward()
        kernels.gram(spec, p, b, xt, torch.from_numpy(x2)).sum().backward()
    reached = []
    orig = kernels._materialized_projection_gram
    monkeypatch.setattr(kernels, "_materialized_projection_gram",
                        lambda *a: reached.append(1) or orig(*a))
    p64 = {k: v.double() for k, v in p.items()}
    b64 = {k: v.double() for k, v in b.items()}
    kernels.gram(spec, p64, b64, xt.double(), xt.double())
    spec2 = KernelSpec.polynomial(J=3, d=2, base="rbf")
    assert not cuda_gram.dense_supports(spec2)
    kernels.gram(spec2, {"raw_lengthscale": torch.zeros(6),
                         "raw_outputscale": torch.zeros(())},
                 {"proj": torch.from_numpy(x[:6].T.copy())}, xt, xt)
    assert len(reached) == 2


def test_ski_spec_gram_materializes(monkeypatch):
    """A SKI spec's Gram takes the (J, n, m) path: its kernel is one the
    dense kernels compute (dense_supports), and the dispatch keeps SKI
    specs off them for now (_projection_gram's docstring); not one of
    K4 / K5's specs (supports)."""
    spec = KernelSpec.polynomial(J=J, d=1, base="rbf", ski=True,
                                 grid_size=64)
    assert cuda_gram.dense_supports(spec) and not cuda_gram.supports(spec)
    params, buffers, x, _, _, _ = _case(False, seed=3)
    reached = []
    orig = kernels._materialized_projection_gram
    monkeypatch.setattr(kernels, "_materialized_projection_gram",
                        lambda *a: reached.append(1) or orig(*a))
    xt = torch.from_numpy(x)
    K = kernels.gram(spec, to_torch(params, device="cpu"),
                     to_torch(buffers, device="cpu"), xt[:1], xt)
    assert reached == [1] and K.shape == (1, xt.shape[0])
