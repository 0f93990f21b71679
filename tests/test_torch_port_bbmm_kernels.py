"""rpagp_torch's BBMM kernel layer against the JAX package, on the CPU.

The same seeded numpy inputs go through each JAX function and its port:
K4/K5's plain versions (ops/cuda_gram.py) against
pallas_gram.projected_gram_mvm in interpret mode (as
tests/test_pallas_gram.py runs it), and kernels._projected_coords, gram
and mvm against the JAX package's. Tolerances: values rel <= 1e-5
(norm-wise), gradients rel <= 1e-4, the reference's own parity bar.
Also here: the port's data layer against the JAX package's splits, and
a subprocess that shows the port loads nothing of JAX.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import kernels as jkernels
from rpagp.ops import pallas_gram
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp.utils import datasets as jdatasets
from rpagp_torch.ops import cuda_gram, kernels
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import datasets
from rpagp_torch.utils.convert import to_torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _gram_inputs(n, m, t, J, seed):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((n, J)).astype(np.float32)
    z2 = rng.standard_normal((m, J)).astype(np.float32)
    w = (0.2 + rng.random(J)).astype(np.float32)
    V = rng.standard_normal((m, t)).astype(np.float32)
    return z1, z2, w, V


# ------------------------------------------------------- K4 / K5 plain ----


@pytest.mark.parametrize("base", ["rbf", "matern32"])
@pytest.mark.parametrize("shape", [(40, 30, 3), (300, 530, 5)])
def test_gram_mvm_plain_matches_pallas(base, shape):
    """K4's plain version against the Pallas forward kernel (interpret),
    at test_pallas_gram's shapes (J = 6)."""
    n, m, t = shape
    z1, z2, w, V = _gram_inputs(n, m, t, 6, seed=n)
    ref = pallas_gram.projected_gram_mvm(jnp.asarray(z1), jnp.asarray(z2),
                                         jnp.asarray(w), jnp.asarray(V),
                                         base=base, interpret=True)
    got = cuda_gram.gram_mvm(_t(z1), _t(z2), _t(w), _t(V), base)
    assert got.shape == (n, t)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("base", ["rbf", "matern32"])
@pytest.mark.parametrize("same", [False, True], ids=["cross", "self"])
def test_gram_mvm_gradients_match_pallas(base, same):
    """dz1, dz2, dw, dV through the autograd.Function (K5's plain version
    and K4 swapped) against jax.grad through pallas_gram's custom_vjp; with
    same=True z1 is z2, as in K(x, x), and autograd adds dz1 and dz2."""
    n, m, t, J = 33, 45, 3, 4
    z1, z2, w, V = _gram_inputs(n, m, t, J, seed=7)
    if same:
        z2 = z1
        V = V[:n]

    def loss_j(z1, z2, w, V):
        return jnp.sum(jnp.sin(pallas_gram.projected_gram_mvm(
            z1, z2, w, V, base=base, interpret=True)))

    if same:
        gj = jax.grad(lambda z, w, V: loss_j(z, z, w, V), argnums=(0, 1, 2))(
            jnp.asarray(z1), jnp.asarray(w), jnp.asarray(V))
        zt, wt, Vt = _t(z1, True), _t(w, True), _t(V, True)
        torch.sum(torch.sin(cuda_gram.projected_gram_mvm(zt, zt, wt, Vt,
                                                         base))).backward()
        got = [zt.grad, wt.grad, Vt.grad]
        names = ["dz", "dw", "dV"]
    else:
        gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
            jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(w), jnp.asarray(V))
        ts = [_t(a, True) for a in (z1, z2, w, V)]
        torch.sum(torch.sin(cuda_gram.projected_gram_mvm(*ts,
                                                         base))).backward()
        got = [a.grad for a in ts]
        names = ["dz1", "dz2", "dw", "dV"]
    for g, r, name in zip(got, gj, names):
        assert _rel(g.numpy(), r) <= 1e-4, name


@pytest.mark.parametrize("base", ["rbf", "matern12", "matern32", "matern52"])
def test_gram_mvm_bwd_plain_matches_pallas_call(base):
    """K5's plain version against the Pallas backward call directly, with a
    coincident pair of points (d = 0: k1d' is 0 there for every base)."""
    z1, z2, w, V = _gram_inputs(70, 50, 2, 5, seed=11)
    z2[3] = z1[5]
    G = np.random.default_rng(12).standard_normal((70, 2)).astype(np.float32)
    dz_j, dw_j = pallas_gram._gram_mvm_bwd_call(
        jnp.asarray(z1), jnp.asarray(z2), jnp.asarray(w), jnp.asarray(V),
        jnp.asarray(G), base, True)
    dz, dw = cuda_gram.gram_mvm_bwd(_t(z1), _t(z2), _t(w), _t(V), _t(G), base)
    assert _rel(dz.numpy(), dz_j) <= 1e-4
    assert _rel(dw.numpy(), dw_j) <= 1e-4


def test_supports_needs_no_env():
    """The kernels serve every spec the JAX predicate admits without its
    environment opt-in."""
    assert cuda_gram.supports(KernelSpec.polynomial(J=10, d=1))
    assert cuda_gram.supports(KernelSpec.polynomial(J=4, d=1, base="matern52"))
    assert not cuda_gram.supports(KernelSpec.polynomial(J=4, d=2))
    assert not cuda_gram.supports(KernelSpec.polynomial(J=4, d=1, k=2))
    assert not cuda_gram.supports(
        KernelSpec.polynomial(J=4, d=1, ski=True, grid_size=64))
    assert not cuda_gram.supports(
        KernelSpec.generalized(degrees=(1, 1), bases=("rbf", "matern32")))
    # more components than one launch takes: the wrapper launches per group
    assert cuda_gram.supports(KernelSpec.polynomial(J=65, d=1))


def test_cuda_wrappers_reject_cpu_tensors():
    z1, z2, w, V = (_t(a) for a in _gram_inputs(8, 8, 1, 2, seed=0))
    with pytest.raises(TypeError):
        cuda_gram.gram_mvm_cuda(z1, z2, w, V)
    with pytest.raises(TypeError):
        cuda_gram.gram_mvm_bwd_cuda(z1, z2, w, V, V)


# --------------------------------------------- kernels.gram / mvm ----


def _kernel_case(spec_kw, D=5, seed=0):
    jspec = JKernelSpec.generalized(**spec_kw) if "degrees" in spec_kw \
        else JKernelSpec.polynomial(**spec_kw)
    spec = KernelSpec(**{f: getattr(jspec, f) for f in jspec.__dataclass_fields__})
    kp, kb = jkernels.init_kernel_params(jax.random.key(seed), jspec, D)
    rng = np.random.default_rng(seed)
    kp = dict(jax.device_get(kp))
    kp["raw_lengthscale"] = rng.standard_normal(
        kp["raw_lengthscale"].shape).astype(np.float32) * 0.3
    kp["raw_outputscale"] = np.asarray(
        rng.standard_normal(np.shape(kp["raw_outputscale"])) * 0.3, np.float32)
    return jspec, spec, kp, jax.device_get(kb)


@pytest.mark.parametrize("spec_kw", [
    dict(J=6, d=1, base="rbf"),
    dict(J=3, d=2, base="matern32", k=2),
    dict(degrees=(1, 2, 1), bases=("rbf", "matern52", "matern12")),
], ids=["deg1", "deg2k2", "generalized"])
def test_gram_and_projected_coords_match(spec_kw):
    jspec, spec, kp, kb = _kernel_case(spec_kw)
    rng = np.random.default_rng(1)
    x1 = rng.standard_normal((37, 5)).astype(np.float32)
    x2 = rng.standard_normal((23, 5)).astype(np.float32)
    zj = jkernels._projected_coords(jspec, kp, kb, jnp.asarray(x1))
    z = kernels._projected_coords(spec, to_torch(kp, device="cpu"),
                                  to_torch(kb, device="cpu"), _t(x1))
    assert _rel(z.numpy(), zj) <= 1e-5
    Kj = jkernels.gram(jspec, kp, kb, jnp.asarray(x1), jnp.asarray(x2))
    K = kernels.gram(spec, to_torch(kp, device="cpu"),
                     to_torch(kb, device="cpu"), _t(x1), _t(x2))
    assert _rel(K.numpy(), Kj) <= 1e-5
    assert kernels._component_groups(spec) == jkernels._component_groups(jspec)


@pytest.mark.parametrize("block_rows", [4096, 16])
def test_mvm_value_and_gradients_match(block_rows):
    """The blocked MVM (one block, and many row blocks under
    torch.utils.checkpoint) against the JAX package's, value and the
    gradient of a scalar loss in the kernel params and V."""
    jspec, spec, kp, kb = _kernel_case(dict(J=5, d=1, base="rbf"))
    rng = np.random.default_rng(2)
    x1 = rng.standard_normal((90, 5)).astype(np.float32)
    x2 = rng.standard_normal((60, 5)).astype(np.float32)
    V = rng.standard_normal((60, 3)).astype(np.float32)

    def loss_j(p, V):
        out = jkernels.mvm(jspec, p, kb, jnp.asarray(x1), jnp.asarray(x2), V,
                           block_rows=block_rows)
        return jnp.sum(jnp.sin(out)), out

    (_, out_j), (gp_j, gV_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(kp, jnp.asarray(V))
    p = {k: v.requires_grad_(True)
         for k, v in to_torch(kp, device="cpu").items()}
    Vt = _t(V, True)
    out = kernels.mvm(spec, p, to_torch(kb, device="cpu"), _t(x1), _t(x2), Vt,
                      block_rows=block_rows)
    torch.sum(torch.sin(out)).backward()
    assert _rel(out.detach().numpy(), out_j) <= 1e-5
    assert _rel(Vt.grad.numpy(), gV_j) <= 1e-4
    for k in p:
        assert _rel(p[k].grad.numpy(), gp_j[k]) <= 1e-4, k


def test_mvm_kernel_branch_on_cpu_is_the_blocked_path():
    """allow_pallas on a CPU tensor takes the blocked plain path (the
    kernels run only on CUDA tensors) and agrees with K4's plain version."""
    _, spec, kp, kb = _kernel_case(dict(J=6, d=1, base="rbf"))
    p, b = to_torch(kp, device="cpu"), to_torch(kb, device="cpu")
    x = _t(np.random.default_rng(3).standard_normal((50, 5)))
    V = _t(np.random.default_rng(4).standard_normal((50, 2)))
    got = kernels.mvm(spec, p, b, x, x, V, allow_pallas=True)
    z = kernels._projected_coords(spec, p, b, x).T.contiguous()
    w = kernels._component_scales(spec, p).contiguous()
    assert _rel(got.numpy(), cuda_gram.gram_mvm(z, z, w, V).numpy()) <= 1e-5


# ------------------------------------------------------ data layer ----


def test_kfold_splits_equal_the_jax_package():
    """The port's own data layer: the same splits, array for array, as the
    JAX package's numpy path."""
    ds = datasets.load_dataset("elevators", max_points=2000)
    dj = jdatasets.load_dataset("elevators", max_points=2000)
    np.testing.assert_array_equal(ds.X, dj.X)
    np.testing.assert_array_equal(ds.y, dj.y)
    assert ds.synthetic == dj.synthetic
    got = list(datasets.kfold_splits(ds, k=10, seed=3, equal_train=True))
    ref = list(jdatasets.kfold_splits(dj, k=10, seed=3, equal_train=True))
    assert len(got) == len(ref) == 10
    for a, b in zip(got, ref):
        for f in ("train_x", "train_y", "test_x", "test_y"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.y_mean, a.y_std) == (b.y_mean, b.y_std)


# ------------------------------------------------------ no JAX ----

_NO_JAX_SCRIPT = r"""
import os, sys
import torch
import rpagp_torch
from rpagp_torch import runner
from rpagp_torch.utils import datasets
from rpagp_torch.utils.config import load_spec
import dataclasses

exp = load_spec(os.path.join("specs", "rp_bbmm_elevators.json"))
model = dataclasses.replace(exp.model, max_cholesky_size=64, cg_max_iters=8,
                            precond_rank=5, num_probes=4, love_rank=8)
exp = dataclasses.replace(exp, model=model,
                          train=dataclasses.replace(exp.train, max_iters=2))
ds = datasets.load_dataset("elevators", max_points=150)
split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
m = runner.run_split(exp, split, seed=0, device="cpu")
assert m["rmse"] == m["rmse"] and m["nll"] == m["nll"], m
# SKI + BBMM: grid rank p = J m > n / 2, so CG + SLQ on W T W^T
from rpagp_torch.ops.kernels import KernelSpec
ski_model = dataclasses.replace(
    model, kernel=KernelSpec.polynomial(J=3, ski=True, grid_size=32),
    precond_refresh=2)
ski_exp = dataclasses.replace(exp, model=ski_model,
                              train=dataclasses.replace(exp.train,
                                                        max_iters=3))
m = runner.run_split(ski_exp, split, seed=0, device="cpu")
assert m["rmse"] == m["rmse"] and m["nll"] == m["nll"], m
# product SKI (the grid solver, ops/ski_product.py) and SVGP (models/svgp.py)
from rpagp_torch.models import svgp
from rpagp_torch.ops import ski_product
prod = dataclasses.replace(exp, model=dataclasses.replace(
    model, kernel=KernelSpec.polynomial(J=2, d=2, ski=True, grid_size=8)),
    train=dataclasses.replace(exp.train, max_iters=2))
assert ski_product.is_product(prod.model.kernel)
m = runner.run_split(prod, split, seed=0, device="cpu")
assert m["rmse"] == m["rmse"] and m["nll"] == m["nll"], m
sv = load_spec(os.path.join("specs", "svgp_m512.json"))
sv = dataclasses.replace(sv, num_inducing=16, batch_size=64,
                         train=dataclasses.replace(sv.train, max_iters=20))
m = runner.run_split(sv, split, seed=0, device="cpu")
assert m["iterations"] == 2 and m["rmse"] == m["rmse"], m
# the sorted SKI plan, checkpointed training, profiling and results
sorted_exp = dataclasses.replace(ski_exp, model=dataclasses.replace(
    ski_model, kernel=dataclasses.replace(ski_model.kernel, interp="sorted")))
m = runner.run_split(sorted_exp, split, seed=0, device="cpu")
assert m["rmse"] == m["rmse"] and m["nll"] == m["nll"], m
from rpagp_torch.train import train_with_checkpointing
from rpagp_torch.utils import checkpoint, profiling, results
# the parallel layer: a world of one over gloo, the distributed grid MLL
# through run_split(distributed=True), then the process group torn down
from rpagp_torch.parallel import comm, dist_chol, launch, multihost, sharding
grid_exp = dataclasses.replace(exp, model=dataclasses.replace(
    model, kernel=KernelSpec.polynomial(J=3, ski=True, grid_size=16)))
m = runner.run_split(grid_exp, split, seed=0, device="cpu", distributed=True)
assert m["rmse"] == m["rmse"] and m["nll"] == m["nll"], m
assert sharding.make_mesh().world == 1
multihost.shutdown()
root = os.path.abspath("rpagp") + os.sep
bad = sorted(k for k, mod in list(sys.modules.items())
             if k == "jax" or k.startswith("jax.") or k == "rpagp"
             or k.startswith("rpagp.")
             or (getattr(mod, "__file__", None) or "").startswith(root))
print("BAD", bad)
"""


def test_port_imports_nothing_of_jax():
    """A fresh process imports rpagp_torch and runs small CPU splits on the
    BBMM, SKI + BBMM (both interp plans), product SKI and SVGP paths,
    imports the checkpoint, profiling and results utilities and the
    parallel layer, and runs the distributed grid MLL in a world of one
    over gloo; afterwards no jax module, no rpagp module and no module
    loaded from a file under rpagp/ is in sys.modules."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout[-2000:]
