"""rpagp_torch's SVGP against the JAX package, on the CPU:
init_svgp_params (given the JAX package's inducing points), _var_chol,
the ELBO's value and gradient, svgp_predict, one epoch's Adam trajectory
on the same batches (svgp.elbo + optax.adam against torch.optim.Adam),
run_split on specs/svgp_m512.json, and the entry points' default device.

Both packages get the same numpy data, inducing points and raw
parameters (carried with rpagp_torch.utils.convert). Bars: values rel
<= 1e-5, gradients relerr <= 1e-4 (tests/test_grid_sharding.py's
measure); the predictive rel <= 1e-5; the Adam trajectory rel <= 1e-4
(optax's and torch's Adam round their updates differently, as in
tests/test_torch_port_grid_post.py's train_fixed).
"""

import dataclasses
import inspect
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rpagp.models import svgp as jsvgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch import runner, train
from rpagp_torch.models import svgp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import datasets
from rpagp_torch.utils.config import load_spec
from rpagp_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, M = 300, 5, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree_relerr(ga, gb):
    la, lb = jax.tree.leaves(ga), jax.tree.leaves(gb)
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
              for a, b in zip(la, lb))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in lb)
    return (num / max(den, 1e-30)) ** 0.5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.standard_normal(N)).astype(
        np.float32)
    return x, y


@pytest.fixture(scope="module")
def setup():
    """Both packages' (spec, params, buffers) and the data: the JAX
    package's init (key 0), then every raw parameter moved off it (a full
    lower var_chol, a nonzero var_mean, perturbed inducing points and
    hyperparameters), carried to the port."""
    jspec = JModelSpec(kernel=JKernelSpec(family="rbf", ard=True))
    spec = ModelSpec(kernel=KernelSpec(family="rbf", ard=True))
    x, y = _data()
    jp, jb = jsvgp.init_svgp_params(jax.random.key(0), jspec, jnp.asarray(x), M)
    rng = np.random.default_rng(1)
    jp = {**jp,
          "raw_noise": jnp.float32(-1.2), "mean_const": jnp.float32(0.1),
          "kernel": {"raw_lengthscale": jnp.asarray(
              rng.uniform(-0.5, 0.5, D), jnp.float32),
              "raw_outputscale": jnp.float32(0.4)},
          "inducing": jp["inducing"] + jnp.asarray(
              0.05 * rng.standard_normal((M, D)), jnp.float32),
          "var_mean": jnp.asarray(0.3 * rng.standard_normal(M), jnp.float32),
          "var_chol": jp["var_chol"] + jnp.asarray(
              np.tril(0.05 * rng.standard_normal((M, M))), jnp.float32)}
    params = to_torch(jax.device_get(jp), device="cpu")
    buffers = to_torch(jax.device_get(jb), device="cpu")
    return jspec, jp, jb, spec, params, buffers, x, y


def test_init_matches_given_the_inducing_points():
    """The JAX package's init (key 0) and the port's, handed the same
    inducing points: every leaf equal; the port's own draw is a subset of
    distinct training rows; to_torch carries the JAX tree leaf for leaf."""
    jspec = JModelSpec(kernel=JKernelSpec(family="rbf", ard=True))
    spec = ModelSpec(kernel=KernelSpec(family="rbf", ard=True))
    x, _ = _data()
    jp, jb = jsvgp.init_svgp_params(jax.random.key(0), jspec, jnp.asarray(x), M)
    jp = jax.device_get(jp)
    params, buffers = svgp.init_svgp_params(
        spec, torch.from_numpy(x), M, inducing=np.asarray(jp["inducing"]),
        device="cpu")
    assert buffers == {"kernel": {}} and jax.device_get(jb) == {"kernel": {}}
    carried = to_torch(jp, device="cpu")
    for tree in (params, carried):
        got = jax.tree.leaves(to_numpy(tree))
        want = jax.tree.leaves(jp)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    drawn, _ = svgp.init_svgp_params(
        spec, torch.from_numpy(x), M, generator=torch.Generator().manual_seed(0),
        device="cpu")
    rows = {tuple(r) for r in x.tolist()}
    Z = drawn["inducing"].tolist()
    assert len({tuple(r) for r in Z}) == M and all(tuple(r) in rows for r in Z)


def test_var_chol_matches(setup):
    jspec, jp, jb, spec, params, buffers, x, y = setup
    C = svgp._var_chol(params)
    assert _rel(C, jsvgp._var_chol(jp)) <= 1e-6
    assert float(torch.max(torch.abs(torch.triu(C, 1)))) == 0.0


@pytest.mark.parametrize("batch", [64, N])
def test_elbo_value_and_gradient_match(setup, batch):
    """A minibatch (the total-data scale n / |B|) and the whole set, with
    respect to every parameter (inducing points, the variational factor,
    the kernel, noise and mean)."""
    jspec, jp, jb, spec, params, buffers, x, y = setup
    xb, yb = x[:batch], y[:batch]
    vj, gj = jax.value_and_grad(lambda p: jsvgp.elbo(
        jspec, p, jb, jnp.asarray(xb), jnp.asarray(yb), N))(jp)
    p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_(True))
         for k, v in params.items()}
    v = svgp.elbo(spec, p, buffers, torch.from_numpy(xb),
                  torch.from_numpy(yb), N)
    v.backward()
    g = {k: ({kk: vv.grad for kk, vv in p[k].items()}
             if isinstance(p[k], dict) else p[k].grad) for k in p}
    assert abs(float(v.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    assert _tree_relerr(to_numpy(g), jax.device_get(gj)) <= 1e-4


@pytest.mark.parametrize("observation_noise", [True, False])
def test_svgp_predict_matches(setup, observation_noise):
    jspec, jp, jb, spec, params, buffers, x, y = setup
    xt = np.random.default_rng(4).standard_normal((50, D)).astype(np.float32)
    muj, varj = jsvgp.svgp_predict(jspec, jp, jb, jnp.asarray(xt),
                                   observation_noise)
    mu, var = svgp.svgp_predict(spec, params, buffers, torch.from_numpy(xt),
                                observation_noise=observation_noise)
    assert _rel(mu, muj) <= 1e-5 and _rel(var, varj) <= 1e-5


def test_one_epoch_of_adam_matches_optax(setup):
    """Four Adam steps at lr 0.01 on the same four batches of 64 (one
    epoch of train_svgp at n = 300, batch 64), against svgp.elbo and
    optax.adam: the epoch's mean loss (what train_svgp reads) and the
    final parameters rel <= 1e-4."""
    jspec, jp, jb, spec, params, buffers, x, y = setup
    perm = np.random.default_rng(5).permutation(N)[:4 * 64]
    xs, ys = x[perm].reshape(4, 64, D), y[perm].reshape(4, 64)
    opt = optax.adam(0.01)
    st = opt.init(jp)
    pj, lj = jp, []
    for xb, yb in zip(xs, ys):
        loss, g = jax.value_and_grad(lambda p: -jsvgp.elbo(
            jspec, p, jb, jnp.asarray(xb), jnp.asarray(yb), N) / N)(pj)
        upd, st = opt.update(g, st, pj)
        pj = optax.apply_updates(pj, upd)
        lj.append(float(loss))
    p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_(True))
         for k, v in params.items()}
    topt = torch.optim.Adam(train._leaves(p), lr=0.01)
    mean = svgp._epoch(spec, p, buffers, topt, torch.from_numpy(xs),
                       torch.from_numpy(ys), N)
    assert float(mean) == pytest.approx(sum(lj) / 4, rel=1e-4)
    assert _tree_relerr(to_numpy(p), jax.device_get(pj)) <= 1e-4


def test_train_svgp_epochs():
    """train_svgp at n = 300, batch 64: 4 steps an epoch (the last 44
    points of each shuffle dropped), 3 epochs, the losses falling; the
    caller's params untouched."""
    spec = ModelSpec(kernel=KernelSpec(family="rbf", ard=True))
    x, y = (torch.from_numpy(a) for a in _data(2))
    params, buffers = svgp.init_svgp_params(
        spec, x, M, generator=torch.Generator().manual_seed(0), device="cpu")
    before = params["var_chol"].clone()
    res = svgp.train_svgp(spec, params, buffers, x, y,
                          generator=torch.Generator().manual_seed(1),
                          batch_size=64, num_epochs=3, lr=0.05)
    assert len(res.losses) == 3 and all(map(math.isfinite, res.losses))
    assert res.losses[-1] < res.losses[0]
    assert torch.equal(params["var_chol"], before)
    assert not torch.equal(res.params["var_chol"], before)


def test_run_split_on_svgp_m512():
    """run_split on specs/svgp_m512.json (M = 512, batch 1024, lr 0.01)
    on a 600-point split of synthetic elevators (D = 18): M = 512 of the
    540 training points, one step an epoch, 3 epochs (max_iters 30);
    finite metrics, mll the last epoch's -loss."""
    exp = load_spec(os.path.join(ROOT, "specs", "svgp_m512.json"))
    assert exp.model_family == "svgp" and exp.num_inducing == 512
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=30))
    ds = datasets.load_dataset("elevators", max_points=600)
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    timings = {}
    m = runner.run_split(exp, split, seed=0, device="cpu", timings=timings)
    assert m["iterations"] == 3 and m["n_train"] == split.train_x.shape[0]
    for k in ("rmse", "nll", "mll"):
        assert math.isfinite(m[k]), (k, m)
    assert sorted(timings) == ["posterior_s", "prepare_s", "train_s"]


def test_entry_points_default_to_the_card():
    """The port's rule: the card unless the caller asks for the CPU."""
    assert inspect.signature(svgp.init_svgp_params).parameters[
        "device"].default == "cuda"
    assert inspect.signature(runner.run_split).parameters[
        "device"].default == "cuda"
