"""rpagp_torch's spec layer, trainer and runner against the JAX package,
on the CPU (the port runs its kernels' plain versions here)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp import runner as jrunner
from rpagp import train as jtrain
from rpagp.mll import mll as jmll
from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp.utils import config as jconfig
from rpagp_torch import runner, train
from rpagp_torch.mll import mll
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import config
from rpagp_torch.utils.convert import to_torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("pair", [
    (JKernelSpec, KernelSpec), (JModelSpec, ModelSpec),
    (jconfig.TrainConfig, config.TrainConfig),
    (jconfig.ExperimentSpec, config.ExperimentSpec)],
    ids=lambda p: p[1].__name__)
def test_spec_fields_match(pair):
    ref, port = pair
    assert ([(f.name, f.default) for f in dataclasses.fields(ref)]
            == [(f.name, f.default) for f in dataclasses.fields(port)])


def test_load_spec_matches_flagship():
    path = os.path.join(ROOT, "specs", "rp_ski_houseelectric_j20.json")
    assert (dataclasses.asdict(config.load_spec(path))
            == dataclasses.asdict(jconfig.load_spec(path)))


@pytest.mark.parametrize("schedule", ["cosine", "step"])
def test_lr_schedules_match_optax(schedule):
    import optax

    tr = config.TrainConfig(lr=0.1, max_iters=30, lr_schedule=schedule)
    ref = (optax.cosine_decay_schedule(0.1, decay_steps=30, alpha=0.1)
           if schedule == "cosine" else
           optax.exponential_decay(0.1, transition_steps=10, decay_rate=0.1,
                                   staircase=True))
    f = config.lr_factor(tr)
    for step in range(0, 35, 3):
        assert 0.1 * f(step) == pytest.approx(float(ref(step)), rel=1e-6)


def test_training_trajectory_matches_jax():
    """3 Adam steps from the same initial params and projection: the loss
    trajectories agree to rel 1e-4."""
    J, m, n, D = 4, 32, 1500, 5
    kspec = dict(J=J, d=1, base="rbf", proj_dist="gaussian", ski=True,
                 grid_size=m)
    jspec = JModelSpec(kernel=JKernelSpec.polynomial(**kspec))
    spec = ModelSpec(kernel=KernelSpec.polynomial(**kspec))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.cos(1.5 * x[:, 1]) + 0.2 * rng.standard_normal(n)).astype(np.float32)
    tr = config.TrainConfig(lr=0.1, max_iters=3, patience=10,
                            lr_schedule="cosine")

    jp, jb = jgp.init_model(jax.random.key(0), jspec, D)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    state, S4, uy, u1, vc = jgp._prepare_grid_y_jit(
        jspec, jp["kernel"], jb["kernel"], xj, yj)
    jb = {**jb, "ski_state": state, "ski_uu": S4, "ski_uy": uy,
          "ski_u1": u1, "ski_vc": vc}
    jres = jtrain.train_to_convergence(
        lambda p, b, xx, yy: -jmll(jspec, p, b, xx, yy) / n, jp,
        max_iters=3, patience=10,
        optimizer=jconfig.make_optimizer(jconfig.TrainConfig(
            **dataclasses.asdict(tr))),
        loss_args=(jb, xj, yj))

    params = to_torch(jax.device_get(jp), device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    buffers = exact_gp.prepare_buffers(
        spec, params, to_torch(jax.device_get({"kernel": jb["kernel"]}),
                               device="cpu"),
        xt, y_train=yt)
    res = train.train_to_convergence(
        lambda p, b, xx, yy: -mll(spec, p, b, xx, yy) / n, params, tr,
        loss_args=(buffers, xt, yt), sync_every=2)
    assert len(res.losses) == len(jres.losses) == 3
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-4)
    assert res.best_loss == pytest.approx(jres.best_loss, rel=1e-4)


def test_csv_columns_match_reference():
    assert runner.CSV_COLUMNS == jrunner.CSV_COLUMNS


_SUBPROCESS = r"""
import dataclasses, sys
import torch
torch.set_num_threads(2)
import rpagp_torch
from rpagp_torch import runner
from rpagp_torch.utils import datasets
from rpagp_torch.utils.config import load_spec
exp = load_spec("specs/rp_ski_houseelectric_j20.json")
from rpagp_torch.ops.kernels import KernelSpec
kernel = KernelSpec.polynomial(J=3, ski=True, grid_size=32)
exp = dataclasses.replace(
    exp, model=dataclasses.replace(exp.model, kernel=kernel),
    train=dataclasses.replace(exp.train, max_iters=2))
ds = datasets.load_dataset("houseelectric", max_points=1200)
split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
m = runner.run_split(exp, split, device="cpu")
assert m["iterations"] == 2 and m["rmse"] == m["rmse"], m
print("JAX_LOADED", "jax" in sys.modules)
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX_LOADED False" in proc.stdout
