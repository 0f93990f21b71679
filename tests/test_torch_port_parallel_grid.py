"""rpagp_torch.parallel's exact grid solver against the JAX package's SPMD
functions, on the CPU.

Each case spawns a gloo world of CPU ranks (rpagp_torch.parallel.launch)
and holds what every rank computes against the reference's shard_map
program on a JAX mesh of the same shape, built from jax.devices("cpu")
(the 8 virtual devices of tests/conftest.py): worlds of 2 and 4 ranks
and a 2 x 2 data x comp mesh. The reference runs in the pytest process
and reaches the workers as numpy arrays; this module imports JAX only
inside functions, because the workers import it.

Compared: prepare_distributed_grid's S, U^T y, U^T 1 and value cache;
distributed_grid_mll's value and assembled gradient, with and without the
per-dataset caches; the grid posterior; the banded factor with
RPAGP_DIST_CHOL=1 (its value, its NaN on indefinite input, its fallback
level, its gradient and the grid MLL through it); every rank's factor,
ladder levels and gradient bitwise equal; and run_split(distributed=True)
at 2 ranks against the port's single-process run_split. Bars: value rel
<= 1e-5, gradient relerr <= 1e-4 (the reference's
tests/test_grid_sharding.py), posterior rel <= 1e-4, the banded factor's
gradient 2.5e-4 (the bound rpagp/parallel/dist_chol.py states).
"""

import os

import numpy as np
import pytest
import torch

from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import grid_solve
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.parallel import dist_chol, launch, sharding
from rpagp_torch.train import _leaves
from rpagp_torch.utils.convert import local_rows, to_numpy, to_torch

# (ranks, comp): 1-D worlds of 2 and 4, and a 2 x 2 data x comp mesh
WORLDS = [(2, 1), (4, 1), (4, 2)]
IDS = ["w2", "w4", "2x2"]
N, D, J, M, NT = 256, 4, 4, 32, 48
P_BAND = 320  # the banded factor's test matrix: ragged against 2 x 128


def _kw():
    return dict(J=J, d=1, base="rbf", proj_dist="gaussian", ski=True,
                grid_size=M)


def _spec():
    return ModelSpec(kernel=KernelSpec.polynomial(**_kw()),
                     max_cholesky_size=64)


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.standard_normal(N)).astype(
        np.float32)
    xt = (1.5 * rng.standard_normal((NT, D))).astype(np.float32)
    ls = rng.uniform(-0.5, 0.5, J).astype(np.float32)
    B = rng.standard_normal((P_BAND, P_BAND)).astype(np.float32)
    C = B @ B.T / P_BAND + 0.5 * np.eye(P_BAND, dtype=np.float32)
    Q, _ = np.linalg.qr(rng.standard_normal((P_BAND, P_BAND)))
    Cbad = (Q * np.linspace(-0.05, 1.0, P_BAND)) @ Q.T  # eigs in [-0.05, 1]
    R = rng.standard_normal((P_BAND, P_BAND)).astype(np.float32)
    return dict(x=x, y=y, xt=xt, ls=ls, C=(0.5 * (C + C.T)).astype(np.float32),
                Cbad=(0.5 * (Cbad + Cbad.T)).astype(np.float32), R=R)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [np.asarray(tree, np.float64)]


def _grad_relerr(ga, gb):
    la, lb = _flat(ga), _flat(gb)
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(la, lb))
    den = sum(float(np.sum(b ** 2)) for b in lb)
    return (num / max(den, 1e-30)) ** 0.5


# ------------------------------------------------------- the reference ----

def _reference(world, comp, d):
    """The JAX package's SPMD results on a (world // comp) x comp mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rpagp.models import exact_gp as jgp
    from rpagp.models.exact_gp import ModelSpec as JModelSpec
    from rpagp.ops.kernels import KernelSpec as JKernelSpec
    from rpagp.parallel import dist_chol as jdc
    from rpagp.parallel import sharding as jsh

    spec = JModelSpec(kernel=JKernelSpec.polynomial(**_kw()),
                      max_cholesky_size=64)
    jp, jb = jgp.init_model(jax.random.key(1), spec, D)
    jp = {**jp, "raw_noise": jnp.float32(-1.5),
          "mean_const": jnp.float32(0.2),
          "kernel": {**jp["kernel"], "raw_lengthscale": jnp.asarray(d["ls"]),
                     "raw_outputscale": jnp.float32(0.3)}}
    mesh = jsh.make_mesh(jax.devices("cpu")[:world], comp=comp)
    xs = jsh.shard_rows(jnp.asarray(d["x"]), mesh)
    ys = jsh.shard_rows(jnp.asarray(d["y"]), mesh)
    pr, br = jsh.replicate(jp, mesh), jsh.replicate(jb, mesh)
    state, S4, uy, u1, vc = jsh.prepare_distributed_grid(
        spec, pr, br, xs, mesh, y_sharded=ys)
    comp_axis = jsh.COMP_AXIS if comp > 1 else None

    def value_grad(cached):
        def f(p, xl, yl, sst, S, *cache):
            kw = dict(zip(("uy", "u1", "vc"), cache))
            loss, g = jax.value_and_grad(
                lambda pp: jsh.distributed_grid_mll(spec, pp, xl, yl, sst, S,
                                                    **kw))(p)
            g = jax.lax.pmean(g, jsh.AXIS)
            if comp_axis is not None:
                g = jax.lax.pmean(g, comp_axis)
            return loss, g

        cache = (uy, u1, vc) if cached else ()
        fn = jax.jit(jax.shard_map(
            f, mesh=mesh,
            in_specs=(P(), P(jsh.AXIS), P(jsh.AXIS),
                      jsh._ski_state_in_specs(None), P())
            + (P(),) * len(cache),
            out_specs=(P(), P()), check_vma=False))
        v, g = fn(pr, xs, ys, state, S4, *cache)
        return float(v), jax.device_get(g)

    out = {"params": jax.device_get(jp),
           "proj": np.asarray(jb["kernel"]["proj"]),
           "tfrac": np.asarray(jax.device_get(state.tfrac)),
           "S4": np.asarray(jax.device_get(S4)), "uy": np.asarray(uy),
           "u1": np.asarray(u1), "vc": jax.device_get(vc),
           "cached": value_grad(True), "uncached": value_grad(False)}
    predict = jsh.make_distributed_posterior(spec, mesh, n_global=N)
    mu, var = predict(pr, br, xs, ys, jnp.asarray(d["xt"]), jax.random.key(9))
    out["posterior"] = (np.asarray(mu), np.asarray(var))

    # the banded factor (the env var is read when the program is traced)
    os.environ["RPAGP_DIST_CHOL"] = "1"
    try:
        out["banded_mll"] = value_grad(False)

        def smap(fn, n_out=1):
            return jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=(P(),),
                out_specs=P() if n_out == 1 else (P(),) * n_out,
                check_vma=False))

        R = jnp.asarray(d["R"])

        def vg(c):
            def loss(cc):
                L, _ = jdc.distributed_blocked_cholesky(0.5 * (cc + cc.T),
                                                        jsh.AXIS, block=128)
                return jnp.vdot(L, R) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))

            v, g = jax.value_and_grad(loss)(c)
            return v, jax.lax.pmean(g, jsh.AXIS)

        chol = smap(lambda c: jdc.distributed_blocked_cholesky(
            c, jsh.AXIS, block=128)[0])
        out["band_L"] = np.asarray(chol(jnp.asarray(d["C"])))
        v, g = smap(vg, 2)(jnp.asarray(d["C"]))
        out["band_grad"] = (float(v), np.asarray(g))
        fb = smap(lambda c: jdc.distributed_chol_with_fallback_eps(
            c, jnp.float32(1.0), jsh.AXIS, block=128), 2)
        out["band_eps"] = float(fb(jnp.asarray(d["Cbad"]))[1])
    finally:
        del os.environ["RPAGP_DIST_CHOL"]
    return out


# --------------------------------------------------------- the workers ----

def _grad_tree(p):
    return {k: (_grad_tree(v) if isinstance(v, dict) else v.grad.numpy())
            for k, v in p.items()}


def _value_grad(spec, params, xl, yl, state, S4, mesh, cache):
    """(value, assembled gradient, the factor's Lc and ladder levels)."""
    p = to_torch(to_numpy(params), "cpu")
    leaves = _leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    grid_solve.reset_stats()
    loss = sharding.distributed_grid_mll(spec, p, xl, yl, state, S4, mesh,
                                         uy=cache[0], u1=cache[1], vc=cache[2])
    loss.backward()
    sharding.assemble_grads(leaves, mesh, data_mean=True)
    levels = (grid_solve.stats["t_levels"].numpy(),
              float(grid_solve.stats["c_level"]))
    with torch.no_grad():
        _, Lc = grid_solve._factor(spec, params["kernel"], state, S4,
                                   exact_gp.noise_value(params))
    return float(loss.detach()), _grad_tree(p), Lc.numpy(), levels


def rank_grid(mesh, d, ref_params, proj):
    """One rank's results for every check of this module."""
    spec = _spec()
    params = to_torch(ref_params, "cpu")
    buffers = {"kernel": {"proj": torch.from_numpy(proj)}}
    x, y, xt = (torch.from_numpy(d[k]) for k in ("x", "y", "xt"))
    xl, yl = sharding.shard_rows(x, mesh), sharding.shard_rows(y, mesh)
    state, S4, uy, u1, vc = sharding.prepare_distributed_grid(
        spec, params, buffers, xl, mesh, y_local=yl)
    out = {"tfrac": state.tfrac.numpy(), "S4": S4.numpy(), "uy": uy.numpy(),
           "u1": u1.numpy(), "vc": to_numpy(vc),
           "cached": _value_grad(spec, params, xl, yl, state, S4, mesh,
                                 (uy, u1, vc)),
           "uncached": _value_grad(spec, params, xl, yl, state, S4, mesh,
                                   (None,) * 3)}
    predict = sharding.make_distributed_posterior(spec, mesh, N)
    out["posterior"] = tuple(a.numpy() for a in predict(params, buffers, xl,
                                                        yl, xt))
    os.environ["RPAGP_DIST_CHOL"] = "1"
    out["banded_mll"] = _value_grad(spec, params, xl, yl, state, S4, mesh,
                                    (None,) * 3)
    C, Cbad, R = (torch.from_numpy(d[k]) for k in ("C", "Cbad", "R"))
    L, ok = dist_chol.distributed_blocked_cholesky(C, mesh)
    out["band_L"], out["band_ok"] = L.numpy(), bool(ok)
    Cg = C.clone().requires_grad_(True)
    Lg, _ = dist_chol.distributed_blocked_cholesky(0.5 * (Cg + Cg.T), mesh)
    v = torch.sum(Lg * R) + 2.0 * torch.sum(torch.log(torch.diagonal(Lg)))
    v.backward()
    Cg.grad = comm_pmean(Cg.grad, mesh)
    out["band_grad"] = (float(v.detach()), Cg.grad.numpy())
    Lbad, okbad = dist_chol.distributed_blocked_cholesky(
        C - 10.0 * torch.eye(P_BAND), mesh)
    out["band_nan"] = (bool(torch.isfinite(Lbad).all()), bool(okbad))
    Lf, eps = dist_chol.distributed_chol_with_fallback_eps(
        Cbad, torch.tensor(1.0), mesh)
    out["band_eps"] = (float(eps), bool(torch.isfinite(Lf).all()))
    return out


def comm_pmean(g, mesh):
    from rpagp_torch.parallel import comm

    return comm.pmean(g, mesh.data_group)


@pytest.fixture(scope="module", params=WORLDS, ids=IDS)
def worlds(request):
    world, comp = request.param
    d = _data()
    ref = _reference(world, comp, d)
    ranks = launch.run_world(rank_grid, world,
                             args=(d, ref["params"], ref["proj"]), comp=comp)
    return world, comp, ref, ranks


def test_prepare_distributed_grid_matches_reference(worlds):
    world, comp, ref, ranks = worlds
    for r, out in enumerate(ranks):
        # each rank's tfrac is its block of the reference's sharded columns
        assert _rel(out["tfrac"], local_rows(ref["tfrac"], r // comp,
                                             world // comp, axis=1)) <= 1e-6
        for key in ("S4", "uy", "u1"):
            assert _rel(out[key], ref[key]) <= 1e-5, key
        for key in ("a0", "sy", "yy"):
            assert _rel(out["vc"][key], ref["vc"][key]) <= 1e-5, key
        # the ridge anchor is a solve against S + delta I, conditioning ~1e3
        assert _rel(out["vc"]["q0"], ref["vc"]["q0"]) <= 1e-4
        # a1 = sum(r) cancels: held against the size of y's sum
        assert abs(float(out["vc"]["a1"]) - float(ref["vc"]["a1"])) <= \
            1e-4 * float(np.sum(np.abs(_data()["y"])))


@pytest.mark.parametrize("which", ["cached", "uncached"])
def test_distributed_grid_mll_matches_reference(worlds, which):
    _, _, ref, ranks = worlds
    vj, gj = ref[which]
    for out in ranks:
        v, g, _, _ = out[which]
        assert abs(v - vj) <= 1e-5 * abs(vj)
        assert _grad_relerr(g, gj) <= 1e-4


def test_ranks_agree_bitwise_on_the_factor(worlds):
    """The factor's host reads branch alike on every rank: the replicated
    inputs after the all-reduce give every rank the same Lc, ladder levels,
    loss and assembled gradient, bit for bit."""
    _, _, _, ranks = worlds
    for which in ("cached", "uncached", "banded_mll"):
        v0, g0, L0, (t0, c0) = ranks[0][which]
        for out in ranks[1:]:
            v, g, L, (t, c) = out[which]
            assert v == v0 and np.array_equal(L, L0)
            assert np.array_equal(t, t0) and c == c0
            assert all(np.array_equal(a, b) for a, b in zip(_flat(g),
                                                            _flat(g0)))


def test_distributed_grid_posterior_matches_reference(worlds):
    _, _, ref, ranks = worlds
    for out in ranks:
        for a, b in zip(out["posterior"], ref["posterior"]):
            assert _rel(a, b) <= 1e-4
        assert np.all(out["posterior"][1] > 0)


def test_banded_factor_matches_reference(worlds):
    """RPAGP_DIST_CHOL=1: the banded factor's value, its NaN on indefinite
    input, its fallback level, and its gradient (pmean over data)."""
    _, _, ref, ranks = worlds
    for out in ranks:
        assert _rel(out["band_L"], ref["band_L"]) <= 1e-5 and out["band_ok"]
        v, g = out["band_grad"]
        assert abs(v - ref["band_grad"][0]) <= 1e-5 * abs(ref["band_grad"][0])
        assert _rel(g, ref["band_grad"][1]) <= 2.5e-4
        assert out["band_nan"] == (False, False)
        eps, finite = out["band_eps"]
        assert finite and eps > 0.0
        assert abs(eps - ref["band_eps"]) <= 1e-6 * ref["band_eps"]


def test_banded_grid_mll_matches_reference(worlds):
    _, _, ref, ranks = worlds
    vj, gj = ref["banded_mll"]
    for out in ranks:
        v, g, _, _ = out["banded_mll"]
        assert abs(v - vj) <= 1e-5 * abs(vj)
        assert _grad_relerr(g, gj) <= 2.5e-4


# ------------------------------------------------------------ the runner --

def _split_and_exp():
    import dataclasses

    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    exp = load_spec(os.path.join(os.path.dirname(__file__), "..", "specs",
                                 "rp_ski_houseelectric_j20.json"))
    exp = dataclasses.replace(
        exp, model=dataclasses.replace(
            exp.model, kernel=KernelSpec.polynomial(J=4, ski=True,
                                                    grid_size=32)),
        train=dataclasses.replace(exp.train, max_iters=4))
    ds = datasets.load_dataset("houseelectric", max_points=1000)
    return exp, next(datasets.kfold_splits(ds, k=10, seed=0,
                                           equal_train=True))


def _run_split_and_losses(**kw):
    """(metrics, training losses) of runner.run_split on the small grid
    spec: the losses taken from the trainer's result as it returns."""
    from rpagp_torch import runner

    exp, split = _split_and_exp()
    real, losses = runner.train_to_convergence, []

    def trainer(*a, **k):
        res = real(*a, **k)
        losses.extend(res.losses)
        return res

    runner.train_to_convergence = trainer
    try:
        m = runner.run_split(exp, split, seed=0, device="cpu", **kw)
    finally:
        runner.train_to_convergence = real
    return m, losses


def rank_run_split(mesh):
    return _run_split_and_losses(distributed=True)


def test_run_split_distributed_matches_single_process():
    """run_split(distributed=True) on a small grid spec at 2 ranks against
    the port's single-process run_split: the same rows (n_train 900
    divides by 2), losses and metrics."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:  # the world runs meanwhile
        world = pool.submit(launch.run_world, rank_run_split, 2)
        m1, losses1 = _run_split_and_losses()
        ranks = world.result()
    for m, losses in ranks:
        assert m["n_train"] == m1["n_train"] and m["iterations"] == 4
        assert len(losses) == 4 and _rel(losses, losses1) <= 1e-5
        for k in ("rmse", "nll", "mll"):
            assert abs(m[k] - m1[k]) <= 1e-4 * abs(m1[k]), k
