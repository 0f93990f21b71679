"""rpagp_torch.parallel's posteriors, sharded Lanczos and SVGP against the
JAX package's SPMD functions, on the CPU.

Each case spawns a gloo world of CPU ranks (rpagp_torch.parallel.launch)
and holds every rank's results against the reference's shard_map program
on a JAX mesh of the same shape from jax.devices("cpu")
(tests/conftest.py's 8 virtual devices): worlds of 2 and 4 ranks and a
2 x 2 data x comp mesh (components sharded over comp on the BBMM
posteriors; SVGP replicates over comp). The random streams that do not
port come from the reference as numpy: LOVE's restart table and the SVGP
epoch's permutation. This module imports JAX only inside functions,
because the workers import it.

Compared: distributed_posterior with LOVE on the ring
(through make_distributed_posterior) and with chunked CG variances on the
ring and on SKI (called directly at a variance tolerance of 1e-6, where
the CG has converged: at the default 1e-2 a column frozen one iteration
apart in the two summation orders moves a variance by ~1e-3), the ring's
preconditioner the reference's; love.lanczos
with rsum against the reference's sharded Lanczos; distributed_elbo's
value and gradient; one distributed SVGP epoch; the multihost helpers.
Bars: posteriors rel <= 1e-3 (BBMM: f32 CG solves to tol 1e-4 and 1e-2
in another summation order), Lanczos rel <= 1e-4 (the single-card
port's tests/test_torch_port_bbmm_solvers.py bar), the ELBO value rel <=
1e-5 and gradient relerr <= 1e-4, the epoch's loss rel <= 1e-5 and
params relerr <= 1e-4.
"""

import numpy as np
import pytest
import torch

from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.parallel import launch, sharding
from rpagp_torch.train import _leaves
from rpagp_torch.utils.convert import local_rows, to_numpy, to_torch

WORLDS = [(2, 1), (4, 1), (4, 2)]  # (ranks, comp)
IDS = ["w2", "w4", "2x2"]
N, D, J, NT, RANK, LOVE, M = 256, 4, 4, 40, 8, 12, 64
MI, SVGP_STEPS, SVGP_BATCH = 16, 4, 32
VAR_TOL = 1e-6  # the chunked variances' CG tolerance in this test
# the posterior variants: (SKI, love_rank). SKI's chunked variances run
# its cross MVM (sharded_ski_mvm with state_out) and the padded chunk
# geometry; LOVE's cross MVM on the ring is a psum of K4 partials
POSTERIORS = {"ring_love": (False, LOVE), "ring_chunked": (False, 0),
              "ski_chunked": (True, 0)}


def _specs(jax_pkg: bool):
    if jax_pkg:
        from rpagp.models.exact_gp import ModelSpec as MS
        from rpagp.ops.kernels import KernelSpec as KS
    else:
        MS, KS = ModelSpec, KernelSpec
    out = {}
    for name, (use_ski, love) in POSTERIORS.items():
        k = (KS.polynomial(J=J, d=1, ski=True, grid_size=M) if use_ski
             else KS.polynomial(J=J, d=1))
        out[name] = MS(kernel=k, cg_max_iters=30, num_probes=4,
                       precond_rank=0 if use_ski else RANK, love_rank=love,
                       max_cholesky_size=64, solver="bbmm")
    out["svgp"] = MS(kernel=KS(family="rbf", ard=True))
    return out


def _data():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.standard_normal(N)).astype(
        np.float32)
    return dict(x=x, y=y, xt=(1.2 * rng.standard_normal((NT, D))).astype(
        np.float32), ls=rng.uniform(-0.5, 0.5, J).astype(np.float32),
        ls_svgp=rng.uniform(-0.3, 0.3, D).astype(np.float32),
        vm=(0.1 * rng.standard_normal(MI)).astype(np.float32))


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
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from rpagp.models import exact_gp as jgp
    from rpagp.models import svgp as jsvgp
    from rpagp.ops import love as jlove
    from rpagp.ops import precond as jpre
    from rpagp.parallel import sharding as jsh

    specs = _specs(True)
    mesh = jsh.make_mesh(jax.devices("cpu")[:world], comp=comp)
    A = P(jsh.AXIS)
    x, y, xt = (jnp.asarray(d[k]) for k in ("x", "y", "xt"))
    xs, ys = jsh.shard_rows(x, mesh), jsh.shard_rows(y, mesh)
    jp, jb = jgp.init_model(jax.random.key(3), specs["ring_love"], D)
    jp = {**jp, "raw_noise": jnp.float32(-1.5),
          "mean_const": jnp.float32(0.1),
          "kernel": {**jp["kernel"], "raw_lengthscale": jnp.asarray(d["ls"]),
                     "raw_outputscale": jnp.float32(0.2)}}
    pr, br = jsh.replicate(jp, mesh), jsh.replicate(jb, mesh)
    key = jax.random.key(9)
    out = {"params": jax.device_get(jp),
           "proj": np.asarray(jb["kernel"]["proj"]),
           # the restart table make_distributed_posterior draws from key
           "fresh": np.asarray(jax.random.normal(key, (LOVE, N),
                                                 jnp.float32))}
    noise = jgp.noise_value(jp)
    pre = jax.jit(jpre.build_preconditioner, static_argnums=(0, 5))(
        specs["ring_love"].kernel, jp["kernel"], jb["kernel"], x, noise, RANK)
    out["pre"] = (np.asarray(pre.L), np.asarray(pre.chol_small))
    comp_axis = jsh.COMP_AXIS if comp > 1 else None
    for name, (use_ski, love) in POSTERIORS.items():
        if love:
            predict = jsh.make_distributed_posterior(specs[name], mesh,
                                                     n_global=N)
            res = predict(pr, br, xs, ys, xt, key)
        else:
            def f(xl, yl, Lp, sp=specs[name], use_ski=use_ski):
                return jsh.distributed_posterior(
                    sp, jp, jb, xl, yl, xt, None,
                    pre_L_local=None if use_ski else Lp,
                    pre_chol_small=None if use_ski else pre.chol_small,
                    comp_axis=comp_axis, var_tol=VAR_TOL)

            res = jax.jit(jax.shard_map(
                f, mesh=mesh, in_specs=(A, A, A), out_specs=(P(), P()),
                check_vma=False))(x, y, pre.L)
        out[name] = tuple(np.asarray(a) for a in res)

    spec = specs["ring_love"]

    def lz(xl, yl, fl):
        A_mvm = lambda V: jsh.ring_mvm(spec.kernel, jp["kernel"], jb["kernel"],
                                       xl, V) + noise * V
        return jlove.lanczos(A_mvm, yl, LOVE,
                             rsum=lambda s: jax.lax.psum(s, jsh.AXIS),
                             fresh=fl)

    Q, T = jax.jit(jax.shard_map(
        lz, mesh=mesh, in_specs=(A, A, P(None, jsh.AXIS)),
        out_specs=(A, P()), check_vma=False))(x, y, jnp.asarray(out["fresh"]))
    out["lanczos"] = (np.asarray(Q), np.asarray(T))

    # SVGP: the ELBO on a sharded batch, then one epoch
    sspec = specs["svgp"]
    sp, sb = jsvgp.init_svgp_params(jax.random.key(4), sspec, x, MI)
    sp = {**sp, "raw_noise": jnp.float32(-1.0), "inducing": x[:MI],
          "var_mean": jnp.asarray(d["vm"]),
          "kernel": {**sp["kernel"],
                     "raw_lengthscale": jnp.asarray(d["ls_svgp"])}}
    out["svgp_params"] = jax.device_get(sp)

    def vg(p, xl, yl):
        v, g = jax.value_and_grad(
            lambda pp: jsh.distributed_elbo(sspec, pp, sb, xl, yl, N))(p)
        return v, jax.lax.pmean(g, jsh.AXIS)

    v, g = jax.jit(jax.shard_map(vg, mesh=mesh, in_specs=(P(), A, A),
                                 out_specs=(P(), P()), check_vma=False))(
        sp, x[:64], y[:64])
    out["elbo"] = (float(v), jax.device_get(g))
    opt = optax.adam(0.05)
    epoch = jsh.make_distributed_svgp_epoch(sspec, mesh, opt, n_total=N,
                                            steps=SVGP_STEPS,
                                            batch=SVGP_BATCH)
    ekey = jax.random.key(5)
    p1, _, loss = epoch(jsh.replicate(sp, mesh), jsh.replicate(sb, mesh),
                        opt.init(sp), x, y, ekey)
    out["epoch"] = (float(loss), jax.device_get(p1))
    out["perm"] = np.asarray(jax.random.permutation(ekey, N))
    return out


# --------------------------------------------------------- the workers ----

def rank_posterior(mesh, d, ref):
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import love
    from rpagp_torch.parallel import comm, multihost

    specs = _specs(False)
    params = to_torch(ref["params"], "cpu")
    buffers = {"kernel": {"proj": torch.from_numpy(ref["proj"])}}
    x, y, xt = (torch.from_numpy(d[k]) for k in ("x", "y", "xt"))
    xl, yl = sharding.shard_rows(x, mesh), sharding.shard_rows(y, mesh)
    fresh = torch.from_numpy(ref["fresh"])
    out = {}
    Lp = sharding.shard_rows(ref["pre"][0], mesh)
    Cs = torch.from_numpy(ref["pre"][1])
    comp_axis = sharding.COMP_AXIS if mesh.comp > 1 else None
    for name, (use_ski, love_rank) in POSTERIORS.items():
        if love_rank:
            predict = sharding.make_distributed_posterior(specs[name], mesh,
                                                          N)
            res = predict(params, buffers, xl, yl, xt, x_full=x, fresh=fresh)
        else:
            res = sharding.distributed_posterior(
                specs[name], params, buffers, xl, yl, xt, None, mesh,
                pre_L_local=None if use_ski else Lp,
                pre_chol_small=None if use_ski else Cs, comp_axis=comp_axis,
                var_tol=VAR_TOL)
        out[name] = tuple(a.numpy() for a in res)

    spec = specs["ring_love"]
    noise = exact_gp.noise_value(params)
    A_mvm = lambda V: sharding.ring_mvm(spec.kernel, params["kernel"],
                                        buffers["kernel"], xl, V,
                                        mesh) + noise * V
    Q, T = love.lanczos(A_mvm, yl, LOVE,
                        rsum=lambda s: comm.psum(s, mesh.data_group),
                        fresh=local_rows(fresh, mesh.data_rank, mesh.data,
                                         axis=1))
    out["lanczos"] = (Q.numpy(), T.numpy())

    sspec = specs["svgp"]
    sp = to_torch(ref["svgp_params"], "cpu")
    sb = {"kernel": {}}
    p = to_torch(to_numpy(sp), "cpu")
    leaves = _leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    v = sharding.distributed_elbo(sspec, p, sb, sharding.shard_rows(x[:64],
                                                                    mesh),
                                  sharding.shard_rows(y[:64], mesh), N, mesh)
    v.backward()
    sharding.assemble_grads(leaves, mesh, data_mean=True)
    out["elbo"] = (float(v.detach()), _grads(p))
    p = to_torch(to_numpy(sp), "cpu")
    leaves = _leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=0.05)
    epoch = sharding.make_distributed_svgp_epoch(sspec, mesh, opt, N,
                                                 SVGP_STEPS, SVGP_BATCH)
    loss = epoch(p, sb, x, y, perm=torch.from_numpy(ref["perm"]).long())
    out["epoch"] = (float(loss), to_numpy(p))

    # the multihost helpers: a rank's rows and the replicated tree
    xr = multihost.shard_rows_global(d["x"], mesh)
    out["multihost"] = (
        np.array_equal(xr.numpy(), local_rows(d["x"], mesh.data_rank,
                                              mesh.data)),
        np.array_equal(multihost.replicate_global({"a": d["y"]}, mesh)
                       ["a"].numpy(), d["y"]),
        multihost.process_zero() == (torch.distributed.get_rank() == 0),
        multihost.make_global_mesh().data == mesh.world)
    return out


def _grads(p):
    return {k: (_grads(v) if isinstance(v, dict) else v.grad.numpy())
            for k, v in p.items()}


@pytest.fixture(scope="module", params=WORLDS, ids=IDS)
def worlds(request):
    world, comp = request.param
    d = _data()
    ref = _reference(world, comp, d)
    ranks = launch.run_world(rank_posterior, world, args=(d, ref), comp=comp)
    return world, comp, ref, ranks


@pytest.mark.parametrize("which", list(POSTERIORS))
def test_distributed_posterior_matches_reference(worlds, which):
    _, _, ref, ranks = worlds
    for out in ranks:
        for a, b in zip(out[which], ref[which]):
            assert _rel(a, b) <= 1e-3
        assert np.all(out[which][1] > 0)


def test_lanczos_rsum_matches_reference(worlds):
    world, comp, ref, ranks = worlds
    Qj, Tj = ref["lanczos"]
    for r, out in enumerate(ranks):
        Q, T = out["lanczos"]
        assert _rel(T, Tj) <= 1e-4
        assert _rel(Q, local_rows(Qj, r // comp, world // comp)) <= 1e-4


def test_distributed_elbo_matches_reference(worlds):
    _, _, ref, ranks = worlds
    vj, gj = ref["elbo"]
    for out in ranks:
        v, g = out["elbo"]
        assert abs(v - vj) <= 1e-5 * abs(vj)
        assert _grad_relerr(g, gj) <= 1e-4


def test_distributed_svgp_epoch_matches_reference(worlds):
    """One epoch of 4 Adam steps on the same permutation: its mean loss
    and the params after it."""
    _, _, ref, ranks = worlds
    lj, pj = ref["epoch"]
    for out in ranks:
        loss, p = out["epoch"]
        assert abs(loss - lj) <= 1e-5 * abs(lj)
        assert _grad_relerr(p, pj) <= 1e-4


def test_multihost_helpers(worlds):
    _, _, _, ranks = worlds
    for out in ranks:
        assert all(out["multihost"]), out["multihost"]
