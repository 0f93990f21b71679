"""rpagp_torch.parallel's BBMM path against the JAX package's SPMD
functions, on the CPU: the ring MVM, the grid-psum SKI MVM, the sharded
PCG and the distributed BBMM marginal likelihood.

Each case spawns a gloo world of CPU ranks (rpagp_torch.parallel.launch)
and holds every rank's rows against the reference's shard_map program on
a JAX mesh of the same shape from jax.devices("cpu") (tests/conftest.py's
8 virtual devices): worlds of 2 and 4 ranks and a 2 x 2 data x comp mesh,
on which distributed_mll shards the components over comp. The probe
normals and the preconditioner come from the reference as numpy arrays,
each rank taking its rows (utils.convert.local_rows). This module imports
JAX only inside functions, because the workers import it.

Bars: ring_mvm against the dense K V and the SKI MVMs against the
reference rel <= 1e-5; the PCG's solutions and recurrences rel <= 1e-4;
distributed_mll value rel <= 1e-4 and gradient relerr <= 1e-3 (the BBMM
bars of ROADMAP.md: f32 CG in another summation order), with the
reference's gradient assembly (psum over data, pmean over comp).
"""

import numpy as np
import pytest
import torch

from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import ski
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.parallel import launch, sharding
from rpagp_torch.train import _leaves
from rpagp_torch.utils.convert import local_rows, to_numpy, to_torch

WORLDS = [(2, 1), (4, 1), (4, 2)]  # (ranks, comp)
IDS = ["w2", "w4", "2x2"]
N, D, J, T, RANK, M = 256, 4, 4, 6, 10, 64
CG_ITERS = 25
# the PCG check's iterations: all before convergence, where the f32
# recurrences still carry signal rather than roundoff
PCG_ITERS = 8


def _specs(jax_pkg: bool):
    """(dense BBMM spec, SKI + BBMM spec) of either package."""
    if jax_pkg:
        from rpagp.models.exact_gp import ModelSpec as MS
        from rpagp.ops.kernels import KernelSpec as KS
    else:
        MS, KS = ModelSpec, KernelSpec
    common = dict(cg_max_iters=CG_ITERS, cg_tol=1e-8, num_probes=T,
                  max_cholesky_size=64, solver="bbmm")
    return (MS(kernel=KS.polynomial(J=J, d=1), precond_rank=RANK, **common),
            MS(kernel=KS.polynomial(J=J, d=1, ski=True, grid_size=M),
               precond_rank=0, **common))


def _data():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.3 * rng.standard_normal(N)).astype(
        np.float32)
    return dict(x=x, y=y,
                V=rng.standard_normal((N, 5)).astype(np.float32),
                eps=rng.standard_normal((N, T)).astype(np.float32),
                eps_s=rng.standard_normal((RANK, T)).astype(np.float32),
                ls=rng.uniform(-0.5, 0.5, J).astype(np.float32))


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
    from jax.sharding import PartitionSpec as P

    from rpagp.models import exact_gp as jgp
    from rpagp.ops import kernels as jk
    from rpagp.ops import precond as jpre
    from rpagp.ops import ski as jski
    from rpagp.parallel import sharding as jsh

    spec, sspec = _specs(True)
    jp, jb = jgp.init_model(jax.random.key(2), spec, D)
    jp = {**jp, "raw_noise": jnp.float32(-1.0),
          "mean_const": jnp.float32(0.1),
          "kernel": {**jp["kernel"], "raw_lengthscale": jnp.asarray(d["ls"]),
                     "raw_outputscale": jnp.float32(0.2)}}
    kp, kb = jp["kernel"], jb["kernel"]
    mesh = jsh.make_mesh(jax.devices("cpu")[:world], comp=comp)
    A = P(jsh.AXIS)
    x, y, V = (jnp.asarray(d[k]) for k in ("x", "y", "V"))
    comp_axis = jsh.COMP_AXIS if comp > 1 else None

    def smap(fn, in_specs, out_specs):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    out = {"params": jax.device_get(jp), "proj": np.asarray(kb["proj"])}
    out["dense_KV"] = np.asarray(jk.gram(spec.kernel, kp, kb, x, x)) @ d["V"]

    def ski_mvm(plan):
        def f(xl, vl):
            ks = sspec.kernel.__class__(**{**sspec.kernel.__dict__,
                                           "interp": plan})
            bounds = jsh._global_z_bounds(ks, kp, kb, xl)
            st = jski.build_ski(ks, kp, kb, xl, M, z_bounds=bounds)
            return jsh.sharded_ski_mvm(ks, kp, st, vl)

        return np.asarray(smap(f, (A, A), A)(x, V))

    out["ski_dense"], out["ski_sorted"] = ski_mvm("dense"), ski_mvm("sorted")

    noise = jgp.noise_value(jp)
    pre = jax.jit(jpre.build_preconditioner, static_argnums=(0, 5))(
        spec.kernel, kp, kb, x, noise, RANK)
    out["pre"] = tuple(np.asarray(a) for a in (pre.L, pre.chol_small,
                                               pre.logdet))

    def pcg(xl, B, Lp):
        A_mvm = lambda W: jsh.ring_mvm(spec.kernel, kp, kb, xl, W) + noise * W

        def M_inv(R):
            u = jax.lax.psum(Lp.T @ R, jsh.AXIS)
            w = jax.scipy.linalg.cho_solve((pre.chol_small, True), u)
            return (R - Lp @ w) / noise

        return jsh.sharded_pcg(A_mvm, B, M_inv, PCG_ITERS, 1e-8)

    out["pcg"] = tuple(np.asarray(a) for a in smap(
        pcg, (A, A, A), (A, P(), P()))(x, jnp.asarray(d["eps"]), pre.L))

    eps, eps_s = jnp.asarray(d["eps"]), jnp.asarray(d["eps_s"])

    def mll_vg(sp, with_pre, ski_state=None):
        def f(p, xl, yl, el, Lp, *st):
            kw = dict(comp_axis=comp_axis,
                      ski_state_local=st[0] if st else None)
            if with_pre:
                kw.update(pre_L_local=Lp, pre_chol_small=pre.chol_small,
                          pre_logdet=pre.logdet, eps_small=eps_s)
            v, g = jax.value_and_grad(
                lambda pp: jsh.distributed_mll(sp, pp, jb, xl, yl, el,
                                               **kw))(p)
            g = jax.lax.psum(g, jsh.AXIS)
            if comp_axis is not None:
                g = jax.lax.pmean(g, comp_axis)
            return v, g

        st = () if ski_state is None else (ski_state,)
        specs = (P(), A, A, A, A) + ((jsh._ski_state_in_specs(comp_axis),)
                                      if st else ())
        v, g = smap(f, specs, (P(), P()))(jp, x, y, eps, pre.L, *st)
        return float(v), jax.device_get(g)

    out["mll_pre"] = mll_vg(spec, True)
    out["mll_plain"] = mll_vg(spec, False)
    sst = jsh.prepare_distributed_ski(sspec, jsh.replicate(jp, mesh),
                                      jsh.replicate(jb, mesh),
                                      jsh.shard_rows(x, mesh), mesh)
    out["mll_ski"] = mll_vg(sspec, False, sst)
    return out


# --------------------------------------------------------- the workers ----

def _grads(p):
    return {k: (_grads(v) if isinstance(v, dict) else v.grad.numpy())
            for k, v in p.items()}


def rank_bbmm(mesh, d, ref_params, proj, pre):
    from rpagp_torch.models import exact_gp
    from rpagp_torch.parallel import comm

    spec, sspec = _specs(False)
    params = to_torch(ref_params, "cpu")
    buffers = {"kernel": {"proj": torch.from_numpy(proj)}}
    kp, kb = params["kernel"], buffers["kernel"]
    rows = lambda a: sharding.shard_rows(torch.from_numpy(a), mesh)
    xl, yl, Vl, el = rows(d["x"]), rows(d["y"]), rows(d["V"]), rows(d["eps"])
    Lp = rows(pre[0])
    Cs, ld = torch.from_numpy(pre[1]), torch.from_numpy(pre[2])
    eps_s = torch.from_numpy(d["eps_s"])
    out = {"ring": sharding.ring_mvm(spec.kernel, kp, kb, xl, Vl,
                                     mesh).numpy()}
    for plan in ("dense", "sorted"):
        import dataclasses

        ks = dataclasses.replace(sspec.kernel, interp=plan)
        bounds = sharding._global_z_bounds(ks, kp, kb, xl, mesh)
        st = ski.build_ski(ks, kp, kb, xl, M, z_bounds=bounds)
        out["ski_" + plan] = sharding.sharded_ski_mvm(ks, kp, st, Vl,
                                                      mesh).numpy()

    noise = exact_gp.noise_value(params)
    A_mvm = lambda W: sharding.ring_mvm(spec.kernel, kp, kb, xl, W,
                                        mesh) + noise * W
    M_inv = sharding._woodbury(Lp, Cs, noise, mesh)
    out["pcg"] = tuple(a.numpy() for a in sharding.sharded_pcg(
        A_mvm, el, M_inv, PCG_ITERS, 1e-8, mesh))

    comp_axis = sharding.COMP_AXIS if mesh.comp > 1 else None

    def mll_vg(sp, with_pre, ski_state=None):
        p = to_torch(to_numpy(params), "cpu")
        leaves = _leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        kw = dict(comp_axis=comp_axis, ski_state_local=ski_state)
        if with_pre:
            kw.update(pre_L_local=Lp, pre_chol_small=Cs, pre_logdet=ld,
                      eps_small=eps_s)
        v = sharding.distributed_mll(sp, p, buffers, xl, yl, el, mesh, **kw)
        v.backward()
        sharding.assemble_grads(leaves, mesh, data_mean=False)
        return float(v.detach()), _grads(p)

    out["mll_pre"] = mll_vg(spec, True)
    out["mll_plain"] = mll_vg(spec, False)
    out["mll_ski"] = mll_vg(sspec, False, sharding.prepare_distributed_ski(
        sspec, params, buffers, xl, mesh))
    # gloo takes CPU tensors only: one on another device is refused before
    # the collective (a meta tensor: this machine has no card)
    try:
        comm.psum(torch.zeros(1, device="meta"), mesh.data_group)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=IDS)
def worlds(request):
    world, comp = request.param
    d = _data()
    ref = _reference(world, comp, d)
    ranks = launch.run_world(rank_bbmm, world,
                             args=(d, ref["params"], ref["proj"], ref["pre"]),
                             comp=comp)
    return world, comp, ref, ranks


def _block(a, r, world, comp):
    return local_rows(a, r // comp, world // comp)


def test_ring_mvm_matches_dense_kv(worlds):
    world, comp, ref, ranks = worlds
    for r, out in enumerate(ranks):
        assert _rel(out["ring"], _block(ref["dense_KV"], r, world,
                                        comp)) <= 1e-5


@pytest.mark.parametrize("plan", ["dense", "sorted"])
def test_sharded_ski_mvm_matches_reference(worlds, plan):
    world, comp, ref, ranks = worlds
    for r, out in enumerate(ranks):
        assert _rel(out["ski_" + plan],
                    _block(ref["ski_" + plan], r, world, comp)) <= 1e-5


def test_sharded_pcg_matches_reference(worlds):
    world, comp, ref, ranks = worlds
    for r, out in enumerate(ranks):
        sol, al, be = out["pcg"]
        assert _rel(sol, _block(ref["pcg"][0], r, world, comp)) <= 1e-4
        assert _rel(al, ref["pcg"][1]) <= 1e-4
        assert _rel(be, ref["pcg"][2]) <= 1e-4


@pytest.mark.parametrize("which", ["mll_pre", "mll_plain", "mll_ski"])
def test_distributed_mll_matches_reference(worlds, which):
    """With and without the preconditioner on the ring, and on SKI; on the
    2 x 2 mesh the components shard over comp."""
    _, _, ref, ranks = worlds
    vj, gj = ref[which]
    for out in ranks:
        v, g = out[which]
        assert abs(v - vj) <= 1e-4 * abs(vj)
        assert _grad_relerr(g, gj) <= 1e-3


def test_collectives_refuse_the_wrong_device(worlds):
    _, _, _, ranks = worlds
    assert all(out["refused"] for out in ranks)
