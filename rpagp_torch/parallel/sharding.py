"""Row-sharded execution over a process group (port of
rpagp/parallel/sharding.py; see its docstring for the design).

The training set is the scaling axis: each rank of the `data` axis holds
a contiguous block of rows of x, y, the probes and the SKI geometry;
hyperparameters are replicated. Where the reference runs one program
inside `jax.shard_map`, every function here runs on each rank with its
own rows and takes the `Mesh` whose groups its collectives use
(parallel/comm.py):

* dense kernel: `ring_mvm`, K(local rows, visiting rows) V over a ring,
  the visiting (x, V) shard passed on by ppermute; K4 forward and K5
  backward on the card;
* SKI: `sharded_ski_mvm`, W^T V on the local rows (K2), one (J, t, m)
  psum, the Toeplitz FFT product replicated, W G back on the local rows
  (K3);
* the exact grid solver: `prepare_distributed_grid` assembles S = U^T U,
  U^T y, U^T 1 and the anchored value cache by one psum each, after which
  `distributed_grid_mll` is replicated p-space math (K1) with no
  per-step collective;
* a 2-D mesh (data x comp) shards the J components of the BBMM kernel
  MVM over `comp` (`_slice_components`); the grid solver replicates over
  comp.

Gradients follow the reference's contract (comm.psum's backward is a
psum): `assemble_grads` takes the mean over the world for the grid
solver and SVGP (the reference's pmean over data and over comp), and the
sum over data with the mean over comp for BBMM (its psum over data and
pmean over comp), in one all-reduce of the flattened gradients.

Every rank holds the full training set on the host (the data layer is
deterministic per seed), so the BBMM preconditioner is built on the full
X on every rank, as the reference builds it outside shard_map on the
replicated X, and each rank takes its rows of L.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models import exact_gp
from ..models.exact_gp import ModelSpec
from ..ops import cg as cg_mod
from ..ops import kernels, precond, ski, slq
from ..ops.exact import LOG_2PI
from ..utils.convert import local_rows
from . import comm

AXIS = "data"
COMP_AXIS = "comp"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data x comp) layout of the world's ranks, rank r at (r // comp,
    r % comp) as the reference's devices.reshape(ndata, comp): the groups
    of this rank's data axis (ranks sharing its comp coordinate) and comp
    axis, and its device."""

    data: int
    comp: int
    data_rank: int
    comp_rank: int
    data_group: object
    comp_group: object  # None on a 1-D mesh
    world_group: object
    device: torch.device

    @property
    def world(self) -> int:
        return self.data * self.comp


_MESHES: dict = {}


def make_mesh(comp: int = 1, device=None) -> Mesh:
    """The data mesh over every rank of the initialized world; 2-D (data
    x comp) when comp > 1, where J must divide by comp (the BBMM kernel's
    components shard over comp). Every rank must make the same meshes in
    the same order (new_group is collective). device: this rank's device
    (multihost.initialize's unless given)."""
    from . import multihost

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize() (or start under torchrun) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if comp < 1 or world % comp:
        raise ValueError(f"comp={comp} must divide the {world}-rank world")
    dev = torch.device(device) if device is not None else \
        multihost.initialize()
    key = (comp, str(dev))
    if key in _MESHES:
        return _MESHES[key]
    ndata = world // comp
    world_group = dist.group.WORLD
    if comp == 1:
        data_group, comp_group = world_group, None
    else:
        timeout = multihost.group_timeout()
        for c in range(comp):
            g = dist.new_group([d * comp + c for d in range(ndata)],
                               timeout=timeout)
            if rank % comp == c:
                data_group = g
        for d in range(ndata):
            g = dist.new_group([d * comp + c for c in range(comp)],
                               timeout=timeout)
            if rank // comp == d:
                comp_group = g
    mesh = Mesh(data=ndata, comp=comp, data_rank=rank // comp,
                comp_rank=rank % comp, data_group=data_group,
                comp_group=comp_group, world_group=world_group, device=dev)
    _MESHES[key] = mesh
    return mesh


def shard_rows(arr, mesh: Mesh):
    """This rank's contiguous rows of the full array (numpy or tensor), on
    the mesh's device; the rows must divide by the data axis."""
    return torch.as_tensor(local_rows(arr, mesh.data_rank, mesh.data)).to(
        mesh.device)


def replicate(tree, mesh: Mesh):
    """A dict tree of tensors or arrays (the same on every rank) as
    tensors on the mesh's device."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return torch.as_tensor(tree).to(mesh.device)


def assemble_grads(leaves, mesh: Mesh, data_mean: bool = True):
    """The reference's gradient assembly on each leaf's .grad, in one
    all-reduce over the world: data_mean=True is its pmean over data and
    over comp (the grid solver, SVGP), False its psum over data and pmean
    over comp (BBMM)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                           mesh.world_group)
    flat = flat / (mesh.world if data_mean else mesh.comp)
    off = 0
    for p in leaves:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()


# ---------------------------------------------------------------------------
# Ring blocked MVM (dense kernel) and the grid-psum SKI MVM
# ---------------------------------------------------------------------------


def ring_mvm(kspec, kparams, kbuffers, x_local, v_local, mesh: Mesh,
             block_rows: int = 4096):
    """(K V) rows of the local shard by a ring over the data axis:
    partial = K(x_local, x_visit) @ v_visit, then the visiting (x, V) pair
    moves to the next rank; ndev - 1 ppermutes. On the card K4 computes
    each partial, and K5 its backward."""
    acc, x_visit, v_visit = None, x_local, v_local
    for i in range(mesh.data):
        part = kernels.mvm(kspec, kparams, kbuffers, x_local, x_visit,
                           v_visit, block_rows=block_rows, allow_pallas=True)
        acc = part if acc is None else acc + part
        if i < mesh.data - 1:
            x_visit = comm.ppermute(x_visit, mesh.data_group)
            v_visit = comm.ppermute(v_visit, mesh.data_group)
    return acc


def sharded_ski_mvm(kspec, kparams, state_local: ski.SKIState, v_local,
                    mesh: Mesh, state_out: ski.SKIState = None):
    """K_ski V rows for the output rows (default: the local rows). W^T V
    of the local shard (K2 on the dense plan), one (J, t, m) psum, the
    replicated Toeplitz FFT, the component scales, W G on the output rows
    (K3). state_out: the geometry of other rows on the same grid, such
    as replicated test points (a cross MVM K(out, train) V)."""
    if state_out is None:
        state_out = state_local
    col = ski.toeplitz_columns(kspec, kparams, state_out)  # (J, m)
    scales = kernels._component_scales(kspec, kparams)
    if state_local.order is None:  # the dense plan
        U = ski.dense_interp_transpose(state_local, v_local)
        U = comm.psum(U, mesh.data_group)  # grid-sized traffic
        TU = ski.sym_toeplitz_matmul(col, U)
        return ski.dense_interp_apply_sum(state_out,
                                          scales[:, None, None] * TU)
    U = comm.psum(ski.interp_transpose(state_local, v_local), mesh.data_group)
    TU = ski.sym_toeplitz_matmul(col, U)
    return torch.tensordot(scales, ski.interp_apply(state_out, TU), dims=1).T


# ---------------------------------------------------------------------------
# SKI geometry and components
# ---------------------------------------------------------------------------


@torch.no_grad()
def _global_z_bounds(kspec, kparams, kbuffers, x_local, mesh: Mesh):
    """Per-row global [min, max] of the projections across the data axis."""
    z = ski.project(kspec, kparams, kbuffers, x_local)
    return (comm.pmin(torch.amin(z, dim=1), mesh.data_group),
            comm.pmax(torch.amax(z, dim=1), mesh.data_group))


def _slice_components(spec: ModelSpec, params, buffers, mesh: Mesh):
    """This rank's component shard: the J-indexed kernel params and the
    projection columns sliced by its comp coordinate. Returns (spec_local,
    params_local, buffers_local, J_local). The slice is differentiable:
    its gradient lands zero-padded in the full vector, and the gradient
    assembly's comp mean reassembles the full gradient."""
    kspec = spec.kernel
    csize, cidx = mesh.comp, mesh.comp_rank
    if kspec.J % csize:
        raise ValueError("J must divide by the comp axis")
    if any(d != 1 for d in kspec.degrees):
        raise ValueError("comp sharding: degree-1 components only")
    if len(set(kspec.bases)) > 1:
        raise ValueError("comp sharding requires a uniform base kernel")
    Jl = kspec.J // csize
    sk = kspec.sub_dim
    kspec_l = dataclasses.replace(kspec, J=Jl, degrees=(1,) * Jl,
                                  bases=(kspec.bases[0],) * Jl)
    kp = dict(params["kernel"])
    kp["raw_lengthscale"] = kp["raw_lengthscale"][cidx * Jl:(cidx + 1) * Jl]
    if kspec.per_component_scale:
        kp["raw_outputscale"] = kp["raw_outputscale"][cidx * Jl:
                                                      (cidx + 1) * Jl]
    kb = dict(buffers["kernel"])
    cols = slice(cidx * Jl * sk, (cidx + 1) * Jl * sk)
    if "proj" in kp:
        kp["proj"] = kp["proj"][:, cols]
    elif "proj" in kb:
        kb["proj"] = kb["proj"][:, cols]
    return (kspec_l, {**params, "kernel": kp}, {**buffers, "kernel": kb},
            Jl)


def _components(spec: ModelSpec, params, buffers, mesh: Mesh, comp_axis):
    """(kspec, params, buffers, combine): the component shard on a comp
    axis, whose kernel MVMs `combine` rescales to the global 1/J and sums
    over comp; else the whole kernel and the identity."""
    if comp_axis is None:
        return spec.kernel, params, buffers, lambda v: v
    kspec, params_l, buffers_l, _ = _slice_components(spec, params, buffers,
                                                      mesh)
    w_fix = 1.0 / mesh.comp
    return (kspec, params_l, buffers_l,
            lambda v: comm.psum(w_fix * v, mesh.comp_group))


@torch.no_grad()
def prepare_distributed_ski(spec: ModelSpec, params, buffers, x_local,
                            mesh: Mesh):
    """The SKI geometry of the local rows on the global grid, once per
    dataset (hyperparameter-free), its rows sliced to this rank's
    components on a comp axis. Dense interpolation plan only (the sorted
    plan is built in the step); None where it does not apply."""
    kspec = spec.kernel
    if not kspec.ski or kspec.interp != "dense":
        return None
    kp, kb = params["kernel"], buffers["kernel"]
    bounds = _global_z_bounds(kspec, kp, kb, x_local, mesh)
    st = ski.build_ski(kspec, kp, kb, x_local, kspec.grid_size,
                       z_bounds=bounds)
    if mesh.comp == 1:
        return st
    rows = slice(mesh.comp_rank * (kspec.J // mesh.comp),
                 (mesh.comp_rank + 1) * (kspec.J // mesh.comp))
    return st._replace(grid_lo=st.grid_lo[rows], h=st.h[rows],
                       tfrac=st.tfrac[rows].contiguous())


# ---------------------------------------------------------------------------
# Sharded CG and the BBMM marginal likelihood
# ---------------------------------------------------------------------------


def _psum_dot(a, b, mesh: Mesh):
    return comm.psum(torch.sum(a * b, dim=0), mesh.data_group)


@torch.no_grad()
def sharded_pcg(A_mvm, B, M_inv, iters: int, tol: float, mesh: Mesh):
    """Batched preconditioned CG on row-sharded columns B (n_local, t) for
    exactly `iters` iterations: every dot product is a psum over the data
    axis (rz and |r|^2 share one). Converged columns are frozen by a mask
    and the best iterate per column is kept, as ops.cg.batched_pcg.
    Returns (solution (n_local, t), alphas (iters, t), betas)."""
    R, Z = B, M_inv(B)
    s = comm.psum(torch.stack([torch.sum(R * Z, dim=0),
                               torch.sum(B * B, dim=0)]), mesh.data_group)
    rz, b_norm = s[0], torch.sqrt(s[1])
    b_norm = torch.where(b_norm < 1e-20, torch.ones_like(b_norm), b_norm)
    X = torch.zeros_like(B)
    Pd = Z
    resid = torch.ones(B.shape[1], dtype=B.dtype, device=B.device)
    X_best, r_best = X, resid
    alphas, betas = [], []
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    for _ in range(iters):
        active = resid > tol
        V = A_mvm(Pd)
        pv = _psum_dot(Pd, V, mesh)
        alpha = torch.where(active, rz / cg_mod._guard(pv), zero)
        X = X + alpha * Pd
        R = R - alpha * V
        Zp = M_inv(R)
        s = comm.psum(torch.stack([torch.sum(R * Zp, dim=0),
                                   torch.sum(R * R, dim=0)]), mesh.data_group)
        rz_new = s[0]
        beta = torch.where(active, rz_new / cg_mod._guard(rz), zero)
        Pd = Zp + beta * Pd
        rz = rz_new
        # best-iterate tracking; the residual is next step's mask too
        resid = torch.sqrt(s[1]) / b_norm
        better = resid < r_best
        X_best = torch.where(better[None, :], X, X_best)
        r_best = torch.where(better, resid, r_best)
        alphas.append(alpha)
        betas.append(beta)
    empty = B.new_zeros(0, B.shape[1])
    return (X_best, torch.stack(alphas) if alphas else empty,
            torch.stack(betas) if betas else empty)


def _woodbury(Lp, Cs, noise, mesh: Mesh):
    """M^{-1} R for the row-sharded pivoted-Cholesky preconditioner
    M = L L^T + noise I: one (k, t) psum over the data axis."""

    def M_inv(R):
        u = comm.psum(Lp.T @ R, mesh.data_group)
        return (R - Lp @ precond.cho_solve(Cs, u)) / noise

    return M_inv


def distributed_mll(spec: ModelSpec, params, buffers, x_local, y_local,
                    eps_big_local, mesh: Mesh, pre_L_local=None,
                    pre_chol_small=None, pre_logdet=None, eps_small=None,
                    comp_axis=None, ski_state_local=None):
    """Marginal log-likelihood on row-sharded data (the BBMM estimator).

    Batched PCG (sharded_pcg) on [y_c | probes] with the ring (dense) or
    grid-psum (SKI) MVM, the SLQ logdet from the replicated tridiagonals,
    and differentiable heads whose gradient is the probe trace estimator
    of ops/iterative.py: the value is the SLQ estimate, the gradient that
    of the surrogate (one psum of the two scalar heads).

    eps_big_local: this rank's rows of the (n, t) probe normals. With the
    preconditioner: pre_L_local, this rank's rows of L, pre_chol_small
    and pre_logdet (replicated, built on the full X), eps_small (k, t)
    replicated; probes then carry N(0, M). comp_axis=COMP_AXIS shards the
    components over the mesh's comp axis."""
    noise = exact_gp.noise_value(params)
    nsg = noise.detach()
    n = x_local.shape[0] * mesh.data
    mc = params.get("mean_const")
    yc = y_local if mc is None else y_local - mc
    kspec, params_l, buffers_l, combine = _components(spec, params, buffers,
                                                      mesh, comp_axis)
    kp, kb = params_l["kernel"], buffers_l["kernel"]

    if kspec.ski:
        state = ski_state_local
        if state is None:
            kpd = {k: v.detach() for k, v in kp.items()}
            bounds = _global_z_bounds(kspec, kpd, kb, x_local, mesh)
            state = ski.build_ski(kspec, kpd, kb, x_local, kspec.grid_size,
                                  z_bounds=bounds)
        kmvm = lambda p, V: combine(sharded_ski_mvm(kspec, p, state, V, mesh))
    else:
        kmvm = lambda p, V: combine(ring_mvm(kspec, p, kb, x_local, V, mesh))

    kp_sg = {k: v.detach() for k, v in kp.items()}
    A_mvm_sg = lambda V: kmvm(kp_sg, V) + nsg * V

    with torch.no_grad():
        if pre_L_local is not None:
            Lp = pre_L_local.detach()
            M_inv = _woodbury(Lp, pre_chol_small.detach(), nsg, mesh)
            Z = Lp @ eps_small + torch.sqrt(nsg) * eps_big_local
            precond_logdet = pre_logdet
        else:
            M_inv = lambda R: R / nsg
            Z = torch.sqrt(nsg) * eps_big_local
            precond_logdet = n * torch.log(nsg)
        B = torch.cat([yc.detach()[:, None], Z], dim=1)
        solves, alphas, betas = sharded_pcg(A_mvm_sg, B, M_inv,
                                            spec.cg_max_iters, spec.cg_tol,
                                            mesh)
        alpha_vec, S = solves[:, 0], solves[:, 1:]
        MZ = M_inv(Z)
        T = cg_mod.lanczos_tridiags_from_cg(alphas[:, 1:], betas[:, 1:])
        probe_sq = comm.psum(torch.sum(Z * MZ, dim=0), mesh.data_group)
        logdet_val = slq.slq_logdet_from_tridiags(T, probe_sq,
                                                  precond_logdet)

    # differentiable heads: one batched MVM for both
    AM = torch.cat([alpha_vec[:, None], MZ], dim=1)
    K_AM = kmvm(kp, AM) + noise * AM
    t = S.shape[1]
    heads = comm.psum(torch.stack([
        2.0 * torch.sum(alpha_vec * yc) - torch.sum(alpha_vec * K_AM[:, 0]),
        torch.sum(S * K_AM[:, 1:])]), mesh.data_group)
    inv_quad, surr_tr = heads[0], heads[1] / t  # grad of surr_tr: d logdet
    logdet = logdet_val - surr_tr.detach() + surr_tr
    return -0.5 * (inv_quad + logdet + n * LOG_2PI)


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------


def _preconditioner_rows(spec: ModelSpec, params, buffers, x_full,
                         mesh: Mesh):
    """The pivoted-Cholesky preconditioner at detached params, built on
    the full X (replicated on every rank): (this rank's rows of L,
    chol_small, logdet)."""
    noise = exact_gp.noise_value(params).detach()
    kp = {k: v.detach() for k, v in params["kernel"].items()}
    pre = precond.build_preconditioner(spec.kernel, kp, buffers["kernel"],
                                       x_full, noise, spec.precond_rank)
    return (local_rows(pre.L, mesh.data_rank, mesh.data), pre.chol_small,
            pre.logdet)


def make_distributed_loss(spec: ModelSpec, mesh: Mesh, n_global: int):
    """(loss, assemble): loss(params, buffers, x_local, y_local,
    ski_state=None, grid=None, x_full=None, generator=None), the
    per-datum negative MLL of this rank's step, and assemble(leaves), the
    gradient assembly to run after its backward.

    With grid = (S4, uy, u1, vc) from prepare_distributed_grid the loss is
    distributed_grid_mll (deterministic; uy, u1, vc may be None) and the
    gradients assemble as a mean over the world. Otherwise it is the BBMM
    distributed_mll, drawing its probes from `generator` (every rank draws
    the same (k, t) and (n, t) normals and keeps its rows), with the
    preconditioner built on x_full (the full X) when spec.precond_rank > 0
    without SKI; its gradients assemble as a sum over data and a mean over
    comp."""
    use_pre = spec.precond_rank > 0 and not spec.kernel.ski
    comp_axis = COMP_AXIS if mesh.comp > 1 else None
    mode = {}

    def loss(params, buffers, x_local, y_local, ski_state=None, grid=None,
             x_full=None, generator=None):
        mode["grid"] = grid is not None
        if grid is not None:
            S4, uy, u1, vc = grid
            return -distributed_grid_mll(spec, params, x_local, y_local,
                                         ski_state, S4, mesh, uy=uy, u1=u1,
                                         vc=vc) / n_global
        dev, t = x_local.device, spec.num_probes
        eps_s = torch.randn(max(spec.precond_rank, 0), t, generator=generator,
                            device=dev)
        eps = torch.randn(n_global, t, generator=generator, device=dev)
        pre = (None, None, None)
        if use_pre:
            if x_full is None:
                raise ValueError("the preconditioner needs the full X")
            pre = _preconditioner_rows(spec, params, buffers, x_full, mesh)
        return -distributed_mll(
            spec, params, buffers, x_local, y_local,
            local_rows(eps, mesh.data_rank, mesh.data), mesh,
            pre_L_local=pre[0], pre_chol_small=pre[1], pre_logdet=pre[2],
            eps_small=eps_s if use_pre else None, comp_axis=comp_axis,
            ski_state_local=ski_state) / n_global

    def assemble(leaves):
        assemble_grads(leaves, mesh, data_mean=mode["grid"])

    return loss, assemble


def make_distributed_train_step(spec: ModelSpec, mesh: Mesh, optimizer,
                                n_global: int):
    """One distributed Adam step: step(params, buffers, x_local, y_local,
    ski_state=None, grid=None, x_full=None, generator=None) -> the loss
    (a 0-d device tensor, the same on every rank). `optimizer` holds the
    leaves of `params` (each requires grad); see make_distributed_loss
    for the arguments. Every rank ends the step with the same params."""
    loss_fn, assemble = make_distributed_loss(spec, mesh, n_global)
    leaves = [p for g in optimizer.param_groups for p in g["params"]]

    def step(params, buffers, x_local, y_local, ski_state=None, grid=None,
             x_full=None, generator=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, buffers, x_local, y_local, ski_state, grid,
                       x_full, generator)
        loss.backward()
        assemble(leaves)
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# The exact grid solver, distributed
# ---------------------------------------------------------------------------


@torch.no_grad()
def prepare_distributed_grid(spec: ModelSpec, params, buffers, x_local,
                             mesh: Mesh, y_local=None):
    """(ski_state, S4) for the distributed grid solver: the local rows'
    geometry on the global grid (the full J: comp replicates the grid
    solver) and the replicated (J, M, J, M) Gram S = sum over ranks of
    U_i^T U_i, one psum a dataset. With y_local, (ski_state, S4, uy, u1,
    vc): U^T y and U^T 1 (one psum) and the anchored value cache (q0 by a
    replicated ridge solve, the residual on the local rows, four scalars
    in one psum), after which distributed_grid_mll has no per-step
    collective. Nones when the spec does not run the grid solver."""
    from ..ops import grid_solve

    kspec = spec.kernel
    n_global = x_local.shape[0] * mesh.data
    if kspec.interp != "dense" or not grid_solve.use_grid_solver(spec,
                                                                 n_global):
        return (None, None) if y_local is None else (None,) * 5
    kp, kb = params["kernel"], buffers["kernel"]
    bounds = _global_z_bounds(kspec, kp, kb, x_local, mesh)
    state = grid_solve._build_geometry(kspec, kp, kb, x_local,
                                       kspec.grid_size, z_bounds=bounds)
    S4 = comm.psum(grid_solve._build_gram(kspec, state), mesh.data_group)
    if y_local is None:
        return state, S4
    U = comm.psum(torch.stack(grid_solve.build_interp_y(kspec, state,
                                                        y_local)),
                  mesh.data_group)
    uy, u1 = U[0], U[1]
    q0 = grid_solve._anchor_q0(S4, uy)
    r = y_local - grid_solve._interp_A(kspec, state, q0[:, None, :])[:, 0]
    s = comm.psum(torch.stack([torch.dot(y_local, r), torch.sum(r),
                               torch.sum(y_local),
                               torch.dot(y_local, y_local)]),
                  mesh.data_group)
    vc = {"q0": q0, "a0": s[0], "a1": s[1], "sy": s[2], "yy": s[3]}
    return state, S4, uy, u1, vc


def _grid_chol_fn(p: int, mesh: Mesh):
    """The p x p factor of the distributed grid solver: None (the
    replicated blocked factor) below the banding threshold, else
    dist_chol's row-banded fallback ladder over the data axis
    (dist_chol.use_distributed_factor)."""
    from . import dist_chol

    if not dist_chol.use_distributed_factor(p, mesh.data):
        return None
    return lambda C, nz: dist_chol.distributed_chol_with_fallback_eps(
        C, nz, mesh)


def distributed_grid_mll(spec: ModelSpec, params, x_local, y_local,
                         state_local: ski.SKIState, S4, mesh: Mesh, uy=None,
                         u1=None, vc=None):
    """The EXACT grid-space Woodbury MLL on row-sharded data (the mirror of
    ops.grid_solve.grid_mll). The p-space factor runs replicated on every
    rank (K1's ladder batch and leaves; banded over the data axis past
    dist_chol's threshold). Without the per-dataset caches U^T yc is one
    (J, M) psum and the loss shares one two-scalar psum; with (uy, u1) and
    vc from prepare_distributed_grid the step runs no collective.

    Gradient contract: a rank's gradient of the replicated parameters,
    summed over the data axis, is ndev times the true one (comm.psum), so
    the caller takes the mean over data (and over comp on a 2-D mesh):
    assemble_grads(..., data_mean=True)."""
    from ..ops import grid_solve

    n = x_local.shape[0] * mesh.data
    noise = exact_gp.noise_value(params)
    p = S4.shape[0] * S4.shape[1]
    mc = params.get("mean_const")
    yc = y_local if mc is None else y_local - mc

    G, Lc = grid_solve._factor(spec, params["kernel"], state_local, S4, noise,
                               chol_fn=_grid_chol_fn(p, mesh))
    if uy is not None:
        U = uy - mc * u1 if spec.mean == "constant" else uy
    else:
        U = grid_solve._interp_T(spec.kernel, state_local,
                                 yc[:, None])[:, 0, :]
        U = comm.psum(U, mesh.data_group)
    b = grid_solve._Gt_apply(G, U)
    w = torch.cholesky_solve(b[:, None], Lc)[:, 0]
    Gw = grid_solve._G_apply(G, w)
    if vc is not None and uy is not None:
        iq = grid_solve._anchored_iq(spec, params, vc, U, Gw, n) / noise
    else:
        # value from the local residual pass, gradient from the
        # replicated linear form; one psum of the two scalar shares
        Vw = grid_solve._interp_A(spec.kernel, state_local,
                                  Gw.detach()[:, None, :])[:, 0]
        ycd = yc.detach()
        ss = comm.psum(torch.stack([torch.dot(ycd, ycd - Vw),
                                    torch.dot(yc, yc)]), mesh.data_group)
        lin = ss[1] - torch.sum(U * Gw)
        iq = (lin + (ss[0] - lin).detach()) / noise
    ld = (n - p) * torch.log(noise) + 2.0 * torch.sum(
        torch.log(torch.diagonal(Lc)))
    return -0.5 * (iq + ld + n * LOG_2PI)


@torch.no_grad()
def distributed_grid_posterior(spec: ModelSpec, params, buffers, x_local,
                               y_local, x_test, mesh: Mesh,
                               observation_noise: bool = True):
    """The EXACT posterior (mu, var) at replicated test points on the grid
    path (the mirror of grid_solve.grid_posterior): the grid over the
    union of the train (global) and test projections, then three psums,
    each paid once a call: S, U^T yc, and the bounds. Everything after is
    replicated p-space math, so the test points need no collective."""
    from ..ops import grid_solve

    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    noise = exact_gp.noise_value(params)
    z_tr = ski.project(kspec, kp, kb, x_local)
    z_te = ski.project(kspec, kp, kb, x_test)
    lo = comm.pmin(torch.minimum(torch.amin(z_tr, dim=1),
                                 torch.amin(z_te, dim=1)), mesh.data_group)
    hi = comm.pmax(torch.maximum(torch.amax(z_tr, dim=1),
                                 torch.amax(z_te, dim=1)), mesh.data_group)
    st_train = grid_solve._build_geometry(kspec, kp, kb, x_local,
                                          kspec.grid_size, z_bounds=(lo, hi))
    S4 = comm.psum(grid_solve._build_gram(kspec, st_train), mesh.data_group)
    yc = y_local - exact_gp.mean_fn(spec, params, x_local)
    p = S4.shape[0] * S4.shape[1]
    G, Lc = grid_solve._factor(spec, kp, st_train, S4, noise,
                               chol_fn=_grid_chol_fn(p, mesh))
    # the direct mean-cache form q = G C^-1 b (grid_solve._posterior_factor)
    U = comm.psum(grid_solve._interp_T(kspec, st_train, yc[:, None])[:, 0, :],
                  mesh.data_group)
    b = grid_solve._Gt_apply(G, U)
    q = grid_solve._G_apply(G, torch.cholesky_solve(b[:, None], Lc)[:, 0])
    st_test, mu = grid_solve._test_mean(spec, params, buffers, (lo, hi), q,
                                        x_test)
    return mu, grid_solve._test_var(spec, params, buffers, st_test, (G, Lc),
                                    noise, x_test, observation_noise)


# ---------------------------------------------------------------------------
# Distributed posterior: sharded mean solve, sharded LOVE, chunked CG
# ---------------------------------------------------------------------------


@torch.no_grad()
def distributed_posterior(spec: ModelSpec, params, buffers, x_local,
                          y_local, x_test, fresh_local, mesh: Mesh,
                          pre_L_local=None, pre_chol_small=None,
                          comp_axis=None, observation_noise: bool = True,
                          var_chunk: int = 256, var_tol: float = 1e-2):
    """Posterior predictive (mu, var) at replicated test points from
    row-sharded training data (the mirror of iterative_posterior):

      * the mean cache alpha = A^{-1} y_c by one sharded PCG of
        4 cg_max_iters iterations at tol 1e-4;
      * with spec.love_rank > 0, variances from a sharded LOVE cache:
        Lanczos over the ring / grid-psum MVM with row-local Q and
        psum-reduced scalars (love.lanczos(rsum=)); the test-side cross
        MVM K(x*, X) Q costs one psum;
      * else chunked-CG variances, var_chunk test points a sharded PCG.

    fresh_local: (rank, n_local), this rank's columns of one global table
    of restart normals (the Lanczos restarts must agree across ranks).
    pre_L_local / pre_chol_small: the preconditioner's rows (non-SKI)."""
    from ..ops import love

    noise = exact_gp.noise_value(params)
    n_test = x_test.shape[0]
    kspec, params_l, buffers_l, combine = _components(spec, params, buffers,
                                                      mesh, comp_axis)
    kp, kb = params_l["kernel"], buffers_l["kernel"]
    group = mesh.data_group
    yc = y_local - exact_gp.mean_fn(spec, params, x_local)

    st_train = st_test = None
    if kspec.ski:
        # one grid over the union of the train (global) and test points
        z_tr = ski.project(kspec, kp, kb, x_local)
        z_te = ski.project(kspec, kp, kb, x_test)
        lo = torch.minimum(comm.pmin(torch.amin(z_tr, dim=1), group),
                           torch.amin(z_te, dim=1))
        hi = torch.maximum(comm.pmax(torch.amax(z_tr, dim=1), group),
                           torch.amax(z_te, dim=1))
        st_train = ski.build_ski(kspec, kp, kb, x_local, kspec.grid_size,
                                 z_bounds=(lo, hi))
        st_test = ski.build_ski(kspec, kp, kb, x_test, kspec.grid_size,
                                z_bounds=(lo, hi))
        kmvm = lambda V: combine(sharded_ski_mvm(kspec, kp, st_train, V,
                                                 mesh))
        cross = lambda V: combine(sharded_ski_mvm(kspec, kp, st_train, V,
                                                  mesh, state_out=st_test))
        kd = combine(ski.ski_gram_diag(kspec, kp, st_test))
    else:
        kmvm = lambda V: combine(ring_mvm(kspec, kp, kb, x_local, V, mesh))
        cross = lambda V: combine(comm.psum(kernels.mvm(
            kspec, kp, kb, x_test, x_local, V, allow_pallas=True), group))
        kd = combine(kernels.gram_diag(kspec, kp, kb, x_test))
    A_mvm = lambda V: kmvm(V) + noise * V
    M_inv = (lambda R: R / noise) if pre_L_local is None else \
        _woodbury(pre_L_local, pre_chol_small, noise, mesh)

    sol, _, _ = sharded_pcg(A_mvm, yc[:, None], M_inv, 4 * spec.cg_max_iters,
                            1e-4, mesh)
    mu = cross(sol)[:, 0] + exact_gp.mean_fn(spec, params, x_test)

    if spec.love_rank > 0:
        Q, T = love.lanczos(A_mvm, yc, spec.love_rank,
                            rsum=lambda s: comm.psum(s, group),
                            fresh=fresh_local)
        T = T + 1e-6 * torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
        w = torch.linalg.solve_triangular(precond.cholesky_nan(T), cross(Q).T,
                                          upper=False)
        var = torch.clamp(kd - torch.sum(w * w, dim=0), min=1e-10)
        return mu, var + noise if observation_noise else var

    eye = torch.eye(var_chunk, dtype=x_local.dtype, device=x_local.device)
    if kspec.ski:
        col = ski.toeplitz_columns(kspec, kp, st_train)
        scales = kernels._component_scales(kspec, kp)
    var = []
    for s in range(0, n_test, var_chunk):
        c = min(var_chunk, n_test - s)
        if kspec.ski:
            # the chunk's geometry on the shared grid; padded slots get
            # tfrac -100: all-zero taps
            tf = torch.nn.functional.pad(st_test.tfrac[:, s:s + c],
                                         (0, var_chunk - c), value=-100.0)
            U = ski.dense_interp_transpose(st_test._replace(tfrac=tf), eye)
            Kc = ski.dense_interp_apply_sum(
                st_train,
                scales[:, None, None] * ski.sym_toeplitz_matmul(col, U))
        else:
            xc = torch.nn.functional.pad(x_test[s:s + c],
                                         (0, 0, 0, var_chunk - c))
            Kc = kernels.mvm(kspec, kp, kb, x_local, xc, eye,
                             allow_pallas=True)
        Kc = combine(Kc)  # (n_local, var_chunk)
        sol_c, _, _ = sharded_pcg(A_mvm, Kc, M_inv, 2 * spec.cg_max_iters,
                                  var_tol, mesh)
        kd_c = torch.nn.functional.pad(kd[s:s + c], (0, var_chunk - c))
        var.append(kd_c - comm.psum(torch.sum(Kc * sol_c, dim=0), group))
    var = torch.clamp(torch.cat(var)[:n_test], min=1e-10)
    return mu, var + noise if observation_noise else var


def make_distributed_posterior(spec: ModelSpec, mesh: Mesh, n_global: int,
                               observation_noise: bool = True,
                               var_chunk: int = 256):
    """predict(params, buffers, x_local, y_local, x_test, generator=None,
    x_full=None, fresh=None) -> (mu, var) at the test points, replicated,
    without gathering the training set. Specs on the exact grid solver
    take distributed_grid_posterior. Otherwise the LOVE restart table
    (rank, n_global) is `fresh`, or drawn from `generator` (the same on
    every rank; seed 0 on the device when None), and sliced to this
    rank's columns, and the preconditioner (non-SKI, spec.precond_rank >
    0) is built on x_full."""
    from ..ops import grid_solve

    if spec.kernel.interp == "dense" and grid_solve.use_grid_solver(
            spec, n_global):
        def predict_grid(params, buffers, x_local, y_local, x_test,
                         generator=None, x_full=None, fresh=None):
            return distributed_grid_posterior(
                spec, params, buffers, x_local, y_local, x_test, mesh,
                observation_noise=observation_noise)

        return predict_grid
    use_pre = spec.precond_rank > 0 and not spec.kernel.ski
    comp_axis = COMP_AXIS if mesh.comp > 1 else None
    rank = max(spec.love_rank, 1)

    @torch.no_grad()
    def predict(params, buffers, x_local, y_local, x_test, generator=None,
                x_full=None, fresh=None):
        dev = x_local.device
        if fresh is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            fresh = torch.randn(rank, n_global, generator=generator,
                                device=dev)
        Lp = Cs = None
        if use_pre:
            Lp, Cs, _ = _preconditioner_rows(spec, params, buffers, x_full,
                                             mesh)
        return distributed_posterior(
            spec, params, buffers, x_local, y_local, x_test,
            local_rows(fresh, mesh.data_rank, mesh.data, axis=1), mesh,
            pre_L_local=Lp, pre_chol_small=Cs, comp_axis=comp_axis,
            observation_noise=observation_noise, var_chunk=var_chunk)

    return predict


# ---------------------------------------------------------------------------
# Distributed SVGP
# ---------------------------------------------------------------------------


def distributed_elbo(spec: ModelSpec, params, buffers, x_local, y_local,
                     n_total: int, mesh: Mesh):
    """The SVGP minibatch ELBO on a row-sharded batch (the mirror of
    models.svgp.elbo): the M x M algebra replicated, the likelihood rows
    sharded, one scalar psum. Gradients assemble as the grid solver's (a
    mean over the data axis)."""
    from ..models import svgp

    b = x_local.shape[0] * mesh.data
    mu, var = svgp._predictive_qf(spec, params, buffers, x_local)
    noise = exact_gp.noise_value(params)
    lik = -0.5 * (LOG_2PI + torch.log(noise) + (y_local - mu) ** 2 / noise)
    lik = lik - 0.5 * var / noise
    lik_term = (n_total / b) * comm.psum(torch.sum(lik), mesh.data_group)
    C = svgp._var_chol(params)
    vm = params["var_mean"]
    kl = 0.5 * (torch.sum(C * C) + vm @ vm - vm.shape[0]
                - 2.0 * torch.sum(torch.log(torch.diagonal(C))))
    return lik_term - kl


def make_distributed_svgp_epoch(spec: ModelSpec, mesh: Mesh, optimizer,
                                n_total: int, steps: int, batch: int):
    """One distributed SVGP epoch: epoch(params, buffers, x, y, generator)
    -> the steps' mean loss (a device tensor). Every rank draws the same
    permutation of the full (x, y) from `generator` (seeded alike on every
    rank), takes `steps` batches of `batch` rows, and of each batch its
    own rows (batch must divide by the data axis); each step is one
    value-and-grad, the mean of the gradients over the data axis and one
    Adam step; a comp axis replicates (the M-sized state replicates).
    perm: a given (n_total,) permutation in place of the generator's."""
    if batch % mesh.data:
        raise ValueError(f"batch {batch} must divide by the data axis "
                         f"{mesh.data}")
    bl = batch // mesh.data
    lo = mesh.data_rank * bl
    leaves = [p for g in optimizer.param_groups for p in g["params"]]

    def epoch(params, buffers, x, y, generator=None, perm=None):
        if perm is None:
            perm = torch.randperm(n_total, generator=generator,
                                  device=x.device)
        idx = perm[:steps * batch].reshape(steps, batch)[:, lo:lo + bl]
        xs, ys = x[idx], y[idx]
        total = torch.zeros((), device=x.device)
        for xb, yb in zip(xs, ys):
            optimizer.zero_grad(set_to_none=True)
            loss = -distributed_elbo(spec, params, buffers, xb, yb, n_total,
                                     mesh) / n_total
            loss.backward()
            assemble_grads(leaves, mesh, data_mean=True)
            optimizer.step()
            total = total + loss.detach()
        return total / steps

    return epoch
