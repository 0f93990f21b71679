"""Exact GP model: mean + projected kernel + Gaussian likelihood
(subset of rpagp/models/exact_gp.py: the grid-solver and BBMM paths).

The model is a static `ModelSpec` plus two dicts of tensors:
  params:  {"raw_noise", "mean_const", "kernel": {"raw_lengthscale",
            "raw_outputscale"}}
  buffers: {"kernel": {"proj"}} plus, after prepare_buffers, the SKI
           geometry and the per-dataset grid caches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import kernels
from ..ops.kernels import KernelSpec
from ..utils.transforms import softplus

NOISE_FLOOR = 1e-4


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model configuration; the same fields as the JAX package's
    ModelSpec (see its docstring for their meaning)."""

    kernel: KernelSpec
    mean: str = "constant"
    jitter: float = 1e-6
    max_cholesky_size: int = 4096
    cg_tol: float = 1e-2
    cg_max_iters: int = 100
    precond_rank: int = 15
    num_probes: int = 10
    mvm_block_rows: int = 4096
    love_rank: int = 0
    precond_refresh: int = 1
    solver: str = "auto"
    grid_jitter: float = 1e-6


def init_model(spec: ModelSpec, D: int, generator=None, proj=None,
               device="cpu"):
    """(params, buffers) for a fresh model; raw values start at 0 (the
    GPyTorch defaults). proj: an explicit projection matrix, else one is
    drawn from `generator`."""
    kp, kb = kernels.init_kernel_params(spec.kernel, D, generator=generator,
                                        proj=proj, device=device)
    params = {"raw_noise": torch.zeros((), device=device), "kernel": kp}
    if spec.mean == "constant":
        params["mean_const"] = torch.zeros((), device=device)
    return params, {"kernel": kb}


@torch.no_grad()
def prepare_buffers(spec: ModelSpec, params, buffers, x_train, y_train=None):
    """Attach the per-dataset grid-solver caches (hyperparameter-free):
    the SKI geometry and S = U^T U; with y_train also U^T y, U^T 1 and
    the anchored value cache, after which the MLL step does no work that
    scales with n. Only evaluate grid_mll on this same split afterwards.
    A spec without SKI needs no cache: its buffers come back unchanged."""
    from ..ops import grid_solve

    if not spec.kernel.ski:
        if spec.precond_refresh > 1 and spec.precond_rank > 0:
            raise NotImplementedError(
                "precond_refresh > 1 (the cached preconditioner): ROADMAP "
                "slice 10")
        return buffers
    if not grid_solve.use_grid_solver(spec, x_train.shape[0]):
        raise NotImplementedError(
            "SKI + BBMM (the SKI geometry cache, ski.ski_mvm): ROADMAP "
            "slice 3")
    kspec = spec.kernel
    state = grid_solve.ski.build_ski(kspec, params["kernel"],
                                     buffers["kernel"], x_train,
                                     kspec.grid_size)
    S4 = grid_solve.build_interp_gram(state)
    out = {**buffers, "ski_state": state, "ski_uu": S4}
    if y_train is not None:
        uy, u1 = grid_solve.build_interp_y(kspec, state, y_train)
        vc = grid_solve.build_value_cache(kspec, state, S4, y_train, uy)
        out.update(ski_uy=uy, ski_u1=u1, ski_vc=vc)
    return out


def noise_value(params):
    return softplus(params["raw_noise"]) + NOISE_FLOOR


def mean_fn(spec: ModelSpec, params, x):
    n = x.shape[0]
    ones = torch.ones(n, dtype=x.dtype, device=x.device)
    if spec.mean == "constant":
        return ones * params["mean_const"]
    return ones * 0.0
