"""SKI grid interpolation, dense plan (subset of rpagp/ops/ski.py).

Per component j, K_j ~= W_j T_j W_j^T with W_j the cubic-convolution
interpolation of the projected coordinates onto a regular m-point grid
and T_j the (Toeplitz) base kernel on the grid. The geometry depends
only on the data and the fixed projections, so it is built once per
dataset; only the Toeplitz columns change with the hyperparameters.

The two interpolation directions run on kernels K2 / K3
(ops/cuda_interp.py) and are each other's backward, as the JAX
package's custom_vjp pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.transforms import softplus
from . import cuda_interp
from .cuda_interp import cubic_kernel as _cubic_kernel  # noqa: F401
from .kernels import KernelSpec, _get_proj, _k1d


class SKIState(NamedTuple):
    """Per-dataset interpolation geometry (dense plan) for J components."""

    grid_lo: torch.Tensor  # (J,) left grid endpoint per component
    h: torch.Tensor  # (J,) grid spacing per component
    cells: torch.Tensor  # (m,) f32 cell indices 0..m-1
    tfrac: torch.Tensor  # (J, n) fractional grid coordinate, contiguous

    @property
    def m(self) -> int:
        return self.cells.shape[0]


def project(spec: KernelSpec, kparams, kbuffers, x):
    """Raw projected coordinates z = (x P)^T — (J, n); not lengthscale-
    scaled, so the grid is hyperparameter-free."""
    return (x @ _get_proj(kparams, kbuffers)).T


def build_ski(spec: KernelSpec, kparams, kbuffers, x, grid_size: int,
              z_bounds=None):
    """SKI geometry for inputs x (once per dataset). z_bounds: optional
    (lo (J,), hi (J,)) for a grid covering more than x."""
    if (not spec.is_projection or any(d != 1 for d in spec.degrees)
            or spec.sub_dim != 1):
        raise NotImplementedError(
            "SKI here supports degree-1, sub_dim-1 projection kernels only "
            "(product SKI is ROADMAP slice 9)")
    if spec.learn_proj:
        raise ValueError("learn_proj=True is incompatible with ski=True: "
                         "the SKI interpolation geometry is fixed at "
                         "prepare time, so projection gradients are zero")
    if spec.interp != "dense":
        raise NotImplementedError("the sorted interp plan is ROADMAP slice 10")
    z = project(spec, kparams, kbuffers, x)
    return _geometry_from_z(z, int(grid_size), z_bounds)


def _geometry_from_z(z, m: int, z_bounds):
    if z_bounds is None:
        lo, hi = torch.amin(z, dim=1), torch.amax(z, dim=1)
    else:
        lo, hi = z_bounds
    span = torch.clamp(hi - lo, min=1e-6)
    # pad by 2 cells each side so all 4 cubic taps stay interior
    h = span / (m - 5)
    grid_lo = lo - 2.0 * h
    cells = torch.arange(m, dtype=z.dtype, device=z.device)
    t = ((z - grid_lo[:, None]) / h[:, None]).contiguous()
    return SKIState(grid_lo=grid_lo, h=h, cells=cells, tfrac=t)


def toeplitz_columns(spec: KernelSpec, kparams, state: SKIState):
    """First columns of the T_j: k1d(g_a - g_0) over the grid — (J, m)."""
    ls = softplus(kparams["raw_lengthscale"])
    scaled = state.cells[None, :] * state.h[:, None] / ls[:, None]
    if all(b == spec.bases[0] for b in spec.bases):
        return _k1d(spec.bases[0], scaled)
    rows = [_k1d(b, scaled[j]) for j, b in enumerate(spec.bases)]
    return torch.stack(rows)


class _DenseInterpTranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tfrac, V, m):
        ctx.save_for_backward(tfrac)
        return cuda_interp.interp_transpose(tfrac, V, m)

    @staticmethod
    def backward(ctx, U_bar):
        (tfrac,) = ctx.saved_tensors
        return None, cuda_interp.interp_apply_sum(tfrac, U_bar.contiguous()), None


class _DenseInterpApplySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tfrac, G):
        ctx.save_for_backward(tfrac)
        ctx.m = G.shape[2]
        return cuda_interp.interp_apply_sum(tfrac, G)

    @staticmethod
    def backward(ctx, out_bar):
        (tfrac,) = ctx.saved_tensors
        return None, cuda_interp.interp_transpose(tfrac, out_bar, ctx.m)


def dense_interp_transpose(state: SKIState, V):
    """W^T V: (n, t) -> (J, t, m)."""
    return _DenseInterpTranspose.apply(state.tfrac, V, state.m)


def dense_interp_apply_sum(state: SKIState, G):
    """sum_j W_j G_j: (J, t, m) -> (n, t)."""
    return _DenseInterpApplySum.apply(state.tfrac, G)
