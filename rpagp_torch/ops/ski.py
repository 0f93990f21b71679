"""SKI grid interpolation, dense plan (port of rpagp/ops/ski.py).

Per component j, K_j ~= W_j T_j W_j^T with W_j the cubic-convolution
interpolation of the projected coordinates onto a regular m-point grid
and T_j the (Toeplitz) base kernel on the grid. The geometry depends
only on the data and the fixed projections, so it is built once per
dataset; only the Toeplitz columns change with the hyperparameters.

The two interpolation directions run on kernels K2 / K3
(ops/cuda_interp.py) and are each other's backward, as the JAX
package's custom_vjp pair. T_j V is a 2m circulant embedding and batched
real FFTs (torch.fft), differentiated by autograd. `ski_mvm` chains the
three: K2, the Toeplitz product, K3.

Product components (degree * sub_dim > 1) take `build_ski_factors`: one
geometry row per 1-D factor, which ops/ski_product.py combines. The
sorted interp plan (KernelSpec.interp = "sorted") is ROADMAP queue 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.transforms import softplus
from . import cuda_interp
from .cuda_interp import cubic_kernel as _cubic_kernel
from .kernels import KernelSpec, _component_scales, _get_proj, _k1d


class SKIState(NamedTuple):
    """Per-dataset interpolation geometry (dense plan) for J components."""

    grid_lo: torch.Tensor  # (J,) left grid endpoint per component
    h: torch.Tensor  # (J,) grid spacing per component
    cells: torch.Tensor  # (m,) f32 cell indices 0..m-1
    tfrac: torch.Tensor  # (J, n) fractional grid coordinate, contiguous

    @property
    def m(self) -> int:
        return self.cells.shape[0]


def _tap_geometry(tfrac, m: int):
    """(i0, w4) from fractional coordinates: the base cell (J, n) int32
    and the 4 cubic tap weights (4, J, n), renormalized to sum to 1;
    points far outside the grid (all four weights 0) get zero taps."""
    i0 = torch.clamp(torch.floor(tfrac), 1, m - 3)
    w4 = torch.stack([_cubic_kernel(tfrac - (i0 + (k - 1)))
                      for k in range(4)])
    wsum = torch.sum(w4, dim=0, keepdim=True)
    safe = torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    w4 = torch.where(wsum > 1e-8, w4 / safe, torch.zeros_like(w4))
    return i0.to(torch.int32), w4


def project(spec: KernelSpec, kparams, kbuffers, x):
    """Raw projected coordinates z = (x P)^T, one row per projection column
    ((J, n) for degree-1, (Jf, n) for a product kernel); not lengthscale-
    scaled, so the grid is hyperparameter-free."""
    return (x @ _get_proj(kparams, kbuffers)).T


def _check_learn_proj(spec: KernelSpec):
    if spec.learn_proj:
        raise ValueError("learn_proj=True is incompatible with ski=True: "
                         "the SKI interpolation geometry is fixed at "
                         "prepare time, so projection gradients are zero")


def build_ski(spec: KernelSpec, kparams, kbuffers, x, grid_size: int,
              z_bounds=None):
    """SKI geometry for inputs x (once per dataset). z_bounds: optional
    (lo (J,), hi (J,)) for a grid covering more than x."""
    if (not spec.is_projection or any(d != 1 for d in spec.degrees)
            or spec.sub_dim != 1):
        raise ValueError("SKI supports degree-1, sub_dim-1 projection "
                         "kernels only")
    _check_learn_proj(spec)
    if spec.interp != "dense":
        raise NotImplementedError("the sorted interp plan is ROADMAP queue 1")
    z = project(spec, kparams, kbuffers, x)
    return _geometry_from_z(z, int(grid_size), z_bounds)


def build_ski_factors(spec: KernelSpec, kparams, kbuffers, x, grid_size: int,
                      z_bounds=None):
    """Per-factor SKI geometry of a product (degree * sub_dim > 1) kernel:
    each 1-D projection column is a row of its own, so the state has
    Jf = sum(degrees) * sub_dim rows (dense plan only). z_bounds: optional
    (lo (Jf,), hi (Jf,))."""
    if not spec.is_projection:
        raise ValueError("build_ski_factors needs a projection kernel")
    _check_learn_proj(spec)
    z = project(spec, kparams, kbuffers, x)  # (Jf, n)
    return _geometry_from_z(z, int(grid_size), z_bounds)


def union_bounds(spec: KernelSpec, kparams, kbuffers, x1, x2):
    """(lo, hi) over the projections of x1 and x2, one per geometry row
    ((J,), or (Jf,) for a product kernel): one grid for both, as a cross
    MVM and a posterior need."""
    z1 = project(spec, kparams, kbuffers, x1)
    z2 = project(spec, kparams, kbuffers, x2)
    return (torch.minimum(torch.amin(z1, dim=1), torch.amin(z2, dim=1)),
            torch.maximum(torch.amax(z1, dim=1), torch.amax(z2, dim=1)))


# a cached predictor's grid: the train range extended by this x its span
# on each side (the JAX package's grid_margin default)
GRID_MARGIN = 0.5


def margin_bounds(spec: KernelSpec, kparams, kbuffers, x):
    """(lo, hi), one per geometry row ((J,), or (Jf,) for a product
    kernel): x's projection range extended by GRID_MARGIN x its span on
    each side (a cached predictor's grid)."""
    z = project(spec, kparams, kbuffers, x)
    lo, hi = torch.amin(z, dim=1), torch.amax(z, dim=1)
    span = hi - lo
    return lo - GRID_MARGIN * span, hi + GRID_MARGIN * span


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


def sym_toeplitz_matmul(col, U):
    """(J, m) Toeplitz first columns x (J, t, m) -> (J, t, m) through a 2m
    circulant embedding and batched real FFTs over the last axis.

    Only the real part of the embedding's spectrum is kept: it is real in
    exact arithmetic, so the grid operator stays exactly symmetric. Its
    eigenvalues are not clamped: the minimal embedding of an RBF Toeplitz
    has legitimate negative eigenvalues, and clamping them biased the
    operator (the JAX package's docstring, rpagp/ops/ski.py)."""
    J, m = col.shape
    circ = torch.cat([col, col.new_zeros(J, 1), col.flip(-1)[:, :m - 1]],
                     dim=1)  # (J, 2m)
    C = torch.fft.rfft(circ, dim=-1).real  # (J, m + 1)
    F = torch.fft.rfft(torch.cat([U, torch.zeros_like(U)], dim=-1), dim=-1)
    out = torch.fft.irfft(C[:, None, :] * F, n=2 * m, dim=-1)
    return out[..., :m]


def ski_mvm(spec: KernelSpec, kparams, state: SKIState, V,
            state_rhs: SKIState | None = None):
    """K_ski V = sum_j scale_j W_j T_j W'_j^T V, (n, t): K2 on the RHS
    points, the Toeplitz product, the component scales folded into grid
    space, K3 on `state`'s points. state_rhs: the RHS points' geometry
    for a cross MVM (K(test, train) v: state = test, state_rhs = train);
    both must lie on one grid (build_ski with common z_bounds)."""
    if state_rhs is None:
        state_rhs = state
    col = toeplitz_columns(spec, kparams, state)  # (J, m)
    scales = _component_scales(spec, kparams)  # (J,)
    U = dense_interp_transpose(state_rhs, V)  # (J, t, m)
    TU = sym_toeplitz_matmul(col, U)
    return dense_interp_apply_sum(state, scales[:, None, None] * TU)


def ski_gram_diag(spec: KernelSpec, kparams, state: SKIState):
    """diag(K_ski), (n,): per point and component w^T T_local w. The grid
    is regular, so T[a, b] = col[|a - b|] for the 4 taps wherever the
    point lies: one (4, 4) block per component."""
    col = toeplitz_columns(spec, kparams, state)  # (J, m)
    taps = torch.arange(4, device=col.device)
    Tlocal = col[:, torch.abs(taps[:, None] - taps[None, :])]  # (J, 4, 4)
    _, w4 = _tap_geometry(state.tfrac, state.m)
    quad = torch.einsum("jab,ajn,bjn->jn", Tlocal, w4, w4)
    return _component_scales(spec, kparams) @ quad
