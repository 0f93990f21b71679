"""SKI grid interpolation, dense and sorted plans (port of
rpagp/ops/ski.py).

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

The sorted plan (KernelSpec.interp = "sorted", or build_ski(plan=
"sorted")) keeps the taps themselves: W^T V sorts the points by base cell
once per dataset, then takes a per-tap cumsum over them and differences
it at the cells' boundaries, with no scatter; W G is one gather of the 4
tap-shifted copies of G. It is plain torch on the CPU and on the card, as
the JAX package's is XLA; its two directions (interp_transpose,
interp_apply) are each other's backward too. The grid solver reads only
tfrac, so it runs K2 / K3 on a state of either plan.

Product components (degree * sub_dim > 1) take `build_ski_factors`: one
geometry row per 1-D factor (dense plan), which ops/ski_product.py
combines.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import annotate
from ..utils.transforms import softplus
from . import cuda_interp
from .cuda_interp import cubic_kernel as _cubic_kernel
from .kernels import KernelSpec, _component_scales, _get_proj, _k1d

# transient-memory budget of the sorted plan's component groups: a group
# of g components holds (g, t, n) products (rpagp/ops/ski.py:72)
_GROUP_BUDGET_ELEMS = 1 << 28


class SKIState(NamedTuple):
    """Per-dataset interpolation geometry for J components. The dense plan
    fills the first four fields; the sorted plan's five are None there."""

    grid_lo: torch.Tensor  # (J,) left grid endpoint per component
    h: torch.Tensor  # (J,) grid spacing per component
    cells: torch.Tensor  # (m,) f32 cell indices 0..m-1
    tfrac: torch.Tensor  # (J, n) fractional grid coordinate, contiguous
    i0: torch.Tensor | None = None  # (J, n) int32 base cell (taps i0-1..i0+2)
    w4: torch.Tensor | None = None  # (4, J, n) tap weights
    order: torch.Tensor | None = None  # (J, n) int32 points sorted by i0
    w4_sorted: torch.Tensor | None = None  # (4, J, n) w4 in that order
    bounds: torch.Tensor | None = None  # (J, m) int32 #sorted points i0 <= c

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
              z_bounds=None, plan: str | None = None):
    """SKI geometry for inputs x (once per dataset). z_bounds: optional
    (lo (J,), hi (J,)) for a grid covering more than x. plan: "dense" or
    "sorted" (None: spec.interp)."""
    if (not spec.is_projection or any(d != 1 for d in spec.degrees)
            or spec.sub_dim != 1):
        raise ValueError("SKI supports degree-1, sub_dim-1 projection "
                         "kernels only")
    _check_learn_proj(spec)
    plan = spec.interp if plan is None else plan
    if plan not in ("dense", "sorted"):
        raise ValueError(f"unknown SKI interp plan {plan!r}")
    z = project(spec, kparams, kbuffers, x)
    return _geometry_from_z(z, int(grid_size), z_bounds, plan)


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


def _geometry_from_z(z, m: int, z_bounds, plan: str = "dense"):
    """z (rows, n) -> SKIState, one grid per row; the sorted plan adds the
    taps and the points' order by base cell."""
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
    if plan == "dense":
        return SKIState(grid_lo=grid_lo, h=h, cells=cells, tfrac=t)
    i0, w4 = _tap_geometry(t, m)
    # stable, as jnp.argsort: ties keep the points' order, so the cumsum
    # adds in the JAX package's order
    order = torch.argsort(i0, dim=1, stable=True)
    i0_sorted = torch.gather(i0, 1, order)
    w4_sorted = torch.gather(w4, 2, order.expand(4, -1, -1))
    cell_ids = torch.arange(m, dtype=i0.dtype, device=i0.device)
    # bounds[j, c] = #points of component j with i0 <= c
    bounds = torch.searchsorted(
        i0_sorted, cell_ids.expand(i0.shape[0], m).contiguous(), right=True)
    return SKIState(grid_lo=grid_lo, h=h, cells=cells, tfrac=t, i0=i0, w4=w4,
                    order=order.to(torch.int32), w4_sorted=w4_sorted,
                    bounds=bounds.to(torch.int32))


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


def _component_group_size(J: int, n: int, t: int) -> int:
    return max(1, min(J, _GROUP_BUDGET_ELEMS // max(1, n * 4 * t)))


def _by_groups(fn, t: int, taps, *rows):
    """fn(*rows, taps) over groups of components (the rows sliced on axis
    0, the (4, J, n) taps on axis 1), concatenated: a group's (g, t, n)
    transients stay within _GROUP_BUDGET_ELEMS."""
    _, J, n = taps.shape
    g = _component_group_size(J, n, t)
    if g >= J:
        return fn(*rows, taps)
    return torch.cat([fn(*(r[s:s + g] for r in rows), taps[:, s:s + g])
                      for s in range(0, J, g)])


def _spread_sorted(state: SKIState, Vs):
    """Scatter-free spread: Vs (J, t, n), each component's points in sorted
    order -> grid values (J, t, m). Cell c gathers, for tap k, the sorted
    points with i0 == c + 1 - k: a per-tap cumsum over the points,
    differenced at bounds[c - k + 1] and bounds[c - k]."""
    t = Vs.shape[1]
    m = state.bounds.shape[1]
    cells = torch.arange(m, device=Vs.device)

    def spread_group(Vg, bg, wg):
        # Vg (g, t, n), bg (g, m), wg (4, g, n)
        g = Vg.shape[0]
        zero = Vg.new_zeros(g, t, 1)
        out = Vg.new_zeros(g, t, m)
        for tap in range(4):
            csum = torch.cat([zero, torch.cumsum(wg[tap][:, None, :] * Vg,
                                                 dim=-1)], dim=-1)
            shift = 1 - tap  # i0 = c + (1 - tap)
            src = torch.clamp(cells + shift, -1, m - 1)
            hi = torch.where(cells + shift < 0, 0,
                             bg[:, torch.clamp(src, min=0)])
            lo = torch.where(cells + shift - 1 < 0, 0,
                             bg[:, torch.clamp(src - 1, min=0)])
            out = out + (torch.gather(csum, 2, hi.long()[:, None, :]
                                      .expand(g, t, m))
                         - torch.gather(csum, 2, lo.long()[:, None, :]
                                        .expand(g, t, m)))
        return out

    return _by_groups(spread_group, t, state.w4_sorted, Vs, state.bounds)


def _sorted_rows(state: SKIState, rows):
    """rows (J, t, n) -> each component's row in its sorted point order."""
    J, t, n = rows.shape
    return torch.gather(rows, 2,
                        state.order.long()[:, None, :].expand(J, t, n))


def _interp_transpose_impl(state: SKIState, V):
    """W^T V: V (n, t) -> grid values (J, t, m); one gather brings V into
    each component's sorted order."""
    J = state.order.shape[0]
    return _spread_sorted(state, _sorted_rows(
        state, V.T[None].expand(J, -1, -1)))


def _interp_transpose_per_component(state: SKIState, rows):
    """W_j^T rows_j, a right-hand side per component: (J, t, n) ->
    (J, t, m)."""
    return _spread_sorted(state, _sorted_rows(state, rows))


def _interp_apply_impl(state: SKIState, G):
    """W G: grid values (J, t, m) -> point values (J, t, n). At t >= 4 one
    gather of each point's base cell from the 4 tap-shifted copies of G
    stacked as (g, 4t, m) (rolled: a border point's outer taps wrap, with
    weight ~0); at t < 4 a clipped gather per tap."""
    t, m = G.shape[1:]
    n = state.i0.shape[1]

    def apply_group(Gg, i0g, wg):
        # Gg (g, t, m), i0g (g, n), wg (4, g, n)
        g = Gg.shape[0]
        out = 0.0
        if t < 4:
            for k in range(4):
                idx = torch.clamp(i0g + (k - 1), 0, m - 1).long()
                gk = torch.gather(Gg, 2, idx[:, None, :].expand(g, t, n))
                out = out + wg[k][:, None, :] * gk
            return out
        G4 = torch.cat([torch.roll(Gg, 1 - k, dims=-1) for k in range(4)],
                       dim=1)  # (g, 4t, m)
        rows = torch.gather(G4, 2, i0g.long()[:, None, :]
                            .expand(g, 4 * t, n))  # (g, 4t, n)
        for k in range(4):
            out = out + wg[k][:, None, :] * rows[:, k * t:(k + 1) * t, :]
        return out

    return _by_groups(apply_group, t, state.w4, G, state.i0)


class _InterpTranspose(torch.autograd.Function):
    """W^T V whose backward is the sorted apply, summed over components."""

    @staticmethod
    def forward(ctx, state, V):
        ctx.state = state
        return _interp_transpose_impl(state, V)

    @staticmethod
    def backward(ctx, G_bar):
        return None, _interp_apply_impl(ctx.state, G_bar).sum(0).T


class _InterpApply(torch.autograd.Function):
    """W G whose backward is the sorted spread, per component."""

    @staticmethod
    def forward(ctx, state, G):
        ctx.state = state
        return _interp_apply_impl(state, G)

    @staticmethod
    def backward(ctx, rows_bar):
        return None, _interp_transpose_per_component(ctx.state, rows_bar)


def interp_transpose(state: SKIState, V):
    """W^T V, sorted plan: (n, t) -> (J, t, m)."""
    return _InterpTranspose.apply(state, V)


def interp_apply(state: SKIState, G):
    """W G, sorted plan: (J, t, m) -> (J, t, n)."""
    return _InterpApply.apply(state, G)


@annotate("rpagp.op.toeplitz")
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
    """K_ski V = sum_j scale_j W_j T_j W'_j^T V, (n, t). Dense plan: K2 on
    the RHS points, the Toeplitz product, the component scales folded into
    grid space, K3 on `state`'s points. A sorted state takes its plan's
    direction instead, and the sorted apply is per component, contracted
    with the scales afterwards. state_rhs: the RHS points' geometry
    for a cross MVM (K(test, train) v: state = test, state_rhs = train);
    both must lie on one grid (build_ski with common z_bounds)."""
    if state_rhs is None:
        state_rhs = state
    col = toeplitz_columns(spec, kparams, state)  # (J, m)
    scales = _component_scales(spec, kparams)  # (J,)
    if state_rhs.order is None:
        U = dense_interp_transpose(state_rhs, V)  # (J, t, m)
    else:
        U = interp_transpose(state_rhs, V)
    TU = sym_toeplitz_matmul(col, U)
    if state.order is None:
        return dense_interp_apply_sum(state, scales[:, None, None] * TU)
    return torch.tensordot(scales, interp_apply(state, TU), dims=1).T


def ski_gram_diag(spec: KernelSpec, kparams, state: SKIState):
    """diag(K_ski), (n,): per point and component w^T T_local w. The grid
    is regular, so T[a, b] = col[|a - b|] for the 4 taps wherever the
    point lies: one (4, 4) block per component."""
    col = toeplitz_columns(spec, kparams, state)  # (J, m)
    taps = torch.arange(4, device=col.device)
    Tlocal = col[:, torch.abs(taps[:, None] - taps[None, :])]  # (J, 4, 4)
    w4 = state.w4
    if w4 is None:  # a dense state: the taps from tfrac
        _, w4 = _tap_geometry(state.tfrac, state.m)
    quad = torch.einsum("jab,ajn,bjn->jn", Tlocal, w4, w4)
    return _component_scales(spec, kparams) @ quad
