"""Product-grid SKI for degree * sub_dim > 1 components (port of
rpagp/ops/ski_product.py; see its module docstring for the derivation).

A product component k_j(x, x') = prod_f k1d(z_jf, z'_jf) over F = degree *
sub_dim one-dimensional factors is SKI on the product grid of M = m^F
points: its interpolation rows are the row-wise Khatri-Rao product of the
F cubic rows, and its grid kernel is the Kronecker product of the F
factor Toeplitz matrices, so chol(T_j + ...) is the Kronecker product of
the F (m, m) factor Choleskys. Everything lowers to the exact grid solver
(ops/grid_solve.py) with per-component grid size M.

The state is an ops.ski.SKIState whose rows are the Jf = J * F factors
(ski.build_ski_factors). The interpolation is plain torch, as the JAX
package computes it in XLA: a loop over n-blocks that builds each block's
(J, bn, M) Khatri-Rao slab and contracts it with one matmul, the two
directions each other's backward (torch.autograd.Function). The only
kernel under this path is K1, which the grid solver's ladder runs on the
(Jf, m, m) factor Toeplitz blocks and its leaves on the p x p factor.
"""

from __future__ import annotations

import torch

from ..utils.transforms import softplus
from .cuda_interp import cubic_kernel as _cubic_kernel
from .kernels import KernelSpec, _k1d

# per-block transient budget of the interpolation loops: the (J, bn, M)
# Khatri-Rao slab, in elements
_PROD_BLOCK_ELEMS = 1 << 24


def factors_per_component(spec: KernelSpec) -> int:
    """F = degree * sub_dim, validated uniform."""
    if not spec.is_projection or not spec.degrees:
        raise ValueError("product SKI needs a projection kernel")
    d = spec.degrees[0]
    if any(dd != d for dd in spec.degrees):
        raise ValueError("product SKI supports uniform degrees only")
    return int(d) * int(spec.sub_dim)


def is_product(spec: KernelSpec) -> bool:
    """Does this SKI spec need the product-grid path?"""
    return bool(spec.is_projection and spec.ski and spec.degrees
                and (any(d != 1 for d in spec.degrees) or spec.sub_dim != 1))


def grid_rank(spec: KernelSpec) -> int:
    """p = J * m^F, the grid solver's Woodbury rank for this spec."""
    if not is_product(spec):
        return spec.J * spec.grid_size
    return spec.J * spec.grid_size ** factors_per_component(spec)


def factor_lengthscales(spec: KernelSpec, kparams):
    """(Jf,) per-factor lengthscales: one per sub-kernel (sum(degrees) of
    them), shared by its sub_dim 1-D factors."""
    ls = softplus(kparams["raw_lengthscale"])
    return torch.repeat_interleave(ls, spec.sub_dim)


def toeplitz_columns_factors(spec: KernelSpec, kparams, state):
    """First columns of the factor Toeplitz matrices, (Jf, m). A
    component's F factors share its base: factor row j*F + f takes
    bases[j]."""
    ls = factor_lengthscales(spec, kparams)
    scaled = state.cells[None, :] * state.h[:, None] / ls[:, None]  # (Jf, m)
    if all(b == spec.bases[0] for b in spec.bases):
        return _k1d(spec.bases[0], scaled)
    F = factors_per_component(spec)
    fbases = [b for b in spec.bases for _ in range(F)]
    return torch.stack([_k1d(b, scaled[i]) for i, b in enumerate(fbases)])


def toeplitz_blocks_factors(spec: KernelSpec, kparams, state):
    """(Jf, m, m) full factor Toeplitz blocks."""
    col = toeplitz_columns_factors(spec, kparams, state)
    m = state.m
    ar = torch.arange(m, device=col.device)
    return col[:, torch.abs(ar[:, None] - ar[None, :])]


def kron_fold(mats):
    """Batched Kronecker product over the factor axis: (J, F, m, m) ->
    (J, m^F, m^F), factor 0 the slowest index. The Kronecker product of
    lower-triangular factors is lower-triangular, so this maps the factor
    Choleskys to the product grid's."""
    J, F = mats.shape[0], mats.shape[1]
    out = mats[:, 0]
    for f in range(1, F):
        a, b = out.shape[-2], mats.shape[-2]
        out = torch.einsum("jab,jcd->jacbd", out, mats[:, f]).reshape(
            J, a * b, a * b)
    return out


def _product_block(spec: KernelSpec, tf, cells):
    """Khatri-Rao interpolation rows of one n-block: tf (Jf, bn) fractional
    coordinates -> (J, bn, M)."""
    F = factors_per_component(spec)
    J, m = spec.J, cells.shape[0]
    W = _cubic_kernel(tf[:, :, None] - cells)  # (Jf, bn, m)
    bn = W.shape[1]
    Wj = W.reshape(J, F, bn, m)
    out = Wj[:, 0]
    for f in range(1, F):
        a = out.shape[-1]
        out = (out[:, :, :, None] * Wj[:, f][:, :, None, :]).reshape(
            J, bn, a * m)
    return out


def _prod_block_size(spec: KernelSpec, n: int) -> int:
    M = spec.grid_size ** factors_per_component(spec)
    bn = max(8, _PROD_BLOCK_ELEMS // max(1, spec.J * M))
    return min(bn, max(8, n))


def _interp_transpose_impl(spec: KernelSpec, state, V):
    """W^T V on the product grid: V (n, t) -> (J, t, M)."""
    n, t = V.shape
    M = state.m ** factors_per_component(spec)
    bn = _prod_block_size(spec, n)
    U = V.new_zeros(spec.J, t, M)
    for s in range(0, n, bn):
        W = _product_block(spec, state.tfrac[:, s:s + bn], state.cells)
        U += torch.matmul(V[s:s + bn].T, W)  # (J, t, M)
    return U


def _interp_apply_sum_impl(spec: KernelSpec, state, G):
    """sum_j W_j G_j on the product grid: G (J, t, M) -> (n, t)."""
    n = state.tfrac.shape[1]
    bn = _prod_block_size(spec, n)
    outs = []
    for s in range(0, n, bn):
        W = _product_block(spec, state.tfrac[:, s:s + bn], state.cells)
        outs.append(torch.sum(torch.matmul(W, G.transpose(1, 2)), dim=0))
    return torch.cat(outs)


class _InterpTranspose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, state, V):
        ctx.spec, ctx.state = spec, state
        return _interp_transpose_impl(spec, state, V)

    @staticmethod
    def backward(ctx, U_bar):
        return None, None, _interp_apply_sum_impl(ctx.spec, ctx.state, U_bar)


class _InterpApplySum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, state, G):
        ctx.spec, ctx.state = spec, state
        return _interp_apply_sum_impl(spec, state, G)

    @staticmethod
    def backward(ctx, out_bar):
        return None, None, _interp_transpose_impl(ctx.spec, ctx.state,
                                                  out_bar)


def interp_transpose(spec: KernelSpec, state, V):
    """W^T V: (n, t) -> (J, t, M); backward is interp_apply_sum."""
    return _InterpTranspose.apply(spec, state, V)


def interp_apply_sum(spec: KernelSpec, state, G):
    """sum_j W_j G_j: (J, t, M) -> (n, t); backward is interp_transpose."""
    return _InterpApplySum.apply(spec, state, G)


def build_interp_gram(spec: KernelSpec, state):
    """S = U^T U of the stacked product interpolation rows, (J, M, J, M);
    hyperparameter-free, built once per dataset."""
    n = state.tfrac.shape[1]
    M = state.m ** factors_per_component(spec)
    p = spec.J * M
    bn = _prod_block_size(spec, n)
    S = state.tfrac.new_zeros(p, p)
    for s in range(0, n, bn):
        W = _product_block(spec, state.tfrac[:, s:s + bn], state.cells)
        Wf = W.transpose(1, 2).reshape(p, -1)  # (p, bn)
        S += Wf @ Wf.T
    return S.reshape(spec.J, M, spec.J, M)


def test_interp_rows(spec: KernelSpec, state, chunk_slice):
    """Dense product W* rows for a contiguous test chunk: (c, p)."""
    W = _product_block(spec, state.tfrac[:, chunk_slice], state.cells)
    J, c, M = W.shape
    return W.transpose(0, 1).reshape(c, J * M)
