"""Blocked Cholesky as GEMMs (port of rpagp/ops/block_chol.py).

Right-looking blocked elimination, unrolled over the p/b block steps
with shrinking shapes:

    for k = 0 .. nb-1, on the trailing matrix T (r x r, r = p - k*b):
      L_kk, L_kk^{-1}, ok_k = chol_linv(T[:b, :b])   # kernel K1
      P  = T[b:, :b] @ L_kk^{-T}                      # GEMM
      T <- T[b:, b:] - P @ P^T   (block lower triangle) # GEMMs

Gradients are plain autograd through the unrolled graph; the diagonal
leaf carries K1's closed-form VJP. A must be SYMMETRIC (both triangles
valid); callers in grid_solve symmetrize first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_chol import chol_linv

# default block size: 10 steps at the flagship p = 5120
_BLOCK = 512
# leaf size (in blocks) of the triangular trailing update
_TRI_LEAF = 2


def _syrk_tril(T22, P, block, min_blocks):
    """T22 - P @ P^T with only the block LOWER triangle computed (blocks
    strictly above the split points are zero)."""
    r = T22.shape[0]
    nb = r // block
    if nb <= min_blocks:
        return T22 - P @ P.T
    h = (nb // 2) * block
    top = _syrk_tril(T22[:h, :h], P[:h], block, min_blocks)
    bl = T22[h:, :h] - P[h:] @ P[:h].T
    bot = _syrk_tril(T22[h:, h:], P[h:], block, min_blocks)
    z = torch.zeros(h, r - h, dtype=T22.dtype, device=T22.device)
    return torch.cat([torch.cat([top, z], dim=1),
                      torch.cat([bl, bot], dim=1)], dim=0)


def _diag_factor(blk, sanitize):
    """(L_kk, Linv_kk, ok) for one diagonal block through K1. K1's primals
    are always finite; sanitize=False re-imposes the NaN failure signal."""
    L, Linv, okf = chol_linv(blk.contiguous())
    ok = okf > 0.5
    if not sanitize:
        L = torch.where(ok, L, torch.full_like(L, float("nan")))
    return L, Linv, ok


def _elimination(A, block, sanitize):
    """The blocked elimination over a block-multiple-sized A: (L, ok)."""
    nb = A.shape[0] // block
    cols = []
    T = A
    ok = torch.ones((), dtype=torch.bool, device=A.device)
    for k in range(nb):
        blk = T[:block, :block]
        if k > 0:
            # pins the "both triangles readable" contract of the leaf:
            # _syrk_tril only guarantees the block lower triangle
            blk = torch.tril(blk) + torch.tril(blk, -1).T
        Lkk, Linv, okk = _diag_factor(blk, sanitize)
        ok = ok & okk
        if k < nb - 1:
            P = T[block:, :block] @ Linv.T
            colk = torch.cat([Lkk, P], dim=0)
            T = _syrk_tril(T[block:, block:], P, block, _TRI_LEAF)
        else:
            colk = Lkk
        # zeros above the diagonal block keep L exactly lower-triangular
        cols.append(F.pad(colk, (0, 0, k * block, 0)))
    return torch.cat(cols, dim=1), ok


def _pad_to_blocks(A, block):
    """blockdiag(A, I) of a block-multiple size: chol(blockdiag(A, I)) =
    blockdiag(chol(A), I), so slicing back is exact."""
    p = A.shape[-1]
    pad = -(-p // block) * block - p
    if pad == 0:
        return A
    out = F.pad(A, (0, pad, 0, pad))
    idx = torch.arange(p, p + pad, device=A.device)
    return out.index_put((idx, idx), torch.ones(pad, dtype=A.dtype,
                                                device=A.device))


def blocked_cholesky(A, block: int = _BLOCK):
    """Lower Cholesky factor of symmetric PD A (p, p). NaN-propagates on
    indefinite input; differentiable only on inputs that factor (use
    blocked_cholesky_safe for conditionally used factors)."""
    if A.ndim != 2:
        raise ValueError("blocked_cholesky expects a single (p, p) matrix")
    p = A.shape[-1]
    if p <= block:
        L, info = torch.linalg.cholesky_ex(A)
        return torch.where(info == 0, L, torch.full_like(L, float("nan")))
    L, _ = _elimination(_pad_to_blocks(A, block), block, sanitize=False)
    return L[:p, :p]


def blocked_cholesky_safe(A, block: int = _BLOCK):
    """(L, ok): like blocked_cholesky, but with FINITE primals always.
    ok=True -> L is the factor; ok=False -> A (or a Schur complement) is
    indefinite and L is finite garbage whose VJP stays finite. ok is a
    0-d bool tensor on A's device (no host read here)."""
    if A.ndim != 2:
        raise ValueError("blocked_cholesky_safe expects a (p, p) matrix")
    p = A.shape[-1]
    if p <= block:
        info = torch.linalg.cholesky_ex(A.detach()).info
        ok = info == 0
        eye = torch.eye(p, dtype=A.dtype, device=A.device)
        return torch.linalg.cholesky_ex(torch.where(ok, A, eye)).L, ok
    L, ok = _elimination(_pad_to_blocks(A, block), block, sanitize=True)
    return L[:p, :p], ok


def blocked_solve_triangular(L, B, block: int = _BLOCK):
    """X = L^{-1} B for lower-triangular L (p, p) and B (p, c), by block
    forward substitution (the O(p^2 c) work as GEMMs)."""
    p = L.shape[0]
    if B.ndim != 2 or L.shape != (p, p) or B.shape[0] != p:
        raise ValueError("blocked_solve_triangular expects L (p,p), B (p,c)")
    if p <= block:
        return torch.linalg.solve_triangular(L, B, upper=False)
    b = block
    nb = -(-p // b)
    pp = nb * b
    if pp != p:
        L = _pad_to_blocks(L, block)
        B = F.pad(B, (0, 0, 0, pp - p))
    eye_b = torch.eye(b, dtype=L.dtype, device=L.device)
    diags = torch.stack([L[k * b:(k + 1) * b, k * b:(k + 1) * b]
                         for k in range(nb)])
    Linvs = torch.linalg.solve_triangular(diags, eye_b.expand(nb, b, b),
                                          upper=False)
    xs = []
    for k in range(nb):
        rhs = B[k * b:(k + 1) * b]
        if k > 0:
            rhs = rhs - L[k * b:(k + 1) * b, :k * b] @ torch.cat(xs, dim=0)
        xs.append(Linvs[k] @ rhs)
    X = torch.cat(xs, dim=0)
    return X[:p] if pp != p else X
