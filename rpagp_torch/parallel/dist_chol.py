"""Distributed blocked Cholesky: the p x p grid factor row-banded over the
data axis (port of rpagp/parallel/dist_chol.py; see its docstring for the
layout and the traffic).

Every rank owns a contiguous (p/ndev, p) row band of the working matrix.
Per block step k the owner's b x b diagonal block is shared by a masked
psum, every rank factors it redundantly with K1 (block_chol._diag_factor,
the B = 1 entry point), computes its band's panel rows as one GEMM
against L_kk^{-1}, and one (p, b) psum assembles the replicated column
block; each rank then downdates only its own band. The per-row arithmetic
is the single-card blocked factor's, so the value matches
block_chol.blocked_cholesky at the same block size.

Gradients: plain autograd through the graph, with comm.psum's
all-reducing backward and comm.grad_pmean on the replicated input, as the
reference's custom_vjp `_grad_pmean`; callers keep the pmean-over-data
gradient contract of sharding.distributed_grid_mll. The reference states
~2.5e-4 relative noise in upstream gradients when the banded factor is
engaged (its distributed_blocked_cholesky docstring).

The fallback ladder branches on flags every rank agrees on: each is an
all-reduce (MIN) over the data group before the host reads it.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..ops.block_chol import _diag_factor
from . import comm


def _pad_replicated(C, p_pad):
    """Identity-tail pad of the replicated (p, p) matrix (exact:
    chol(blockdiag(C, I)) = blockdiag(chol(C), I))."""
    p = C.shape[-1]
    pad = p_pad - p
    if pad == 0:
        return C
    out = F.pad(C, (0, pad, 0, pad))
    idx = torch.arange(p, p_pad, device=C.device)
    return out.index_put((idx, idx), torch.ones(pad, dtype=C.dtype,
                                                device=C.device))


def distributed_blocked_cholesky(C, mesh, block: int = 128,
                                 sanitize: bool = False):
    """(L, ok): the replicated lower Cholesky factor of the REPLICATED
    symmetric (p, p) C, its O(p^3) work row-banded over the mesh's data
    axis. sanitize=False NaN-propagates on indefinite input (the ladder's
    probes test isfinite(L)); sanitize=True keeps the primals finite. ok
    is a 0-d bool tensor, the same on every rank (K1's flags on the
    replicated diagonal blocks)."""
    if C.ndim != 2:
        raise ValueError("expected a replicated (p, p) matrix")
    group = mesh.data_group
    p = C.shape[-1]
    C = comm.grad_pmean(C, group)  # a uniform exact cotangent
    ndev, d = mesh.data, mesh.data_rank
    step = ndev * block
    p_pad = -(-p // step) * step
    nb = p_pad // block
    p_loc = p_pad // ndev
    bpd = p_loc // block  # blocks per rank

    Cp = _pad_replicated(C, p_pad)
    T = Cp[d * p_loc:(d + 1) * p_loc]  # my row band (p_loc, p_pad)
    grow = d * p_loc + torch.arange(p_loc, device=C.device)

    cols = []
    ok = torch.ones((), dtype=torch.bool, device=C.device)
    for k in range(nb):
        kb = k * block
        owner = k // bpd  # the one rank whose band holds block k
        off = kb - owner * p_loc
        mine = float(d == owner)
        # share the diagonal block: a masked b^2 psum
        Dblk = comm.psum(mine * T[off:off + block, kb:kb + block], group)
        Lkk, Linv, okk = _diag_factor(Dblk, sanitize)
        ok = ok & okk
        # my band's panel rows (only rows strictly below the block live)
        live = (grow >= kb + block).to(C.dtype)[:, None]
        P = live * (T[:, kb:kb + block] @ Linv.T)
        # the replicated column block: band placement plus the diagonal
        aug = P
        if mine:
            aug = P + F.pad(Lkk, (0, 0, off, p_loc - off - block))
        place = F.pad(aug, (0, 0, d * p_loc, p_pad - (d + 1) * p_loc))
        Lcol = comm.psum(place, group)  # (p_pad, block)
        cols.append(Lcol)
        if k < nb - 1:
            # downdate my band's live columns with one GEMM
            upd = P @ Lcol[kb + block:].T
            T = torch.cat([T[:, :kb + block], T[:, kb + block:] - upd], dim=1)
    L = torch.tril(torch.cat(cols, dim=1))
    return L[:p, :p], ok


def distributed_chol_with_fallback_eps(C, noise, mesh, block: int = 128):
    """(L, eps_chosen): minimal-jitter chol(C + c * noise I) with the banded
    factor, c from the single card's levels (grid_solve._C_LEVELS). The
    fast path is one sanitize=True factor; on failure the levels are
    probed on detached values and the chosen level refactored
    (sanitize=True), as the reference's while_loop ladder. Each branch
    reads a flag reduced (MIN) over the data group, so every rank takes
    the same branch."""
    from ..ops.grid_solve import _C_LEVELS

    p = C.shape[-1]
    eye = torch.eye(p, dtype=C.dtype, device=C.device)
    group = mesh.data_group
    L0, ok0 = distributed_blocked_cholesky(C, mesh, block=block,
                                           sanitize=True)
    if comm.all_true(ok0, group):
        return L0, torch.zeros((), dtype=C.dtype, device=C.device)
    Cs, ns = C.detach(), noise.detach()
    chosen = ns * _C_LEVELS[-1]
    with torch.no_grad():
        for level in _C_LEVELS[1:]:
            L, _ = distributed_blocked_cholesky(Cs + ns * level * eye, mesh,
                                                block=block)
            if comm.all_true(torch.isfinite(L).all(), group):
                chosen = ns * level
                break
    Lf, _ = distributed_blocked_cholesky(C + chosen * eye, mesh, block=block,
                                         sanitize=True)
    return Lf, chosen


def use_distributed_factor(p: int, ndev: int) -> bool:
    """The banding policy (the reference's): only on a real data axis
    (ndev > 1) and where the replicated O(p^3) factor dominates the step,
    p >= 8192. RPAGP_DIST_CHOL=1 forces it on (ndev > 1), =0 off."""
    env = os.environ.get("RPAGP_DIST_CHOL", "auto")
    if env == "0":
        return False
    if env == "1":
        return ndev > 1
    return ndev > 1 and p >= 8192
