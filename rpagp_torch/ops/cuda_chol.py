"""K1: Cholesky factor AND inverse of symmetric blocks, (L, L^{-1}, ok).

Port of rpagp/ops/pallas_chol.py. The TPU package has three Pallas
kernels (`_leaf_kernel`, `_panel_kernel` behind `chol_linv`, and
`_fused_panel_kernel` behind `chol_linv_batched_fused`). Here both entry
points launch one CUDA kernel, csrc/chol_linv_coop.cu: one cooperative
launch of G blocks over the card's SMs, with grid barriers between the
phases of each panel, for B >= 1 matrices; each launch has its own
counter, and the `rpagp.op.chol_linv` span records each call's (B, b)
while a profiler records (on the CPU too):

  chol_linv(A)          (b, b)    -> L, Linv (b, b), ok ()   the 512 leaf
  chol_linv_batched(T)  (J, b, b) -> L, Linv (J, b, b), ok (J,)  the ladder

The first port, csrc/chol_linv.cu (one thread block per matrix), is no
longer on the path: `chol_linv_cuda(A, "chol_linv_oneblock")` runs it,
uncounted, as the oracle of the cooperative kernel. Each element goes
through the same operations in the same order in both, so they agree bit
for bit on every matrix.

Contract (both): A symmetric, f32. L = chol(A) exactly lower-triangular,
Linv = L^{-1}, ok = 1.0 / 0.0. On a non-positive pivot ok = 0 for that
matrix alone, the pivot is taken as 1 and its column decoupled from the
rest (0 below the diagonal), so L and Linv are the finite factor and
inverse of the matrix with that row and column taken out: every output
stays FINITE (the blocked_cholesky_safe contract: a zero cotangent times
a finite primal stays zero). A matrix with ok = 1 never takes that branch.

Gradient: the closed-form GEMM-only VJP of pallas_chol._chol_linv_bwd /
_fused_bwd, as plain torch.matmul. It returns a SYMMETRIC cotangent, so
callers reach it through symmetric inputs (block_chol symmetrizes its
diagonal blocks, grid_solve symmetrizes C).

A CPU tensor takes the plain version (`chol_linv_plain`: cholesky_ex, a
unit factor where info reports failure, then a triangular solve against
I, as block_chol._diag_factor's XLA branch); a CUDA tensor launches the
kernel; anything else raises, as does a refused launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from . import _build

# launches of the cooperative kernel, per entry point
launches = {"chol_linv": 0, "chol_linv_batched": 0}
ONE_BLOCK = "chol_linv_oneblock"  # the oracle kernel's name, not counted

_ALIGN = 32  # the kernels' panel width; other sizes are padded with I

_coop_grids = {}  # (device index, B, b) -> (G, C) of the cooperative launch


def chol_linv_plain(A):
    """Plain torch version of K1 on a (B, b, b) batch."""
    b = A.shape[-1]
    L, info = torch.linalg.cholesky_ex(A)
    ok = info == 0
    eye = torch.eye(b, dtype=A.dtype, device=A.device).expand_as(A)
    L = torch.where(ok[:, None, None], L, eye)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, Linv, ok.to(A.dtype)


def coop_grid(B: int, b: int, device) -> tuple[int, int]:
    """(G, C) of the cooperative kernel's launch on B matrices of size b
    (a multiple of 32) on a CUDA device: G blocks, those that fit the card
    at once capped at C + the most items one of its phases deals out, of
    which C carry the matrices' diagonal chains."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), B, b)
    if key not in _coop_grids:
        G, C = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            err = _build.lib().rpagp_chol_linv_coop_grid(
                B, b, ctypes.addressof(G), ctypes.addressof(C))
        _build.check(err, "chol_linv_coop occupancy query")
        _coop_grids[key] = (G.value, C.value)
    return _coop_grids[key]


def chol_linv_cuda(A, name: str):
    """Launch K1 on a (B, b, b) f32 contiguous CUDA batch: the cooperative
    kernel for the entry points' names "chol_linv" (B = 1) and
    "chol_linv_batched", the one-block kernel for ONE_BLOCK. A size b
    that is not a multiple of 32 is embedded as blockdiag(A, I), whose
    factor and inverse are blockdiag(., I), and sliced back."""
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[1] == 0 \
            or A.shape[0] == 0:
        raise ValueError(f"chol_linv_cuda expects (B, b, b), got {tuple(A.shape)}")
    if name not in (*launches, ONE_BLOCK):
        raise ValueError(f"chol_linv_cuda: unknown entry point {name!r}")
    if name == "chol_linv" and A.shape[0] != 1:
        raise ValueError(f"chol_linv factors one matrix, got a batch of "
                         f"{A.shape[0]}")
    if A.device.type != "cuda" or A.dtype != torch.float32:
        raise TypeError(f"chol_linv_cuda needs a float32 CUDA tensor, got "
                        f"{A.dtype} on {A.device}")
    if not A.is_contiguous():
        raise ValueError("chol_linv_cuda expects a contiguous tensor")
    B, b = A.shape[0], A.shape[-1]
    bp = -(-b // _ALIGN) * _ALIGN
    if bp != b:
        Ap = torch.zeros(B, bp, bp, dtype=A.dtype, device=A.device)
        Ap[:, :b, :b] = A
        Ap[:, b:, b:] = torch.eye(bp - b, dtype=A.dtype, device=A.device)
        A = Ap
    L = torch.empty_like(A)
    Linv = torch.empty_like(A)
    ok = torch.empty(B, dtype=A.dtype, device=A.device)
    lib = _build.lib()
    args = (A.data_ptr(), L.data_ptr(), Linv.data_ptr(), ok.data_ptr())
    stream = _build.stream_ptr(A.device)
    if name == ONE_BLOCK:
        err = lib.rpagp_chol_linv(*args, B, bp, stream)
    else:
        # each panel's failed pivots, one bit a column, from the diagonal
        # chain to the blocks that substitute the panel's rows
        fail = torch.empty(B * (bp // _ALIGN), dtype=torch.int32,
                           device=A.device)
        err = lib.rpagp_chol_linv_coop(*args, fail.data_ptr(), B, bp,
                                       *coop_grid(B, bp, A.device), stream)
    _build.check(err, f"{name} kernel")
    if name in launches:
        launches[name] += 1
    if bp != b:
        L, Linv = L[:, :b, :b].contiguous(), Linv[:, :b, :b].contiguous()
    return L, Linv, ok


def _dispatch(A, name):
    """K1 on the card, its plain version on the CPU; the span records the
    call's (B, b)."""
    with span("rpagp.op.chol_linv", tuple(A.shape[:2])):
        if A.device.type == "cpu":
            return chol_linv_plain(A)
        if A.device.type == "cuda":
            return chol_linv_cuda(A, name)
    raise TypeError(f"chol_linv: no kernel for device {A.device}")


class _CholLinv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, name):
        L, Linv, ok = _dispatch(A, name)
        ctx.save_for_backward(L, Linv)
        ctx.mark_non_differentiable(ok)
        return L, Linv, ok

    @staticmethod
    def backward(ctx, Lbar, Linvbar, _okbar):
        L, Linv = ctx.saved_tensors
        LinvT = Linv.mT
        # d(Linv) = -Linv dL Linv  =>  Lbar -= (Linv^T Linvbar Linv^T)|_tril
        corr = LinvT @ Linvbar @ LinvT
        Lb = torch.tril(Lbar - corr)
        M = L.mT @ Lb
        P = torch.tril(M, -1) + 0.5 * torch.diag_embed(
            torch.diagonal(M, dim1=-2, dim2=-1))
        S = P + P.mT
        return 0.5 * (LinvT @ S @ Linv), None


def chol_linv(A):
    """(L, Linv, ok) of one symmetric (b, b) block; ok a 0-d tensor."""
    L, Linv, ok = _CholLinv.apply(A.unsqueeze(0), "chol_linv")
    return L[0], Linv[0], ok[0]


def chol_linv_batched(T):
    """(L, Linv, ok) of a (J, b, b) batch of symmetric blocks; ok (J,)."""
    if T.ndim != 3:
        raise ValueError(f"chol_linv_batched expects (J, b, b), got "
                         f"{tuple(T.shape)}")
    return _CholLinv.apply(T, "chol_linv_batched")
