"""K1: Cholesky factor AND inverse of symmetric blocks, (L, L^{-1}, ok).

Port of rpagp/ops/pallas_chol.py. The TPU package has three Pallas
kernels (`_leaf_kernel`, `_panel_kernel` behind `chol_linv`, and
`_fused_panel_kernel` behind `chol_linv_batched_fused`); the batched one
existed only because Pallas grid programs run one after another on one
TPU core. Here one CUDA kernel (csrc/chol_linv.cu, one thread block per
matrix) serves both entry points:

  chol_linv(A)          (b, b)    -> L, Linv (b, b), ok ()   the 512 leaf
  chol_linv_batched(T)  (J, b, b) -> L, Linv (J, b, b), ok (J,)  the ladder

Contract (both): A symmetric, f32. L = chol(A) exactly lower-triangular,
Linv = L^{-1}, ok = 1.0 / 0.0. On a non-positive pivot every output stays
FINITE and ok = 0 (the blocked_cholesky_safe contract: a zero cotangent
times a finite primal stays zero, which is what makes the factor-first
ladders sound).

Gradient: the closed-form GEMM-only VJP of pallas_chol._chol_linv_bwd /
_fused_bwd, as plain torch.matmul. It returns a SYMMETRIC cotangent, so
callers reach it through symmetric inputs (block_chol symmetrizes its
diagonal blocks, grid_solve symmetrizes C).

A CPU tensor takes the plain version (`chol_linv_plain`: cholesky_ex, a
unit factor where info reports failure, then a triangular solve against
I, as block_chol._diag_factor's XLA branch); a CUDA tensor launches the
kernel; anything else raises.
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernel, per entry point
launches = {"chol_linv": 0, "chol_linv_batched": 0}

_ALIGN = 32  # the kernel's panel width; other sizes are padded with I


def chol_linv_plain(A):
    """Plain torch version of K1 on a (B, b, b) batch."""
    b = A.shape[-1]
    L, info = torch.linalg.cholesky_ex(A)
    ok = info == 0
    eye = torch.eye(b, dtype=A.dtype, device=A.device).expand_as(A)
    L = torch.where(ok[:, None, None], L, eye)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, Linv, ok.to(A.dtype)


def chol_linv_cuda(A, name: str):
    """Launch K1 on a (B, b, b) f32 contiguous CUDA batch. A size b that
    is not a multiple of 32 is embedded as blockdiag(A, I), whose factor
    and inverse are blockdiag(., I), and sliced back."""
    if A.device.type != "cuda" or A.dtype != torch.float32:
        raise TypeError(f"chol_linv_cuda needs a float32 CUDA tensor, got "
                        f"{A.dtype} on {A.device}")
    if A.ndim != 3 or A.shape[1] != A.shape[2] or A.shape[1] == 0:
        raise ValueError(f"chol_linv_cuda expects (B, b, b), got {tuple(A.shape)}")
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
    err = lib.rpagp_chol_linv(A.data_ptr(), L.data_ptr(), Linv.data_ptr(),
                              ok.data_ptr(), B, bp,
                              _build.stream_ptr(A.device))
    _build.check(err, "chol_linv kernel")
    launches[name] += 1
    if bp != b:
        L, Linv = L[:, :b, :b].contiguous(), Linv[:, :b, :b].contiguous()
    return L, Linv, ok


def _dispatch(A, name):
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
