"""K2 / K3: the two directions of SKI grid interpolation.

Port of rpagp/ops/pallas_interp.py (`_transpose_kernel` /
`transpose_call`, `_apply_kernel` / `apply_sum_call`) as CUDA kernels
(csrc/interp.cu), in the JAX package's public layouts:

  interp_transpose(tfrac, V, m)  tfrac (J, n), V (n, t) -> U (J, t, m),
                                 U[j] = W_j^T V
  interp_apply_sum(tfrac, G)     G (J, t, m) -> (n, t), sum_j W_j G_j

W_j[i, c] is Keys' cubic convolution (a = -0.5) of tfrac[j, i] - c: four
taps per point at floor(tfrac) + {-1, 0, 1, 2}, kept when the cell lies
on the grid; tfrac = -100 (padding) contributes zero. The two directions
are exact adjoints of each other.

A CPU tensor takes the plain version (the blocked dense plan of
ops/ski.py: the (J, block, m) interpolation matrix built from tfrac,
contracted with einsum); a CUDA tensor launches the kernel; anything else
raises. K2's wrapper chunks t into launches of at most 8 columns (K2
runs passes of up to 8 inside a launch); K3 takes any t in one launch.
Both take m <= M_MAX: K3's table of one component in shared memory (33
KB at m = 1024, t > 4) and K2's per-lane accumulator copies are sized for
it. Past it the wrappers raise.
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernels, per entry point
launches = {"interp_transpose": 0, "interp_apply_sum": 0}

T_CHUNK = 8  # K2: columns per launch (csrc/interp.cu T_MAX)
M_MAX = 1024  # csrc/interp.cu M_MAX: the grid cells both kernels take
_POINTS_PER_BLOCK = 8192  # K2: points per warp (one partial sum)
_DENSE_BLOCK = 4096  # plain version: points per dense W block


def cubic_kernel(s):
    """Keys' cubic-convolution kernel (a = -0.5), support |s| < 2."""
    a = torch.abs(s)
    inner = 1.5 * a**3 - 2.5 * a**2 + 1.0
    outer = -0.5 * a**3 + 2.5 * a**2 - 4.0 * a + 2.0
    return torch.where(a <= 1.0, inner,
                       torch.where(a < 2.0, outer, torch.zeros_like(a)))


def interp_transpose_plain(tfrac, V, m: int):
    J, n = tfrac.shape
    cells = torch.arange(m, dtype=tfrac.dtype, device=tfrac.device)
    U = torch.zeros(J, V.shape[1], m, dtype=V.dtype, device=V.device)
    for s in range(0, n, _DENSE_BLOCK):
        W = cubic_kernel(tfrac[:, s:s + _DENSE_BLOCK, None] - cells)
        U += torch.einsum("bt,jbm->jtm", V[s:s + _DENSE_BLOCK], W)
    return U


def interp_apply_sum_plain(tfrac, G):
    J, n = tfrac.shape
    m = G.shape[2]
    cells = torch.arange(m, dtype=tfrac.dtype, device=tfrac.device)
    out = torch.empty(n, G.shape[1], dtype=G.dtype, device=G.device)
    for s in range(0, n, _DENSE_BLOCK):
        W = cubic_kernel(tfrac[:, s:s + _DENSE_BLOCK, None] - cells)
        out[s:s + _DENSE_BLOCK] = torch.einsum("jtm,jbm->bt", G, W)
    return out


def _check_cuda(name, tfrac, other):
    for x in (tfrac, other):
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise TypeError(f"{name} needs float32 CUDA tensors, got "
                            f"{x.dtype} on {x.device}")
    if other.device != tfrac.device:
        raise ValueError(f"{name}: tensors on {tfrac.device} and {other.device}")
    if tfrac.ndim != 2 or not tfrac.is_contiguous():
        raise ValueError(f"{name} expects a contiguous (J, n) tfrac, got "
                         f"{tuple(tfrac.shape)}")


def interp_transpose_cuda(tfrac, V, m: int):
    _check_cuda("interp_transpose", tfrac, V)
    J, n = tfrac.shape
    if V.ndim != 2 or V.shape[0] != n:
        raise ValueError(f"interp_transpose expects V (n={n}, t), got "
                         f"{tuple(V.shape)}")
    if not 0 < m <= M_MAX:
        raise ValueError(f"interp_transpose supports 0 < m <= {M_MAX}, got {m}")
    t = V.shape[1]
    VT = V.t().contiguous()  # (t, n): the kernel's layout
    nchunk = -(-n // _POINTS_PER_BLOCK)
    partial = torch.empty(nchunk * J * min(t, T_CHUNK) * m,
                          dtype=V.dtype, device=V.device)
    lib = _build.lib()
    stream = _build.stream_ptr(V.device)
    outs = []
    for s in range(0, t, T_CHUNK):
        tc = min(T_CHUNK, t - s)
        U = torch.empty(J, tc, m, dtype=V.dtype, device=V.device)
        err = lib.rpagp_interp_transpose(
            tfrac.data_ptr(), VT[s:s + tc].data_ptr(), partial.data_ptr(),
            U.data_ptr(), J, n, tc, m, _POINTS_PER_BLOCK, stream)
        _build.check(err, "interp_transpose kernel")
        launches["interp_transpose"] += 1
        outs.append(U)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def interp_apply_sum_cuda(tfrac, G):
    _check_cuda("interp_apply_sum", tfrac, G)
    J, n = tfrac.shape
    if G.ndim != 3 or G.shape[0] != J:
        raise ValueError(f"interp_apply_sum expects G (J={J}, t, m), got "
                         f"{tuple(G.shape)}")
    t, m = G.shape[1], G.shape[2]
    if not 0 < m <= M_MAX:
        raise ValueError(f"interp_apply_sum supports 0 < m <= {M_MAX}, got {m}")
    G = G.contiguous()
    out = torch.empty(n, t, dtype=G.dtype, device=G.device)
    err = _build.lib().rpagp_interp_apply_sum(
        tfrac.data_ptr(), G.data_ptr(), out.data_ptr(), J, n, t, m,
        _build.stream_ptr(G.device))
    _build.check(err, "interp_apply_sum kernel")
    launches["interp_apply_sum"] += 1
    return out


def interp_transpose(tfrac, V, m: int):
    """U[j] = W_j^T V: tfrac (J, n), V (n, t) -> (J, t, m)."""
    if tfrac.device.type == "cpu":
        return interp_transpose_plain(tfrac, V, m)
    if tfrac.device.type == "cuda":
        return interp_transpose_cuda(tfrac, V, m)
    raise TypeError(f"interp_transpose: no kernel for device {tfrac.device}")


def interp_apply_sum(tfrac, G):
    """sum_j W_j G_j: tfrac (J, n), G (J, t, m) -> (n, t)."""
    if tfrac.device.type == "cpu":
        return interp_apply_sum_plain(tfrac, G)
    if tfrac.device.type == "cuda":
        return interp_apply_sum_cuda(tfrac, G)
    raise TypeError(f"interp_apply_sum: no kernel for device {tfrac.device}")
