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
raises. Each takes any t in one launch, V in its (n, t) layout. Both take
m <= M_MAX: K3's table of one component in shared memory (33 KB at
m = 1024, t > 4) and K2's per-lane accumulator copies (132 KB a warp at
m = 1024) are sized for it. Past it the wrappers raise.
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernels, per entry point
launches = {"interp_transpose": 0, "interp_apply_sum": 0}

M_MAX = 1024  # csrc/interp.cu M_MAX: the grid cells both kernels take
_DENSE_BLOCK = 4096  # plain version: points per dense W block

# K2's chunk of points a warp (csrc/interp.cu): sized for the H100, 132
# SMs of 228 KB of shared memory (1 KB of it reserved a block), so that
# its warps fill the card _K2_WAVES times, a warp takes at least
# _K2_MIN_ROUNDS rounds where that leaves no SM idle, and the partial sums
# stay within _K2_SCRATCH_FLOATS
K2_TILE = 32  # csrc/interp.cu K2_TILE: columns a warp carries at most
_K2_WARPS = 2  # csrc/interp.cu K2_WARPS: warps a block
_K2_SMS, _K2_SMEM_SM, _K2_SMEM_BLOCK = 132, 233472, 232448
_K2_WAVES, _K2_MIN_ROUNDS = 2, 256
_K2_SCRATCH_FLOATS = 64 << 20  # 256 MB


def _k2_warps_per_sm(m: int) -> int:
    """K2's warps an SM holds (csrc/interp.cu `k2_launch`): blocks of
    _K2_WARPS warps (one where two do not fit), each warp with its 32
    lanes' padded copies (the slots kernel's stage, about 1.5 KB of static
    memory, is left out)."""
    per_warp = 4 * 32 * (m + 8)
    w = _K2_WARPS if _K2_WARPS * per_warp <= _K2_SMEM_BLOCK else 1
    return min(64, w * (_K2_SMEM_SM // (w * per_warp + 1024)))


def transpose_chunk(J: int, n: int, t: int, m: int) -> int:
    """Points a K2 warp takes, a multiple of 32. Tiles: one column each at
    t <= 2, all t at t <= 32, else 32 columns and the rest (csrc/interp.cu
    `rpagp_interp_transpose`); t = 2 takes t = 1's chunks, so that each of
    its columns adds in a one-column call's order."""
    if t == 2:
        return transpose_chunk(J, n, 1, m)
    blocks_per_chunk = J * -(-t // K2_TILE)
    slots = K2_TILE // min(t, K2_TILE)  # points a round, P
    resident = _K2_SMS * _k2_warps_per_sm(m)
    nchunk = min(max(1, _K2_WAVES * resident // blocks_per_chunk),
                 max(-(-resident // blocks_per_chunk),
                     n // (_K2_MIN_ROUNDS * slots)),
                 max(1, _K2_SCRATCH_FLOATS // (J * t * m)),
                 -(-n // 32))
    return 32 * -(-n // (32 * nchunk))


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
    V = V.contiguous()  # (n, t) row-major: the kernel's layout
    chunk = transpose_chunk(J, n, t, m)
    partial = torch.empty(-(-n // chunk) * J * t * m, dtype=V.dtype,
                          device=V.device)
    U = torch.empty(J, t, m, dtype=V.dtype, device=V.device)
    err = _build.lib().rpagp_interp_transpose(
        tfrac.data_ptr(), V.data_ptr(), partial.data_ptr(), U.data_ptr(), J,
        n, t, m, chunk, _build.stream_ptr(V.device))
    _build.check(err, "interp_transpose kernel")
    launches["interp_transpose"] += 1
    return U


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
