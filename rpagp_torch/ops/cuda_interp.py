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
raises. Each takes any t in one call, V in its (n, t) layout. Both take
m <= M_MAX: K3's table of one component in shared memory (33 KB at
m = 1024, t > 4), K2's per-lane accumulator copies (132 KB a warp at
m = 1024) and its per-block run sums (the runs route takes at most
runs_width(m) columns, 9 at m = 1024) are sized for it. Past it the
wrappers raise.

K2 takes one of three routes by shape (`transpose_tiles`,
csrc/interp.cu): "own" (one-column tiles, t <= 2), "runs" (a per-tile
sort by cell with run sums in registers, all 3 <= t <= 16 columns a block,
where its blocks fill the card) and "slots" (tiles of up to 32 columns,
otherwise); `launches` counts each call and, under
"interp_transpose.<route>", each route it launched. The K2 span records
the route after (J, n, t, m) ("plain" on the CPU).
"""

from __future__ import annotations

import functools

import torch

from ..utils.profiling import span
from . import _build

# K2's routes (csrc/interp.cu), in the order a call launches them
ROUTES = ("own", "runs", "slots")

# launches of the CUDA kernels, per entry point and K2 route
launches = {"interp_transpose": 0, "interp_apply_sum": 0,
            **{f"interp_transpose.{r}": 0 for r in ROUTES}}

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


# K2's runs route (csrc/interp.cu RUNS_*): blocks of RUNS_NT threads, one a
# (component, chunk), on tiles of RUNS_T points, all t <= RUNS_C_MAX
# columns, taken where such blocks fill the card (RUNS_MIN_BLOCKS); its
# chunks fill the card _RUNS_WAVES times where the points allow
RUNS_NT, RUNS_T, RUNS_C_MAX = 128, 1024, 16
RUNS_MIN_BLOCKS = 2 * _K2_SMS
_RUNS_WAVES = 3
_RUNS_BLOCKS_MAX = 4  # blocks an SM where shared memory allows more


def _runs_smem(m: int, C: int) -> int:
    """csrc/interp.cu `runs_smem`: a runs block's dynamic shared memory."""
    nb, odd = m + 5, C | 1
    entries = RUNS_T + RUNS_T // 32
    return (4 * (nb * 4 * C + RUNS_NT * odd * 4 + RUNS_T * odd + entries
                 + RUNS_NT // 32 * nb) + 2 * entries)


@functools.lru_cache(maxsize=None)
def runs_width(m: int) -> int:
    """csrc/interp.cu `runs_width`: the columns a runs block carries, the
    most up to RUNS_C_MAX whose block fits in a block's shared memory with
    1 KB to spare."""
    C = RUNS_C_MAX
    while C > 3 and _runs_smem(m, C) + 1024 > _K2_SMEM_BLOCK:
        C -= 1
    return C


def runs_route(J: int, n: int, t: int, m: int) -> bool:
    """csrc/interp.cu `runs_route`: t >= 3 columns that fit one runs block,
    and blocks, one a (component, tile of points), that fill the card."""
    return 3 <= t <= runs_width(m) and J * -(-n // RUNS_T) >= RUNS_MIN_BLOCKS


def transpose_tiles(J: int, n: int, t: int, m: int) -> list:
    """[(route, first column, width)] of K2's column tiles
    (csrc/interp.cu `rpagp_interp_transpose`): one-column tiles at t <= 2;
    one runs tile of all t columns where `runs_route` takes the call; else
    slots tiles of 32 columns and one of the rest, a rest of one column on
    the one-column route."""
    if t <= 2:
        return [("own", k, 1) for k in range(t)]
    if runs_route(J, n, t, m):
        return [("runs", 0, t)]
    full, rest = divmod(t, K2_TILE)
    tiles = [("slots", k * K2_TILE, K2_TILE) for k in range(full)]
    if rest:
        tiles.append(("own" if rest == 1 else "slots", full * K2_TILE, rest))
    return tiles


@functools.lru_cache(maxsize=None)
def transpose_route(J: int, n: int, t: int, m: int) -> str:
    """The K2 routes a call launches, joined by "+"."""
    used = {r for r, _, _ in transpose_tiles(J, n, t, m)}
    return "+".join(r for r in ROUTES if r in used)


def _k2_warps_per_sm(m: int) -> int:
    """K2's warps an SM holds (csrc/interp.cu `k2_launch`): blocks of
    _K2_WARPS warps (one where two do not fit), each warp with its 32
    lanes' padded copies (the slots kernel's stage, about 1.5 KB of static
    memory, is left out)."""
    per_warp = 4 * 32 * (m + 8)
    w = _K2_WARPS if _K2_WARPS * per_warp <= _K2_SMEM_BLOCK else 1
    return min(64, w * (_K2_SMEM_SM // (w * per_warp + 1024)))


def transpose_chunk(J: int, n: int, t: int, m: int) -> int:
    """Points a K2 warp or block takes. Runs route: a multiple of RUNS_T,
    so that the chunks' blocks fill the card _RUNS_WAVES times; slots and
    own: a multiple of 32 (tiles: `transpose_tiles`); t = 2 takes t = 1's
    chunks, so that each of its columns adds in a one-column call's
    order. The partial sums stay within _K2_SCRATCH_FLOATS."""
    if t == 2:
        return transpose_chunk(J, n, 1, m)
    if runs_route(J, n, t, m):
        per_sm = min(_RUNS_BLOCKS_MAX,
                     _K2_SMEM_SM // (_runs_smem(m, t) + 1024))
        ntile = -(-n // RUNS_T)
        nchunk = min(ntile, max(1, _RUNS_WAVES * _K2_SMS * per_sm // J),
                     max(1, _K2_SCRATCH_FLOATS // (J * t * m)))
        return RUNS_T * -(-ntile // nchunk)
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
    for route in transpose_route(J, n, t, m).split("+"):
        launches[f"interp_transpose.{route}"] += 1
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
    """U[j] = W_j^T V: tfrac (J, n), V (n, t) -> (J, t, m). Its span
    records (J, n, t, m, route): `transpose_route`'s on the card, "plain"
    on the CPU."""
    route = (transpose_route(*tfrac.shape, V.shape[1], m)
             if tfrac.device.type == "cuda" else "plain")
    with span("rpagp.op.interp_transpose",
              (*tfrac.shape, V.shape[1], m, route)):
        if tfrac.device.type == "cpu":
            return interp_transpose_plain(tfrac, V, m)
        if tfrac.device.type == "cuda":
            return interp_transpose_cuda(tfrac, V, m)
    raise TypeError(f"interp_transpose: no kernel for device {tfrac.device}")


def interp_apply_sum(tfrac, G):
    """sum_j W_j G_j: tfrac (J, n), G (J, t, m) -> (n, t). Its span
    records (J, n, t, m)."""
    with span("rpagp.op.interp_apply_sum", (*tfrac.shape, *G.shape[1:])):
        if tfrac.device.type == "cpu":
            return interp_apply_sum_plain(tfrac, G)
        if tfrac.device.type == "cuda":
            return interp_apply_sum_cuda(tfrac, G)
    raise TypeError(f"interp_apply_sum: no kernel for device {tfrac.device}")
