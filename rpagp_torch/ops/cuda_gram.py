"""K4 / K5: the fused projected additive Gram x V product and its backward.

Port of rpagp/ops/pallas_gram.py (`_gram_mvm_kernel` / `_gram_mvm_fwd_call`,
`_gram_mvm_bwd_kernel` / `_gram_mvm_bwd_call`, the VJP of `_make_pgm`) as
CUDA kernels (csrc/gram_mvm.cu), in the JAX package's layouts:

  gram_mvm(z1, z2, w, V, base)         out = K V, (n, t)
  gram_mvm_bwd(z1, z2, w, V, G, base)  (dz1 (n, J), dw (J,)) for cotangent G

with K[i, l] = sum_j w_j k1d(z1[i, j] - z2[l, j]); z1 (n, J) and z2 (m, J)
are lengthscale-scaled projected coordinates, w (J,) the component
weights, V (m, t). The Gram is never stored.

`projected_gram_mvm` is the differentiable product (a
torch.autograd.Function with the VJP of `_make_pgm`: dV is K4 with the
sides swapped, dz1 and dw are K5, dz2 is K5 with both the coordinate
and the value sides swapped). A CPU tensor takes the plain versions
(blocked dense PyTorch with the same closed-form math); a CUDA tensor
launches the kernels; anything else raises.

The TPU kernel's `prec` and `bf16_exp` options are matrix-unit modes of
the TPU; here everything is f32. K4 and K5 take their exponentials on
the exp unit (one 2^x of prescaled coordinates, csrc/gram_mvm.cu). Each
launch is planned per shape (`gram_mvm_plan`, `gram_mvm_bwd_plan`): a
persistent grid of G blocks over (row tile, z2 chunk) items, whose
partial sums second kernels add in chunk order.

K6 / K7 (csrc/gram_mvm.cu, after K5): the dense projected Gram itself and
its backward, for the exact GP's K(x1, x2), in the projection's layout:

  dense_gram_fwd(u1, u2, w, base)        K (n, m)
  dense_gram_bwd(u1, u2, w, G, base)     (du1 (J, n), du2 (J, m), dw (J,))

with K[i, k] = sum_j w_j k1d(u1[j, i] - u2[j, k]); u1 (J, n), u2 (J, m)
the lengthscale-scaled projected coordinates. `dense_gram` is the
differentiable Gram (a torch.autograd.Function that saves u1, u2 and w
and nothing of size J n m). A CPU tensor takes the plain twins (the same
closed-form math in row blocks), a CUDA tensor the kernels; the
`rpagp.op.dense_gram` span records each call's (J, n, m, direction).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .kernels import _k1d as k1d_tile
from ..utils.profiling import span

# launches of the CUDA kernels, per entry point
launches = {"gram_mvm": 0, "gram_mvm_bwd": 0, "dense_gram": 0,
            "dense_gram_bwd": 0}

BASES = ("rbf", "matern12", "matern32", "matern52")
J_MAX = 64  # csrc/gram_mvm.cu J_MAX: components per launch
TILE = 64  # csrc/gram_mvm.cu FT: K4's rows and z2 columns per Gram tile
BWD_ROWS, BWD_COLS = 64, 128  # csrc/gram_mvm.cu BR, BL: K5's Gram tile
DENSE_TILE = 64  # csrc/gram_mvm.cu FT, BT: K6's and K7's tiles of K and G
DENSE_BWD_J_MAX = 32  # csrc/gram_mvm.cu BJ_MAX: K7's components per launch
MAX_CHUNKS = 32  # K4: the most z2 chunks (partial-sum slots) of one call
_PLAIN_ELEMS = 1 << 25  # plain versions: (rows, m, J) elements per block

_fwd_grids = {}  # (device index, J, t, base) -> (G, slabs) of K4's grid
_bwd_grids = {}  # (device index, J, t pass, base) -> G of K5's grid

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def k1d_grad_tile(base: str, d):
    """d k1d(d) / d d (0 at d = 0 for the Matern bases, via sign(0) = 0)."""
    if base == "rbf":
        return -d * torch.exp(-0.5 * d * d)
    a = torch.abs(d)
    sgn = torch.sign(d)
    if base == "matern12":
        return -sgn * torch.exp(-a)
    if base == "matern32":
        s = _SQRT3 * a
        return -sgn * _SQRT3 * s * torch.exp(-s)
    if base == "matern52":
        s = _SQRT5 * a
        return -sgn * _SQRT5 * (s + s * s) / 3.0 * torch.exp(-s)
    raise ValueError(f"unknown 1-D base kernel {base!r}")


def _plain_rows(J: int, m: int) -> int:
    """Rows a block of the plain versions: (rows, m, J) within
    _PLAIN_ELEMS."""
    return max(1, _PLAIN_ELEMS // max(1, J * m))


def gram_mvm_plain(z1, z2, w, V, base: str = "rbf"):
    """out = K V by row blocks of the dense (rows, m, J) difference tensor."""
    out = torch.empty(z1.shape[0], V.shape[1], dtype=V.dtype, device=V.device)
    rows = _plain_rows(z1.shape[1], z2.shape[0])
    for s in range(0, z1.shape[0], rows):
        d = z1[s:s + rows, None, :] - z2[None, :, :]  # (rows, m, J)
        K = torch.sum(k1d_tile(base, d) * w, dim=-1)  # (rows, m)
        out[s:s + rows] = K @ V
    return out


def gram_mvm_bwd_plain(z1, z2, w, V, G, base: str = "rbf"):
    """(dz1, dw) of out = K V for cotangent G (n, t), by row blocks."""
    dz = torch.empty_like(z1)
    dw = torch.zeros_like(w)
    rows = _plain_rows(z1.shape[1], z2.shape[0])
    for s in range(0, z1.shape[0], rows):
        Gm = (G[s:s + rows] @ V.T)[:, :, None]  # (rows, m, 1)
        d = z1[s:s + rows, None, :] - z2[None, :, :]
        dz[s:s + rows] = w * torch.sum(Gm * k1d_grad_tile(base, d), dim=1)
        dw += torch.sum(Gm * k1d_tile(base, d), dim=(0, 1))
    return dz, dw


def _check_tensors(name, base, *xs):
    """A known base; float32, contiguous CUDA tensors on one device."""
    if base not in BASES:
        raise ValueError(f"{name}: unknown base {base!r}")
    for x in xs:
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise TypeError(f"{name} needs float32 CUDA tensors, got "
                            f"{x.dtype} on {x.device}")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: tensors on {xs[0].device} and "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors, got strides "
                             f"{x.stride()} for shape {tuple(x.shape)}")


def _check_cuda(name, base, z1, z2, w, *mats):
    _check_tensors(name, base, z1, z2, w, *mats)
    J = z1.shape[1] if z1.ndim == 2 else -1
    if (z1.ndim != 2 or z2.ndim != 2 or z2.shape[1] != J or w.shape != (J,)
            or J < 1):
        raise ValueError(f"{name} expects z1 (n, J), z2 (m, J), w (J,) with "
                         f"J >= 1, got {tuple(z1.shape)}, "
                         f"{tuple(z2.shape)}, {tuple(w.shape)}")


def _component_chunks(z1, z2, w):
    """The components in groups of at most J_MAX, the most one launch
    takes (K5's shared-memory slabs hold a sum per row and component): K
    is the sum of the groups' Grams, and dz, dw are per component. One
    group up to J_MAX."""
    J = z1.shape[1]
    if J <= J_MAX:
        yield 0, J, z1, z2, w
        return
    for j0 in range(0, J, J_MAX):
        j1 = min(J, j0 + J_MAX)
        yield (j0, j1, z1[:, j0:j1].contiguous(), z2[:, j0:j1].contiguous(),
               w[j0:j1])


def z2_chunks(units: int, tiles: int, G: int) -> int:
    """K4's number of z2 chunks S: the fewest (at most `tiles`, the z2
    tiles of 64, and MAX_CHUNKS) for which the units * S work items (row
    tile and column slab, z2 chunk) fill at least 95% of the ceil(items /
    G) rounds of the persistent grid's G blocks; failing that, the fullest
    rounds."""
    best, best_fill = 1, 0.0
    for S in range(1, max(1, min(tiles, MAX_CHUNKS)) + 1):
        items = units * S
        fill = items / (G * -(-items // G))
        if fill >= 0.95:
            return S
        if fill > best_fill:
            best, best_fill = S, fill
    return best


def gram_mvm_plan(n: int, m: int, J: int, t: int, base: str, device):
    """(G, S) of K4 on a CUDA device: its persistent grid (the blocks the
    card holds at once) and its number of z2 chunks."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), min(J, J_MAX), t, base)
    if key not in _fwd_grids:
        G, slabs = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            err = _build.lib().rpagp_gram_mvm_grid(
                key[1], t, BASES.index(base), ctypes.addressof(G),
                ctypes.addressof(slabs))
        _build.check(err, "gram_mvm occupancy query")
        _fwd_grids[key] = (G.value, slabs.value)
    G, slabs = _fwd_grids[key]
    return G, z2_chunks(-(-n // TILE) * slabs, -(-m // TILE), G)


def gram_mvm_cuda(z1, z2, w, V, base: str = "rbf"):
    _check_cuda("gram_mvm", base, z1, z2, w, V)
    n = z1.shape[0]
    m = z2.shape[0]
    if V.ndim != 2 or V.shape[0] != m:
        raise ValueError(f"gram_mvm expects V (m={m}, t), got {tuple(V.shape)}")
    t = V.shape[1]
    out = torch.empty(n, t, dtype=V.dtype, device=V.device)
    if n == 0 or t == 0:
        return out
    if m == 0:
        return out.zero_()
    G, S = gram_mvm_plan(n, m, z1.shape[1], t, base, V.device)
    scratch = (torch.empty(S, n, t, dtype=V.dtype, device=V.device)
               if S > 1 else out)
    # the coordinates, transposed and prescaled by the kernel's first pass
    rows = -(-n // TILE) * TILE + -(-m // TILE) * TILE
    coords = torch.empty(min(z1.shape[1], J_MAX) * rows, dtype=V.dtype,
                         device=V.device)
    part = out
    for j0, j1, c1, c2, cw in _component_chunks(z1, z2, w):
        if j0 > 0:
            part = torch.empty_like(out)
        err = _build.lib().rpagp_gram_mvm(
            c1.data_ptr(), c2.data_ptr(), cw.data_ptr(), V.data_ptr(),
            part.data_ptr(), scratch.data_ptr(), coords.data_ptr(), n, m,
            j1 - j0, t, BASES.index(base), S, G, _build.stream_ptr(V.device))
        _build.check(err, "gram_mvm kernel")
        launches["gram_mvm"] += 1
        if j0 > 0:
            out.add_(part)
    return out


def bwd_pass(t: int) -> int:
    """K5's column pass: t rounded up to 1, 4, 8, 12 or 16; passes of 16
    beyond (csrc/gram_mvm.cu bwd_kernel_of)."""
    return 1 if t == 1 else min(16, -(-t // 4) * 4)


def gram_mvm_bwd_plan(n: int, m: int, J: int, t: int, base: str, device):
    """(G, S) of K5 on a CUDA device: its persistent grid and its number
    of z2 chunks, over (64-row tile, z2 chunk) items."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), min(J, J_MAX), bwd_pass(t), base)
    if key not in _bwd_grids:
        G = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            err = _build.lib().rpagp_gram_mvm_bwd_grid(
                key[1], key[2], BASES.index(base), ctypes.addressof(G))
        _build.check(err, "gram_mvm_bwd occupancy query")
        _bwd_grids[key] = G.value
    G = _bwd_grids[key]
    return G, z2_chunks(-(-n // BWD_ROWS), -(-m // BWD_COLS), G)


def _bwd_scratch(n: int, m: int, J: int, t: int, S: int) -> int:
    """Floats of K5's scratch (rpagp_gram_mvm_bwd): the coordinates, V^T,
    the chunks' dz sums and the items' dw sums."""
    RT = -(-n // BWD_ROWS)
    mp = -(-m // BWD_COLS) * BWD_COLS
    tp = -(-t // bwd_pass(t)) * bwd_pass(t)
    return J * (RT * BWD_ROWS + mp) + tp * mp + S * n * J + RT * S * J


def gram_mvm_bwd_cuda(z1, z2, w, V, G, base: str = "rbf"):
    _check_cuda("gram_mvm_bwd", base, z1, z2, w, V, G)
    n, J = z1.shape
    m = z2.shape[0]
    if V.ndim != 2 or V.shape[0] != m or G.shape != (n, V.shape[1]):
        raise ValueError(f"gram_mvm_bwd expects V (m={m}, t) and G (n={n}, t),"
                         f" got {tuple(V.shape)} and {tuple(G.shape)}")
    t = V.shape[1]
    dz = torch.empty(n, J, dtype=z1.dtype, device=z1.device)
    dw = torch.empty(J, dtype=w.dtype, device=w.device)
    if n == 0 or m == 0 or t == 0:
        return dz.zero_(), dw.zero_()
    Gb, S = gram_mvm_bwd_plan(n, m, J, t, base, V.device)
    scratch = torch.empty(_bwd_scratch(n, m, min(J, J_MAX), t, S),
                          dtype=V.dtype, device=V.device)
    for j0, j1, c1, c2, cw in _component_chunks(z1, z2, w):
        dzc = dz if j1 - j0 == J else torch.empty(n, j1 - j0, dtype=z1.dtype,
                                                  device=z1.device)
        err = _build.lib().rpagp_gram_mvm_bwd(
            c1.data_ptr(), c2.data_ptr(), cw.data_ptr(), V.data_ptr(),
            G.data_ptr(), dzc.data_ptr(), dw[j0:j1].data_ptr(),
            scratch.data_ptr(), n, m, j1 - j0, t, BASES.index(base), S, Gb,
            _build.stream_ptr(V.device))
        _build.check(err, "gram_mvm_bwd kernel")
        launches["gram_mvm_bwd"] += 1
        if dzc is not dz:
            dz[:, j0:j1] = dzc
    return dz, dw


def gram_mvm(z1, z2, w, V, base: str = "rbf"):
    """out = K V: z1 (n, J), z2 (m, J), w (J,), V (m, t) -> (n, t)."""
    if z1.device.type == "cpu":
        return gram_mvm_plain(z1, z2, w, V, base)
    if z1.device.type == "cuda":
        return gram_mvm_cuda(z1, z2, w, V, base)
    raise TypeError(f"gram_mvm: no kernel for device {z1.device}")


def gram_mvm_bwd(z1, z2, w, V, G, base: str = "rbf"):
    """(dz1, dw) of out = K V for the cotangent G (n, t)."""
    if z1.device.type == "cpu":
        return gram_mvm_bwd_plain(z1, z2, w, V, G, base)
    if z1.device.type == "cuda":
        return gram_mvm_bwd_cuda(z1, z2, w, V, G, base)
    raise TypeError(f"gram_mvm_bwd: no kernel for device {z1.device}")


class _ProjectedGramMVM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z1, z2, w, V, base):
        ctx.base = base
        ctx.save_for_backward(z1, z2, w, V)
        return gram_mvm(z1, z2, w, V, base)

    @staticmethod
    def backward(ctx, G):
        z1, z2, w, V = ctx.saved_tensors
        base = ctx.base
        G = G.contiguous()
        need_z1, need_z2, need_w, need_V = ctx.needs_input_grad[:4]
        dz1 = dz2 = dw = dV = None
        if need_V:  # K^T G: the forward kernel with the sides swapped
            dV = gram_mvm(z2, z1, w, G, base)
        if need_z1 or need_w:
            dz1, dw = gram_mvm_bwd(z1, z2, w, V, G, base)
        if need_z2:  # both sides swapped: its dw equals the first one's
            dz2 = gram_mvm_bwd(z2, z1, w, G, V, base)[0]
        return dz1, dz2, dw, dV, None


def projected_gram_mvm(z1, z2, w, V, base: str = "rbf"):
    """out = K V for the degree-1 additive projected kernel, differentiable
    in z1, z2, w and V. Pass the same tensor as z1 and z2 for K(x, x):
    autograd then adds dz1 and dz2."""
    return _ProjectedGramMVM.apply(z1, z2, w, V, base)


def dense_supports(spec) -> bool:
    """Specs whose dense Gram K6 / K7 compute: a projection kernel with one
    base for all components, every degree 1, sub_dim 1."""
    return (spec.is_projection and len(set(spec.bases)) == 1
            and all(d == 1 for d in spec.degrees) and spec.sub_dim == 1)


def supports(spec) -> bool:
    """Specs whose Gram MVM K4 / K5 compute: those of dense_supports, no
    SKI."""
    return dense_supports(spec) and not spec.ski


# ------------------------------------------------ K6 / K7: the dense Gram


def dense_gram_plain(u1, u2, w, base: str = "rbf"):
    """K (n, m) by row blocks of the (J, rows, m) differences."""
    n = u1.shape[1]
    out = torch.empty(n, u2.shape[1], dtype=u1.dtype, device=u1.device)
    rows = _plain_rows(*u2.shape)
    for s in range(0, n, rows):
        d = u1[:, s:s + rows, None] - u2[:, None, :]  # (J, rows, m)
        out[s:s + rows] = torch.tensordot(w, k1d_tile(base, d), dims=1)
    return out


def dense_gram_bwd_plain(u1, u2, w, G, base: str = "rbf"):
    """(du1 (J, n), du2 (J, m), dw (J,)) of K = dense_gram(u1, u2, w) for
    the cotangent G (n, m), by the closed form, in row blocks."""
    du1 = torch.empty_like(u1)
    du2 = torch.zeros_like(u2)
    dw = torch.zeros_like(w)
    rows = _plain_rows(*u2.shape)
    for s in range(0, u1.shape[1], rows):
        d = u1[:, s:s + rows, None] - u2[:, None, :]  # (J, rows, m)
        g = G[None, s:s + rows]
        gp = g * k1d_grad_tile(base, d)
        du1[:, s:s + rows] = w[:, None] * torch.sum(gp, dim=2)
        du2 -= w[:, None] * torch.sum(gp, dim=1)
        dw += torch.sum(g * k1d_tile(base, d), dim=(1, 2))
    return du1, du2, dw


def _check_dense(name, base, u1, u2, w, *mats):
    _check_tensors(name, base, u1, u2, w, *mats)
    J = u1.shape[0] if u1.ndim == 2 else -1
    if (u1.ndim != 2 or u2.ndim != 2 or u2.shape[0] != J or w.shape != (J,)
            or J < 1):
        raise ValueError(f"{name} expects u1 (J, n), u2 (J, m), w (J,) with "
                         f"J >= 1, got {tuple(u1.shape)}, "
                         f"{tuple(u2.shape)}, {tuple(w.shape)}")


def dense_gram_cuda(u1, u2, w, base: str = "rbf"):
    """K6: one launch a group of at most J_MAX components, each after the
    first adding its Gram into K."""
    _check_dense("dense_gram", base, u1, u2, w)
    J, n = u1.shape
    m = u2.shape[1]
    out = torch.empty(n, m, dtype=u1.dtype, device=u1.device)
    if n == 0 or m == 0:
        return out
    for j0 in range(0, J, J_MAX):
        j1 = min(J, j0 + J_MAX)
        err = _build.lib().rpagp_dense_gram(
            u1[j0].data_ptr(), u2[j0].data_ptr(), w[j0].data_ptr(),
            out.data_ptr(), n, m, j1 - j0, BASES.index(base), int(j0 > 0),
            _build.stream_ptr(u1.device))
        _build.check(err, "dense_gram kernel")
        launches["dense_gram"] += 1
    return out


def _dense_bwd_scratch(n: int, m: int, J: int) -> int:
    """Floats of K7's scratch (rpagp_dense_gram_bwd): the tiles' row sums
    (CT, J, n), column sums (RT, J, m) and dw sums (RT CT, J)."""
    RT, CT = -(-n // DENSE_TILE), -(-m // DENSE_TILE)
    return J * (CT * n + RT * m + RT * CT)


def dense_gram_bwd_cuda(u1, u2, w, G, base: str = "rbf"):
    """K7: one launch pair a group of at most DENSE_BWD_J_MAX components.
    Pass the same tensor as u1 and u2 for K(x, x): du1 is then the whole
    gradient of the coordinates and du2 is None."""
    _check_dense("dense_gram_bwd", base, u1, u2, w, G)
    J, n = u1.shape
    m = u2.shape[1]
    if G.shape != (n, m):
        raise ValueError(f"dense_gram_bwd expects G (n={n}, m={m}), got "
                         f"{tuple(G.shape)}")
    same = u2 is u1
    du1 = torch.empty_like(u1)
    du2 = None if same else torch.empty_like(u2)
    dw = torch.empty_like(w)
    if n == 0 or m == 0:
        du1.zero_()
        return du1, None if same else du2.zero_(), dw.zero_()
    scratch = torch.empty(_dense_bwd_scratch(n, m, min(J, DENSE_BWD_J_MAX)),
                          dtype=u1.dtype, device=u1.device)
    for j0 in range(0, J, DENSE_BWD_J_MAX):
        j1 = min(J, j0 + DENSE_BWD_J_MAX)
        err = _build.lib().rpagp_dense_gram_bwd(
            u1[j0].data_ptr(), u2[j0].data_ptr(), w[j0].data_ptr(),
            G.data_ptr(), du1[j0].data_ptr(),
            du1[j0].data_ptr() if same else du2[j0].data_ptr(),
            dw[j0].data_ptr(), scratch.data_ptr(), n, m, j1 - j0,
            BASES.index(base), int(same), _build.stream_ptr(u1.device))
        _build.check(err, "dense_gram_bwd kernel")
        launches["dense_gram_bwd"] += 1
    return du1, du2, dw


def dense_gram_fwd(u1, u2, w, base: str = "rbf"):
    """K (n, m) = sum_j w_j k1d(u1[j, :, None] - u2[j, None, :])."""
    with span("rpagp.op.dense_gram", (u1.shape[0], u1.shape[1], u2.shape[1],
                                      "fwd")):
        if u1.device.type == "cpu":
            return dense_gram_plain(u1, u2, w, base)
        if u1.device.type == "cuda":
            return dense_gram_cuda(u1, u2, w, base)
    raise TypeError(f"dense_gram: no kernel for device {u1.device}")


def dense_gram_bwd(u1, u2, w, G, base: str = "rbf"):
    """(du1, du2, dw) for the cotangent G (n, m); where u2 is u1, du1 is
    the whole gradient of the coordinates and du2 is None."""
    with span("rpagp.op.dense_gram", (u1.shape[0], u1.shape[1], u2.shape[1],
                                      "bwd")):
        if u1.device.type == "cpu":
            du1, du2, dw = dense_gram_bwd_plain(u1, u2, w, G, base)
            return (du1 + du2, None, dw) if u2 is u1 else (du1, du2, dw)
        if u1.device.type == "cuda":
            return dense_gram_bwd_cuda(u1, u2, w, G, base)
    raise TypeError(f"dense_gram_bwd: no kernel for device {u1.device}")


class _DenseGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u1, u2, w, base):
        # u2 None: K(x, x), one set of coordinates on both sides
        ctx.base = base
        ctx.save_for_backward(u1, u2, w)
        return dense_gram_fwd(u1, u1 if u2 is None else u2, w, base)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        u1, u2, w = ctx.saved_tensors
        du1, du2, dw = dense_gram_bwd(u1, u1 if u2 is None else u2, w,
                                      G.contiguous(), ctx.base)
        return du1, du2, dw, None


def dense_gram(u1, u2, w, base: str = "rbf"):
    """The dense Gram (n, m) of the degree-1 additive projected kernel,
    differentiable in u1 (J, n), u2 (J, m) and w (J,), storing no (J, n,
    m) tensor. Pass the same tensor as u1 and u2 for K(x, x)."""
    same = u2 is u1
    return _DenseGram.apply(u1.contiguous(),
                            None if same else u2.contiguous(),
                            w.contiguous(), base)
