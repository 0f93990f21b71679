"""Kernel specification, the dense Gram and the blocked kernel MVM
(port of rpagp/ops/kernels.py): the full-D stationary kernels, the
closed-form J -> inf limit of the RPA kernel, and the projected additive
kernel.

A kernel is a static `KernelSpec` plus dicts of tensors: params
{"raw_lengthscale", "raw_outputscale"[, "proj"]} and buffers {"proj"}
(projection kernels only).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..utils.transforms import softplus

FULL_D_FAMILIES = ("rbf", "matern12", "matern32", "matern52")
# the J -> inf limit of the RPA kernel for gaussian projections and an RBF
# base (arXiv:1912.12834 Thm 1): os / sqrt(1 + |x - x'|^2 / (D l^2))
LIMIT_FAMILIES = ("rp_limit_rbf",)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static kernel configuration; the same fields as the JAX package's
    KernelSpec (see its docstring for their meaning)."""

    family: str = "rbf"
    ard: bool = True
    J: int = 0
    degrees: Tuple[int, ...] = ()
    bases: Tuple[str, ...] = ()
    sub_dim: int = 1
    proj_dist: str = "gaussian"
    learn_proj: bool = False
    per_component_scale: bool = False
    space_proj: bool = False
    ski: bool = False
    grid_size: int = 0
    interp: str = "dense"

    @property
    def is_projection(self) -> bool:
        return self.family == "projection"

    @property
    def total_proj_dims(self) -> int:
        return int(sum(self.degrees)) * self.sub_dim

    @property
    def num_lengthscales(self) -> int:
        return int(sum(self.degrees))

    @staticmethod
    def polynomial(J: int, d: int = 1, base: str = "rbf", k: int = 1,
                   **kw) -> "KernelSpec":
        """PolynomialProjectionKernel(J, k, d, base) equivalent."""
        return KernelSpec(family="projection", J=J, degrees=(d,) * J,
                          bases=(base,) * J, sub_dim=k, **kw)

    @staticmethod
    def generalized(degrees, bases, **kw) -> "KernelSpec":
        """GeneralizedProjectionKernel equivalent."""
        degrees = tuple(int(d) for d in degrees)
        bases = tuple(bases)
        if len(degrees) != len(bases):
            raise ValueError("degrees and bases differ in length")
        return KernelSpec(family="projection", J=len(degrees),
                          degrees=degrees, bases=bases, **kw)


_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _k1d(base: str, t):
    """Stationary 1-D kernel value at scaled difference t."""
    if base == "rbf":
        return torch.exp(-0.5 * t * t)
    a = torch.abs(t)
    if base == "matern12":
        return torch.exp(-a)
    if base == "matern32":
        s = _SQRT3 * a
        return (1.0 + s) * torch.exp(-s)
    if base == "matern52":
        s = _SQRT5 * a
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(f"unknown 1-D base kernel {base!r}")


def _get_proj(params, buffers):
    return params["proj"] if "proj" in params else buffers["proj"]


def init_kernel_params(spec: KernelSpec, D: int, generator=None, proj=None,
                       device="cuda"):
    """(params, buffers) for a kernel; raw values start at 0 (the GPyTorch
    defaults). A full-D kernel has one lengthscale per input dimension
    (ard) or one shared; the limit kernel one shared. A projection kernel
    takes `proj`, an explicit (D, M) projection used as given (tests pass
    the JAX package's), or else draws one from `generator` on the CPU with
    gen_rp, spaced by space_equally when spec.space_proj, so that it does
    not depend on the device."""
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    if spec.family in FULL_D_FAMILIES:
        return {"raw_lengthscale": zeros(D if spec.ard else 1),
                "raw_outputscale": zeros()}, {}
    if spec.family in LIMIT_FAMILIES:
        return {"raw_lengthscale": zeros(1), "raw_outputscale": zeros()}, {}
    if not spec.is_projection:
        raise ValueError(f"unknown kernel family {spec.family!r}")
    if proj is None:
        from ..projections import gen_rp, space_equally

        proj = gen_rp(D, spec.total_proj_dims, spec.proj_dist,
                      generator=generator)
        if spec.space_proj:
            proj, _ = space_equally(proj)
    proj = torch.as_tensor(proj, dtype=torch.float32).to(device)
    params = {
        "raw_lengthscale": zeros(spec.num_lengthscales),
        "raw_outputscale": (zeros(spec.J) if spec.per_component_scale
                            else zeros()),
    }
    buffers = {}
    if spec.learn_proj:
        params["proj"] = proj
    else:
        buffers["proj"] = proj
    return params, buffers


def _component_scales(spec: KernelSpec, params):
    """Per-component weights w_j = outputscale / J: (J,)."""
    outputscale = softplus(params["raw_outputscale"])
    if spec.per_component_scale:
        return outputscale / spec.J
    return outputscale.expand(spec.J) / spec.J


def gram_diag(spec: KernelSpec, params, buffers, x):
    """diag K(x, x): k(0) = 1 for every stationary piece, so the
    outputscale per point (the sum of the w_j for a projection kernel)."""
    ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    if not spec.is_projection:
        return ones * softplus(params["raw_outputscale"])
    return ones * torch.sum(_component_scales(spec, params))


def _component_groups(spec: KernelSpec):
    """Group components by (degree, base) so each group is one batched op.
    Returns a list of (degree, base, component_indices, flat_proj_indices),
    sorted by (degree, base)."""
    groups = {}
    offset = 0
    k = spec.sub_dim
    for j, (d, b) in enumerate(zip(spec.degrees, spec.bases)):
        comp_idx, flat_idx = groups.setdefault((d, b), ([], []))
        comp_idx.append(j)
        flat_idx.extend(range(offset, offset + d * k))
        offset += d * k
    return [(d, b, tuple(ci), tuple(fi))
            for (d, b), (ci, fi) in sorted(groups.items())]


def _take(t, idx):
    """t[idx] along dim 0, as slices of idx's runs of consecutive indices
    (one run, one slice: every group of a kernel with one base and one
    degree): indexing a CUDA tensor with a Python list copies the list to
    the device and waits, which no CUDA graph can hold."""
    runs = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    parts = [t[a:b] for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _projected_coords(spec: KernelSpec, params, buffers, x):
    """x (n, D) -> lengthscale-scaled projected coordinates (M, n)."""
    P = _get_proj(params, buffers)
    ls = softplus(params["raw_lengthscale"])  # (num_lengthscales,)
    if spec.sub_dim > 1:
        ls = torch.repeat_interleave(ls, spec.sub_dim)
    return (x @ P / ls).T


def _projection_gram(spec: KernelSpec, params, buffers, x1, x2):
    """Dense RPA Gram (n, m). A float32 Gram of a spec the kernels support
    (cuda_gram.dense_supports) is cuda_gram.dense_gram: K6 / K7 on the
    card, their plain twins on the CPU, nothing of size (J, n, m) stored.
    Any other materializes (J, n, m) per group, so only for small blocks
    (the CG path goes through `mvm`).

    `not spec.ski` is a limit of scope for now, not one of the kernels: it
    keeps a SKI spec's Grams (the SKI + BBMM preconditioner's pivot rows,
    the grid posterior's K_ss) on the materialized path until a change
    measured on the SKI + BBMM step moves them."""
    from . import cuda_gram

    u1 = _projected_coords(spec, params, buffers, x1)  # (M, n)
    u2 = u1 if x2 is x1 else _projected_coords(spec, params, buffers, x2)
    w = _component_scales(spec, params)
    if (x1.dtype == x2.dtype == torch.float32
            and cuda_gram.dense_supports(spec) and not spec.ski):
        return cuda_gram.dense_gram(u1, u2, w, spec.bases[0])
    return _materialized_projection_gram(spec, u1, u2, w)


def _materialized_projection_gram(spec: KernelSpec, u1, u2, w):
    """The Gram from (M, n) and (M, m) coordinates through the (J, n, m)
    differences and values of each group of components."""
    n, m = u1.shape[1], u2.shape[1]
    out = torch.zeros(n, m, dtype=u1.dtype, device=u1.device)
    for d, base, comp_idx, flat_idx in _component_groups(spec):
        dk = d * spec.sub_dim  # 1-D factors per component
        t = (_take(u1, flat_idx)[:, :, None]
             - _take(u2, flat_idx)[:, None, :])  # (g*dk, n, m)
        # the product of a component's dk factors by dk - 1 products:
        # torch.prod's backward counts the zeros on the host
        kv = functools.reduce(
            torch.mul, _k1d(base, t).reshape(len(comp_idx), dk, n,
                                              m).unbind(1))
        out = out + torch.tensordot(_take(w, comp_idx), kv, dims=1)
    return out


def _sqdist(u1, u2, same: bool):
    """|u1_i - u2_k|^2 (n, m) by |u1|^2 + |u2|^2 - 2 u1 u2^T, clamped at 0,
    with exact zeros on the diagonal when `same` (x2 is x1)."""
    sq = (torch.sum(u1 * u1, dim=-1)[:, None]
          + torch.sum(u2 * u2, dim=-1)[None, :] - 2.0 * (u1 @ u2.T))
    sq = torch.clamp(sq, min=0.0)
    if same:
        n = u1.shape[0]
        sq = sq * (1.0 - torch.eye(n, dtype=sq.dtype, device=sq.device))
    return sq


def _full_d_gram(spec: KernelSpec, params, x1, x2):
    """Full-D stationary Gram (n, m) on lengthscale-scaled inputs; the
    Matern families take r = sqrt(sq + 1e-20), finite in reverse mode at
    r = 0."""
    ls = softplus(params["raw_lengthscale"])  # (D,) or (1,)
    sq = _sqdist(x1 / ls, x2 / ls, x2 is x1)
    if spec.family == "rbf":
        k = torch.exp(-0.5 * sq)
    else:
        k = _k1d(spec.family, torch.sqrt(sq + 1e-20))
    return softplus(params["raw_outputscale"]) * k


def _limit_gram(spec: KernelSpec, params, x1, x2):
    """The closed-form J -> inf RPA limit kernel (n, m):
    os / sqrt(1 + |x - x'|^2 / (D l^2)), one shared lengthscale."""
    ls = softplus(params["raw_lengthscale"])[0]
    D = x1.shape[1]
    sq = _sqdist(x1, x2, x2 is x1)
    return softplus(params["raw_outputscale"]) * torch.rsqrt(
        1.0 + sq / (D * ls * ls))


def gram(spec: KernelSpec, params, buffers, x1, x2):
    """Dense Gram matrix K(x1, x2), (n, m). Pass the same tensor twice for
    K(x, x): the full-D and limit kernels then put exact zeros on the
    diagonal of the squared distances."""
    if spec.is_projection:
        return _projection_gram(spec, params, buffers, x1, x2)
    if spec.family in LIMIT_FAMILIES:
        return _limit_gram(spec, params, x1, x2)
    return _full_d_gram(spec, params, x1, x2)


def mvm(spec: KernelSpec, params, buffers, x1, x2, V, block_rows: int = 2048,
        allow_pallas: bool = False):
    """K(x1, x2) @ V, (n, t), without materializing the (n, m) Gram.

    On a CUDA tensor, with allow_pallas and a spec the kernels support
    (cuda_gram.supports), this is K4 (backward K5) through
    cuda_gram.projected_gram_mvm. Otherwise row blocks of K are built and
    contracted one at a time, with the block capped so the (M, block, m)
    intermediate stays within 2^26 elements, and each block recomputed in
    backward (torch.utils.checkpoint), so reverse mode stores O(block * t)
    and not the Gram slabs."""
    from . import cuda_gram

    if allow_pallas and x1.device.type == "cuda" and cuda_gram.supports(spec):
        u1 = _projected_coords(spec, params, buffers, x1).T.contiguous()
        u2 = (u1 if x2 is x1 else
              _projected_coords(spec, params, buffers, x2).T.contiguous())
        w = _component_scales(spec, params).contiguous()
        return cuda_gram.projected_gram_mvm(u1, u2, w, V.contiguous(),
                                            spec.bases[0])

    n, m = x1.shape[0], x2.shape[0]
    M_total = max(1, spec.total_proj_dims if spec.is_projection else 1)
    block_rows = min(block_rows, max(16, (1 << 26) // (M_total * max(m, 1))))

    def block_fn(xb):
        return gram(spec, params, buffers, xb, x2) @ V

    grad = torch.is_grad_enabled()
    outs = [checkpoint(block_fn, x1[s:s + block_rows], use_reentrant=False)
            if grad else block_fn(x1[s:s + block_rows])
            for s in range(0, n, block_rows)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)
