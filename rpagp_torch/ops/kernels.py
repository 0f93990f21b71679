"""Kernel specification and the projected-kernel pieces the grid path
uses (subset of rpagp/ops/kernels.py).

A kernel is a static `KernelSpec` plus dicts of tensors: params
{"raw_lengthscale", "raw_outputscale"[, "proj"]} and buffers {"proj"}.
The dense Gram and the blocked MVM are ROADMAP slice 2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..utils.transforms import softplus


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
                       device="cpu"):
    """(params, buffers) for a projection kernel; raw values start at 0.
    proj: an explicit (D, M) projection (tests pass the JAX package's);
    otherwise gen_rp draws one from `generator`."""
    if not spec.is_projection:
        raise NotImplementedError(
            f"kernel family {spec.family!r}: only projection kernels are "
            "ported (full-D kernels are ROADMAP slice 8)")
    if spec.space_proj:
        raise NotImplementedError("space_proj: ROADMAP slice 8")
    if proj is None:
        from ..projections import gen_rp

        proj = gen_rp(D, spec.total_proj_dims, spec.proj_dist,
                      generator=generator)
    proj = torch.as_tensor(proj, dtype=torch.float32).to(device)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
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
    """diag K(x, x): k1d(0) = 1 for every base, so sum_j w_j per point."""
    w = _component_scales(spec, params)
    return torch.ones(x.shape[0], dtype=x.dtype, device=x.device) * torch.sum(w)
