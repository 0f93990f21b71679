"""Plain pieces of the degree-1 SKI additive GP that the flagship spec
states (arXiv:1912.12834 with KISS-GP interpolation), shared by the
references: the cubic-convolution kernel, the projection, the grid, the
initial hyperparameters, Adam's update, and the precisions a reference
runs in (float64; float32 with TF32 matmuls for the control).

It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

NOISE_FLOOR = 1e-4
LOG_2PI = math.log(2.0 * math.pi)
_BETAS, _ADAM_EPS = (0.9, 0.999), 1e-8


@contextlib.contextmanager
def precision(name: str):
    """"f64": float64. "tf32": float32 with TF32 matmuls (the control)."""
    if name == "f64":
        yield torch.float64
        return
    if name != "tf32":
        raise ValueError(f"unknown precision {name!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield torch.float32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def cubic(s):
    """Keys' cubic-convolution kernel (a = -0.5), support |s| < 2."""
    a = torch.abs(s)
    return torch.where(a <= 1.0, 1.5 * a**3 - 2.5 * a**2 + 1.0,
                       torch.where(a < 2.0, -0.5 * a**3 + 2.5 * a**2
                                   - 4.0 * a + 2.0, torch.zeros_like(a)))


def project(x, proj, dtype):
    """Projected coordinates (n, J)."""
    return x.to(dtype) @ proj.to(x.device, dtype)


def grid(lo, hi, m: int):
    """(grid_lo, h) of an m-point grid over [lo, hi] with two cells of
    padding on each side."""
    h = torch.clamp(hi - lo, min=1e-6) / (m - 5)
    return lo - 2.0 * h, h


def zero_params(J: int, dtype, device) -> dict:
    """The initial raw hyperparameters (all 0, GPyTorch's defaults)."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return {"raw_lengthscale": z(J), "raw_outputscale": z(),
            "mean_const": z(), "raw_noise": z()}


def adam_steps(params, lr: float, steps):
    """Adam (torch's update, constant lr) from `params`, one step for each
    of `steps`, callables p -> (loss, {name: gradient}): (losses, first
    gradients, params after the steps)."""
    p = {k: v.clone() for k, v in params.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    sq = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    b1, b2 = _BETAS
    for t, step in enumerate(steps, start=1):
        loss, g = step(p)
        losses.append(float(loss))
        first = g if first is None else first
        for k in p:
            mom[k] = b1 * mom[k] + (1 - b1) * g[k]
            sq[k] = b2 * sq[k] + (1 - b2) * g[k] * g[k]
            denom = (sq[k].sqrt() / math.sqrt(1 - b2 ** t)) + _ADAM_EPS
            p[k] = p[k] - (lr / (1 - b1 ** t)) * mom[k] / denom
    return losses, first, p
