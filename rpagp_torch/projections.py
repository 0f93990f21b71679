"""Random projections (subset of rpagp/projections.py).

Drawn from an explicit `torch.Generator`; the stream differs from the
JAX package's threefry stream, so tests hand both packages the same
numpy projection instead of the same seed.
"""

from __future__ import annotations

import math

import torch


def gen_rp(D: int, M: int, dist: str = "gaussian", generator=None):
    """(D, M) projection matrix; gaussian: i.i.d. N(0, 1/D) entries."""
    if dist != "gaussian":
        raise NotImplementedError(
            f"projection distribution {dist!r}: only 'gaussian' is ported "
            "(the others are ROADMAP slice 8)")
    return torch.randn(D, M, generator=generator) / math.sqrt(D)
