"""Raw <-> constrained hyperparameters (port of rpagp/utils/transforms.py).

GPyTorch's convention: a positive hyperparameter is stored raw and mapped
through softplus, so raw 0.0 gives the familiar 0.6931 default.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# linear above 20, as the JAX package's softplus (and torch's)
_THRESHOLD = 20.0


def softplus(raw):
    """log(1 + exp(x)), linear for x > 20."""
    return F.softplus(raw, beta=1.0, threshold=_THRESHOLD)


def inv_softplus(value):
    """Inverse of softplus: log(exp(y) - 1), the identity for y > 20."""
    value = torch.as_tensor(value)
    return torch.where(value > _THRESHOLD, value,
                       torch.log(torch.expm1(torch.clamp(value,
                                                         max=_THRESHOLD))))


def inv_softplus_np(value):
    """numpy inv_softplus in float64, for host-side initial values."""
    value = np.asarray(value, dtype=np.float64)
    return np.where(value > _THRESHOLD, value,
                    np.log(np.expm1(np.minimum(value, _THRESHOLD))))


def constrain(raw):
    """Raw -> positive constrained value (softplus)."""
    return softplus(raw)


def unconstrain(value):
    """Positive constrained value -> raw (inverse softplus)."""
    return inv_softplus(value)
