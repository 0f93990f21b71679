"""Raw <-> constrained hyperparameters (port of rpagp/utils/transforms.py).

GPyTorch's convention: a positive hyperparameter is stored raw and mapped
through softplus, so raw 0.0 gives the familiar 0.6931 default.
"""

from __future__ import annotations

import torch.nn.functional as F

# linear above 20, as the JAX package's softplus (and torch's)
_THRESHOLD = 20.0


def softplus(raw):
    """log(1 + exp(x)), linear for x > 20."""
    return F.softplus(raw, beta=1.0, threshold=_THRESHOLD)
