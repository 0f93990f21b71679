"""Gaussian log-density helpers (subset of rpagp/ops/exact.py).

Only what the grid path needs: the constant and the predictive NLL. The
dense Cholesky MLL and posterior are ROADMAP slice 8.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = 1.8378770664093453


def gaussian_nll(y_true, mean, var):
    """Average predictive negative log-likelihood (the runner's NLL column)."""
    return 0.5 * torch.mean(torch.log(2.0 * math.pi * var)
                            + (y_true - mean) ** 2 / var)
