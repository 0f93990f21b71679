"""The benchmark's inputs, made from the run's seed: a frozen copy of the
port's synthetic regression recipe (rpagp_torch/utils/datasets.py
`_synthetic`, `zscore_fit_apply`, `kfold_splits` with equal_train) and of
its Gaussian projection draw (rpagp_torch/projections.py `gen_rp`),
rewritten in torch so that 2M rows are made on the card in a few calls.

Plain torch only: this module imports nothing of the program, so the
program and the reference are handed the same tensors and neither makes
the other's inputs.
"""

from __future__ import annotations

import math

import torch


def synthetic(n: int, d: int, seed: int, device) -> tuple:
    """(X (n, d), y (n,)) float64 on `device`: y = sum_j a_j sin(w_j . x +
    b_j) + 0.1 noise with J = max(4, d) waves, all drawn from one
    generator on `device` seeded with `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    X = torch.randn(n, d, **f64)
    J = max(4, d)
    W = torch.randn(d, J, **f64) / math.sqrt(d)
    b = torch.rand(J, **f64) * (2.0 * math.pi)
    a = torch.randn(J, **f64) / math.sqrt(J)
    y = torch.sin(X @ W + b) @ a + 0.1 * torch.randn(n, **f64)
    return X, y


def fold_indices(n: int, k: int, seed: int, device) -> list:
    """k (train_idx, test_idx) pairs of a seeded permutation split as
    numpy's array_split; every train set trimmed to n minus the largest
    fold, so all folds have one train shape."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    perm = torch.randperm(n, generator=g, device=device)
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    folds = list(torch.split(perm, sizes))
    n_train = n - max(sizes)
    return [(torch.cat(folds[:i] + folds[i + 1:])[:n_train], folds[i])
            for i in range(k)]


def zscored_split(X, y, train_idx, test_idx) -> dict:
    """A split z-scored by its TRAIN statistics (float64 arithmetic, stds
    under 1e-10 set to 1), cast to float32: train_x, train_y, test_x,
    test_y on X's device."""
    Xtr, ytr = X[train_idx], y[train_idx]
    mean, std = Xtr.mean(dim=0), Xtr.std(dim=0, unbiased=False)
    std = torch.where(std < 1e-10, torch.ones_like(std), std)
    y_mean, y_std = ytr.mean(), ytr.std(unbiased=False)
    y_std = torch.where(y_std > 1e-10, y_std, torch.ones_like(y_std))
    zx = lambda A: ((A - mean) / std).float()
    zy = lambda v: ((v - y_mean) / y_std).float()
    return {"train_x": zx(Xtr), "train_y": zy(ytr),
            "test_x": zx(X[test_idx]), "test_y": zy(y[test_idx])}


def gaussian_projection(d: int, J: int, seed: int):
    """(d, J) float32 projection on the CPU, i.i.d. N(0, 1/d): the draw a
    CPU torch.Generator seeded with `seed` gives."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(d, J, generator=g) / math.sqrt(d)
