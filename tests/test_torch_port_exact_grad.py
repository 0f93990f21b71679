"""The exact MLL's closed-form gradient (ops/exact.py `_CholeskyMLL`)
against autograd through block_chol.blocked_cholesky, on the CPU.

The oracle is the MLL written out in plain autograd, the factor included
(n 700: the blocked elimination, two K1 leaves; n 300: the builtin
factor). Its gradient in K need not be symmetric: the blocked factor
reads one triangle of each trailing block. Both give the same gradient
of any function of a symmetric K, so K is compared by its symmetric
part. Bars: float64, rel <= 1e-9.
"""

import math

import pytest
import torch

from rpagp_torch.ops import exact
from rpagp_torch.ops.block_chol import blocked_cholesky

JITTER = 1e-6


def _problem(n, seed=0):
    """An RBF Gram of n points in 3-D, a target and a noise, float64."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 3, generator=g, dtype=torch.float64)
    K = torch.exp(-0.5 * torch.cdist(x, x) ** 2)
    y = torch.sin(x.sum(1)) + 0.1 * torch.randn(n, generator=g,
                                                dtype=torch.float64)
    return K, y - y.mean(), torch.tensor(0.1, dtype=torch.float64)


def _autograd_mll(K, y, noise):
    """The MLL by plain autograd through the factor."""
    L = blocked_cholesky(exact.add_jitter(K, noise, JITTER))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return -0.5 * (y @ alpha + logdet + y.shape[0] * exact.LOG_2PI)


def _value_and_grads(fn, K, y, noise):
    K, y, noise = (t.detach().clone().requires_grad_(True)
                   for t in (K, y, noise))
    v = fn(K, y, noise)
    v.backward()
    return v.detach(), 0.5 * (K.grad + K.grad.T), y.grad, noise.grad


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("n", [700, 300])
def test_closed_form_gradient_matches_autograd_through_the_factor(n):
    K, y, noise = _problem(n)
    new = _value_and_grads(
        lambda K, y, s: exact.cholesky_mll(K, y, s, JITTER), K, y, noise)
    old = _value_and_grads(_autograd_mll, K, y, noise)
    for name, a, b in zip(("value", "K", "y", "noise"), new, old):
        assert _rel(a, b) <= 1e-9, (name, _rel(a, b))


@pytest.mark.parametrize("n, where", [(700, "noise"), (700, "last"),
                                      (300, "noise")])
def test_indefinite_khat_gives_nan_loss_and_nonfinite_gradients(n, where):
    K, y, noise = _problem(n)
    if where == "noise":
        # K + s I indefinite from the first leaf on
        noise = torch.tensor(-5.0, dtype=torch.float64)
    else:
        # only the last Schur complement (the second leaf) is indefinite
        K[-1, -1] = -10.0
    K, y, noise = (t.requires_grad_(True) for t in (K, y, noise))
    v = exact.cholesky_mll(K, y, noise, JITTER)
    v.backward()
    assert math.isnan(float(v.detach()))
    for t in (K, y, noise):
        assert not bool(torch.isfinite(t.grad).all())


def test_the_exact_mll_records_no_graph_through_the_factor():
    K, y, noise = (t.requires_grad_(True) for t in _problem(700))
    v = exact.cholesky_mll(K, y, noise, JITTER)
    seen, todo = set(), [v.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    names = sorted(type(f).__name__ for f in seen)
    # the Function, then add_jitter's (noise + jitter) * I + K, then leaves
    assert names[-1] == "_CholeskyMLLBackward", names
    assert not any("Cat" in m or "Slice" in m or "Chol" in m
                   for m in names[:-1]), names
    assert len(names) <= 8, names
