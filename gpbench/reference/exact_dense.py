"""The plain reference of the dense exact RPA-GP (arXiv:1912.12834, the
exact GP on a UCI set; specs/rp_poly_j20.json): the projected additive
Gram, the exact marginal log-likelihood through a Cholesky factor, its
gradient by autograd, and Adam's first steps, from x, y, the projection
and the raw hyperparameters.

  k(x, x') = (s / J) sum_j exp(-(p_j^T x - p_j^T x')^2 / (2 l_j^2))
  loss     = -mll / n = [y_c^T A^{-1} y_c + logdet A + n log 2 pi] / 2n,
             A = K + (noise + 1e-6) I, y_c = y - c

with s = softplus(raw_outputscale), l_j = softplus(raw_lengthscale_j),
noise = softplus(raw_noise) + 1e-4 and c the constant mean.

Departures from the paper and the spec, each as the program has it:
  - the noise has a floor of 1e-4 and the factor a jitter of 1e-6 (the
    port's ModelSpec defaults; the paper's GPyTorch model has a noise
    constraint of its own)
  - the outputscale is shared by the J components and divided by J (the
    spec's "per_component_scale": false)
  - the hyperparameters start at raw 0, GPyTorch's defaults, and Adam
    runs at a constant lr (the spec's "lr_schedule" default)

The Gram is built in blocks of ROWS rows, so that its (rows, n, J)
intermediate stays small at n in the thousands in float64. The gradient
is autograd's, in two passes that keep the memory to a block: the loss's
gradient with respect to K (a leaf), then each block of the Gram rebuilt
under autograd and its share of that gradient pulled back to the
lengthscales and the outputscale.

Plain torch only: it imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpbench.reference import common

JITTER = 1e-6
ROWS = 256  # rows of a Gram block: (256, n, J) float64 is 150 MB at n 3,723


def _scaled(z, p):
    """(z / l (n, J), s / J) at raw hyperparameters p."""
    return z / F.softplus(p["raw_lengthscale"]), \
        F.softplus(p["raw_outputscale"]) / z.shape[1]


def gram_rows(z, p, lo: int, hi: int):
    """Rows lo:hi of K(x, x), from z = x @ proj (n, J)."""
    u, w = _scaled(z, p)
    d = u[lo:hi, None, :] - u[None, :, :]
    return w * torch.exp(-0.5 * d * d).sum(-1)


def gram(z, p):
    """K(x, x) (n, n), block by block."""
    n = z.shape[0]
    return torch.cat([gram_rows(z, p, i, min(i + ROWS, n))
                      for i in range(0, n, ROWS)])


def mll_loss(K, y, p):
    """-mll / n at the Gram K."""
    n = K.shape[0]
    noise = F.softplus(p["raw_noise"]) + common.NOISE_FLOOR
    A = K + (noise + JITTER) * torch.eye(n, dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(A)
    yc = y - p["mean_const"]
    alpha = torch.cholesky_solve(yc[:, None], L)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return 0.5 * (yc @ alpha + logdet + n * common.LOG_2PI) / n


def loss_and_grad(z, y, p):
    """(loss, {leaf: gradient}) at raw hyperparameters p."""
    q = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    with torch.no_grad():
        K = gram(z, q)
    K.requires_grad_(True)
    loss = mll_loss(K, y, q)
    loss.backward()
    n = z.shape[0]
    for i in range(0, n, ROWS):
        hi = min(i + ROWS, n)
        gram_rows(z, q, i, hi).backward(K.grad[i:hi])
    return loss.detach(), {k: v.grad for k, v in q.items()}


def first_steps(x, y, proj, lr: float, n_steps: int, dtype) -> dict:
    """The first n_steps Adam steps from the initial hyperparameters, and
    the Gram at them: {"losses", "grad" (the first), "start", "end",
    "gram"}, in `dtype` (under common.precision)."""
    z = common.project(x, proj, dtype)
    y = y.to(dtype)
    p0 = common.zero_params(z.shape[1], dtype, z.device)
    losses, grad, end = common.adam_steps(
        p0, lr, [lambda p: loss_and_grad(z, y, p)] * n_steps)
    with torch.no_grad():
        K = gram(z, p0)
    return {"losses": losses, "grad": grad, "start": p0, "end": end,
            "gram": K}
