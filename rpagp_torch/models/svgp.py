"""Stochastic variational GP (SVGP) regression, the inducing-point
baseline (port of rpagp/models/svgp.py; see its module docstring for the
model).

Whitened parameterization: q(u) = N(L_MM v, L_MM S L_MM^T) with S = C C^T,
C lower-triangular, and L_MM the Cholesky factor of K_MM (+ jitter). The
ELBO is closed-form for the Gaussian likelihood. Params beyond the base
kernel's, the noise and the mean:
  inducing   (M, D) inducing locations (trainable; a random training
             subset at init)
  var_mean   (M,) whitened variational mean
  var_chol   (M, M) raw lower factor of S (diagonal through softplus)

No kernel of this package runs here: the full-D Gram is kernels.gram, the
M x M factor torch.linalg.cholesky_ex and the solve
torch.linalg.solve_triangular, as the JAX package leaves them to XLA.
Training makes no host read within an epoch: the shuffle is a device
torch.randperm from a generator, and the epoch's mean loss is read once.
`train_svgp_distributed` shards each minibatch's rows over a process
group (parallel/sharding.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import kernels
from ..ops.exact import LOG_2PI
from ..train import _leaves, _tree_map
from ..utils.transforms import softplus
from .exact_gp import ModelSpec, mean_fn, noise_value

# softplus(_VAR_CHOL_DIAG0) = 1: var_chol starts at the identity factor
_VAR_CHOL_DIAG0 = 0.5413248


def init_svgp_params(spec: ModelSpec, x_train, num_inducing: int,
                     generator=None, inducing=None, device="cuda"):
    """(params, buffers) for SVGP on `device` (the card unless the caller
    asks for the CPU). The inducing points are `inducing` (M, D) if given
    (tests pass the JAX package's), else a random subset of x_train of
    num_inducing rows, drawn by torch.randperm from `generator` (a CPU
    generator: the same subset on either device)."""
    x_train = torch.as_tensor(x_train)
    D = x_train.shape[1]
    kp, kb = kernels.init_kernel_params(spec.kernel, D, generator=generator,
                                        device=device)
    if inducing is None:
        idx = torch.randperm(x_train.shape[0], generator=generator)
        inducing = x_train[idx[:num_inducing].to(x_train.device)]
    if not torch.is_tensor(inducing):
        inducing = torch.from_numpy(np.array(inducing, dtype=np.float32))
    Z = inducing.to(device=device, dtype=torch.float32)
    M = Z.shape[0]
    zero = torch.zeros((), device=device)
    params = {
        "raw_noise": zero.clone(),
        "mean_const": zero.clone(),
        "kernel": kp,
        "inducing": Z.clone(),
        "var_mean": torch.zeros(M, device=device),
        "var_chol": _VAR_CHOL_DIAG0 * torch.eye(M, device=device),
    }
    return params, {"kernel": kb}


def _var_chol(params):
    """Lower-triangular C with a softplus-positive diagonal."""
    raw = params["var_chol"]
    return torch.tril(raw, -1) + torch.diag(softplus(torch.diagonal(raw)))


def _kmm_chol(spec: ModelSpec, params, buffers):
    """The Cholesky factor of K_MM + 10 jitter I. cholesky_ex's info is not
    read (no host read), as the JAX package's cholesky reads nothing
    back; a failed factor shows as non-finite values downstream."""
    Z = params["inducing"]
    Kmm = kernels.gram(spec.kernel, params["kernel"], buffers["kernel"], Z, Z)
    Kmm = Kmm + spec.jitter * 10.0 * torch.eye(Z.shape[0], dtype=Kmm.dtype,
                                                device=Kmm.device)
    return torch.linalg.cholesky_ex(Kmm).L


def _predictive_qf(spec: ModelSpec, params, buffers, x):
    """q(f(x)): mean and variance of the variational marginals. With
    A = L_MM^{-1} K_MZ^T (M, n): mean = A^T v, var = k_diag - sum(A^2)
    + sum((C^T A)^2), floored at 1e-10."""
    kspec, kp, kb = spec.kernel, params["kernel"], buffers["kernel"]
    Z = params["inducing"]
    L = _kmm_chol(spec, params, buffers)
    Kxz = kernels.gram(kspec, kp, kb, x, Z)  # (n, M)
    A = torch.linalg.solve_triangular(L, Kxz.T, upper=False)  # (M, n)
    mean = A.T @ params["var_mean"]
    CA = _var_chol(params).T @ A
    kdiag = kernels.gram_diag(kspec, kp, kb, x)
    var = kdiag - torch.sum(A * A, dim=0) + torch.sum(CA * CA, dim=0)
    return mean + mean_fn(spec, params, x), torch.clamp(var, min=1e-10)


def elbo(spec: ModelSpec, params, buffers, x_batch, y_batch, n_total: int):
    """Minibatch evidence lower bound at the total-data scale:
    (n/|B|) sum_i [log N(y_i | mu_i, s^2) - var_i / (2 s^2)]
    - KL(N(v, C C^T) || N(0, I))."""
    mu, var = _predictive_qf(spec, params, buffers, x_batch)
    noise = noise_value(params)
    b = x_batch.shape[0]
    lik = -0.5 * (LOG_2PI + torch.log(noise) + (y_batch - mu) ** 2 / noise)
    lik = lik - 0.5 * var / noise
    C = _var_chol(params)
    vm = params["var_mean"]
    kl = 0.5 * (torch.sum(C * C) + vm @ vm - vm.shape[0]
                - 2.0 * torch.sum(torch.log(torch.diagonal(C))))
    return (n_total / b) * torch.sum(lik) - kl


@torch.no_grad()
def svgp_predict(spec: ModelSpec, params, buffers, x_test,
                 observation_noise: bool = True):
    """Predictive marginals (mean, var) at x_test, with the likelihood's
    noise unless asked not to."""
    mu, var = _predictive_qf(spec, params, buffers, x_test)
    if observation_noise:
        var = var + noise_value(params)
    return mu, var


@dataclasses.dataclass
class SVGPTrainResult:
    params: dict
    losses: list


def _epoch(spec: ModelSpec, params, buffers, opt, xs, ys, n: int):
    """Adam steps on -ELBO / n over the batches xs (steps, b, D), ys
    (steps, b); params' leaves are opt's. Returns the steps' mean loss, on
    the device."""
    total = torch.zeros((), device=xs.device)
    for xb, yb in zip(xs, ys):
        opt.zero_grad(set_to_none=True)
        loss = -elbo(spec, params, buffers, xb, yb, n) / n
        loss.backward()
        opt.step()
        total = total + loss.detach()
    return total / xs.shape[0]


def train_svgp(spec: ModelSpec, params, buffers, x, y, generator=None,
               batch_size: int = 1024, num_epochs: int = 50, lr: float = 0.01):
    """Minibatch Adam on -ELBO (the JAX package's train_svgp): each epoch
    shuffles with one torch.randperm from `generator` (a generator on x's
    device) and takes n // batch_size steps of batch_size points (the rest
    of the shuffle is dropped), reading its mean loss to the host once.
    params: copied; the caller's are not modified."""
    n = x.shape[0]
    b = min(batch_size, n)
    steps = max(1, n // b)
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params)
    opt = torch.optim.Adam(_leaves(params), lr=lr)
    losses = []
    for _ in range(num_epochs):
        perm = torch.randperm(n, generator=generator, device=x.device)
        take = perm[:steps * b]
        loss = _epoch(spec, params, buffers, opt,
                      x[take].reshape(steps, b, -1), y[take].reshape(steps, b),
                      n)
        losses.append(float(loss))
    return SVGPTrainResult(params=_tree_map(lambda t: t.detach(), params),
                           losses=losses)


def train_svgp_distributed(spec: ModelSpec, params, buffers, x, y, mesh,
                           generator=None, batch_size: int = 1024,
                           num_epochs: int = 50, lr: float = 0.01):
    """train_svgp with each minibatch's rows sharded over the mesh's data
    axis (parallel/sharding.make_distributed_svgp_epoch): the M-sized
    variational state replicates, the ELBO's likelihood rows shard. x, y:
    the full training set, the same on every rank; `generator` must be
    seeded alike on every rank, and then the permutations are
    train_svgp's for the same generator, so the trajectories agree to
    summation-order roundoff. The batch is trimmed to a multiple of the
    data axis."""
    from ..parallel import sharding

    n = x.shape[0]
    b = min(batch_size, n)
    b -= b % mesh.data
    if b <= 0:
        raise ValueError(f"batch_size {batch_size} < data axis {mesh.data}")
    steps = max(1, n // b)
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params)
    opt = torch.optim.Adam(_leaves(params), lr=lr)
    epoch = sharding.make_distributed_svgp_epoch(spec, mesh, opt, n_total=n,
                                                 steps=steps, batch=b)
    losses = [float(epoch(params, buffers, x, y, generator))
              for _ in range(num_epochs)]
    return SVGPTrainResult(params=_tree_map(lambda t: t.detach(), params),
                           losses=losses)
