"""A check module for the dense exact GP (a configuration's "reference":
"exact_dense"), which test_gpbench_discovery.py adds to a copy of the
benchmark as a new file under gpbench/checks/. It follows harness.py's
contract: no recorder of its own, nothing judged of the program's state,
and compare() holds the program's first steps (the unit's `record`)
against a float64 exact marginal likelihood worked out again from x, y
and the projection: the Gram matrix of the degree-1 RBF projection
kernel, a Cholesky solve, the gradients by autograd, and Adam's steps.
It imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from gpbench.reference import check, common

# the model's diagonal jitter (rpagp_torch's ModelSpec default)
JITTER = 1e-6


def recorder(unit):
    return contextlib.nullcontext()


def judged(unit) -> dict:
    return {}


def _loss(p, z, y):
    """-mll / n of the exact GP at raw hyperparameters p."""
    n, J = z.shape
    ls = F.softplus(p["raw_lengthscale"])
    scale = F.softplus(p["raw_outputscale"]) / J
    noise = F.softplus(p["raw_noise"]) + common.NOISE_FLOOR
    u = z / ls
    d2 = (u[:, None, :] - u[None, :, :]) ** 2
    K = scale * torch.exp(-0.5 * d2).sum(-1)
    K = K + (noise + JITTER) * torch.eye(n, dtype=z.dtype, device=z.device)
    L = torch.linalg.cholesky(K)
    yc = y - p["mean_const"]
    alpha = torch.cholesky_solve(yc[:, None], L)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return 0.5 * (yc @ alpha + logdet + n * common.LOG_2PI) / n


def _steps(unit, dtype) -> dict:
    z = common.project(unit.x, unit.proj, dtype)
    y = unit.y.to(dtype)

    def step(p):
        q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        loss = _loss(q, z, y)
        grads = torch.autograd.grad(loss, list(q.values()))
        return loss.detach(), dict(zip(q, grads))

    p0 = common.zero_params(z.shape[1], dtype, z.device)
    n_steps = len(unit.record["losses"])
    losses, grad, end = common.adam_steps(p0, unit.exp.train.lr,
                                          [step] * n_steps)
    return {"losses": losses, "grad": grad, "start": p0, "end": end}


def compare(unit, control: str | None = None) -> dict:
    """loss, grad, change, change_worst of reference/check.py: the
    program's, or with `control` a precision, those of the reference
    computed in it in the program's place."""
    with common.precision("f64") as f64:
        ref = _steps(unit, f64)
    if control is None:
        got = unit.record
    else:
        with common.precision(control) as lo:
            got = _steps(unit, lo)
    return check.training(got, ref)
