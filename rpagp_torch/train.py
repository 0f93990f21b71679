"""Hyperparameter training: Adam on the negative marginal log-likelihood
(port of rpagp/train.py: TrainResult, ConvergenceTracker and
train_to_convergence).

The loss stays on the device: losses are read in chunks of `sync_every`
steps with one torch.stack(...).tolist() per chunk, never a float() per
step (a per-step read stalls the device queue; in the JAX package it
doubled the training loop).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from .utils.config import TrainConfig, make_optimizer


@dataclasses.dataclass
class TrainResult:
    params: dict
    losses: list
    iterations: int
    converged: bool
    wall_time_s: float
    # objective at the RETURNED (best) params; losses[-1] is the last
    # iterate's loss
    best_loss: float = float("nan")


@dataclasses.dataclass
class ConvergenceTracker:
    """Best-loss patience stopping on the raw loss (the grid solver is
    deterministic; the JAX package's EMA smoothing serves only its
    stochastic BBMM path, ROADMAP slice 10)."""

    patience: int
    rel_tol: float
    best: float = float("inf")
    best_params: object = None
    bad: int = 0

    def update(self, loss: float, params) -> bool:
        """Record one step's loss; returns True when patience is exhausted."""
        # best == inf guard: inf - rel_tol*inf is nan
        if self.best == float("inf") or \
                loss < self.best - self.rel_tol * max(1.0, abs(self.best)):
            self.best, self.best_params, self.bad = loss, params, 0
            return False
        self.bad += 1
        return self.bad >= self.patience


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def train_to_convergence(
    loss_fn: Callable,
    params,
    train_config: TrainConfig,
    loss_args=(),
    sync_every: int = 1,
) -> TrainResult:
    """Adam to convergence with patience stopping on the best loss seen:
    stop when the loss has not improved by `rel_tol` for `patience`
    consecutive steps, or at `max_iters` (all three from train_config,
    with the optimizer and LR schedule, utils.config.make_optimizer).

    loss_fn(params, *loss_args) -> 0-d tensor. params: dict tree of
    tensors (copied; the caller's are not modified). sync_every: read
    losses from the device every k steps; the parameter trajectory is the
    same for any k, only stop detection lags (up to k-1 extra steps run
    and are discarded). Each loss is paired with the params it was
    evaluated at."""
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params)
    opt, sched = make_optimizer(train_config, _leaves(params))
    tracker = ConvergenceTracker(patience=train_config.patience,
                                 rel_tol=train_config.rel_tol,
                                 best_params=params)
    max_iters = train_config.max_iters
    losses = []
    t0 = time.perf_counter()
    converged = diverged = False
    pending = []  # (device loss, params it was evaluated at)
    for i in range(max_iters):
        pprev = _tree_map(lambda t: t.detach().clone(), params)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, *loss_args)
        loss.backward()
        opt.step()
        sched.step()
        pending.append((loss.detach(), pprev))
        if len(pending) < sync_every and i < max_iters - 1:
            continue  # keep the device queue full
        chunk = torch.stack([dl for dl, _ in pending]).tolist()
        for lf, (_, pp) in zip(chunk, pending):
            losses.append(lf)
            if not math.isfinite(lf):
                diverged = True  # return the best params seen
                break
            if tracker.update(lf, pp):
                converged = True
                break
        pending.clear()
        if converged or diverged:
            break
    best = _tree_map(lambda t: t.detach(), tracker.best_params)
    return TrainResult(
        params=best, losses=losses, iterations=len(losses),
        converged=converged, wall_time_s=time.perf_counter() - t0,
        best_loss=(tracker.best if tracker.best != float("inf")
                   else float("nan")))
