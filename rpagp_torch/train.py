"""Hyperparameter training: Adam on the negative marginal log-likelihood
(port of rpagp/train.py: TrainResult, ConvergenceTracker,
train_to_convergence and train_fixed).

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

_EMA_DECAY = 0.8  # the stochastic tracker's EMA (rpagp/train.py:199)


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
    # calls of args_refresh's function (the BBMM path's cached-
    # preconditioner rebuilds)
    refreshes: int = 0


@dataclasses.dataclass
class ConvergenceTracker:
    """Best-loss patience stopping. stochastic=True compares an EMA of the
    loss (the BBMM loss is noisy: probes are drawn anew every step); the
    deterministic grid solver compares the raw loss."""

    patience: int
    rel_tol: float
    stochastic: bool = False
    best: float = float("inf")
    best_params: object = None
    bad: int = 0
    _ema: float | None = None

    def update(self, loss: float, params) -> bool:
        """Record one step's loss; returns True when patience is exhausted."""
        crit = loss
        if self.stochastic:
            self._ema = (loss if self._ema is None
                         else _EMA_DECAY * self._ema
                         + (1.0 - _EMA_DECAY) * loss)
            crit = self._ema
        # best == inf guard: inf - rel_tol*inf is nan
        if self.best == float("inf") or \
                crit < self.best - self.rel_tol * max(1.0, abs(self.best)):
            self.best, self.best_params, self.bad = crit, params, 0
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
    generator=None,
    args_refresh=None,
) -> TrainResult:
    """Adam to convergence with patience stopping on the best loss seen:
    stop when the loss has not improved by `rel_tol` for `patience`
    consecutive steps, or at `max_iters` (all three from train_config,
    with the optimizer and LR schedule, utils.config.make_optimizer).

    loss_fn(params, *loss_args) -> 0-d tensor; with a `generator` (a
    torch.Generator), loss_fn(params, *loss_args, generator), which draws
    fresh probes from it every step, and patience runs on an EMA of the
    noisy loss. params: dict tree of
    tensors (copied; the caller's are not modified). sync_every: read
    losses from the device every k steps; the parameter trajectory is the
    same for any k, only stop detection lags (up to k-1 extra steps run
    and are discarded). Each loss is paired with the params it was
    evaluated at.

    args_refresh: optional (every, fn): before step i, for i > 0 a multiple
    of `every`, loss_args = fn(params, loss_args), outside autograd (the
    BBMM path rebuilds its cached preconditioner so, spec.precond_refresh;
    the call reads nothing back to the host)."""
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params)
    opt, sched = make_optimizer(train_config, _leaves(params))
    tracker = ConvergenceTracker(patience=train_config.patience,
                                 rel_tol=train_config.rel_tol,
                                 stochastic=generator is not None,
                                 best_params=params)
    extra = () if generator is None else (generator,)
    max_iters = train_config.max_iters
    losses = []
    t0 = time.perf_counter()
    converged = diverged = False
    pending = []  # (device loss, params it was evaluated at)
    refreshes = 0
    for i in range(max_iters):
        if args_refresh is not None and i > 0 and i % args_refresh[0] == 0:
            with torch.no_grad():
                loss_args = args_refresh[1](params, loss_args)
            refreshes += 1
        pprev = _tree_map(lambda t: t.detach().clone(), params)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, *loss_args, *extra)
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
                   else float("nan")), refreshes=refreshes)


def train_fixed(loss_fn: Callable, params, lr: float = 0.1,
                num_iters: int = 100):
    """`num_iters` Adam steps at `lr` with no host read: returns (params,
    losses), the params after the last step and the (num_iters,) losses,
    each at the params its step started from, left on the device."""
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params)
    opt = torch.optim.Adam(_leaves(params), lr=lr)
    losses = []
    for _ in range(num_iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return _tree_map(lambda t: t.detach(), params), torch.stack(losses)
