"""Hyperparameter training: Adam on the negative marginal log-likelihood
(port of rpagp/train.py: TrainResult, ConvergenceTracker,
train_to_convergence with its step-0 stall warning,
train_with_checkpointing and train_fixed).

The loss stays on the device: losses are read in chunks of `sync_every`
steps with one torch.stack(...).tolist() per chunk, never a float() per
step (a per-step read stalls the device queue; in the JAX package it
doubled the training loop). train_with_checkpointing reads every step's
loss, as the JAX package's does. Each step runs in an `rpagp.train.step`
span holding its refresh, loss, backward and update spans, and each host
read in an `rpagp.sync` span (utils/profiling.py: open only while a
profiler records).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from .utils.checkpoint import Checkpointer, load_checkpoint
from .utils.config import TrainConfig, make_optimizer
from .utils.profiling import span

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


def _warn_if_frozen(params_prev, params):
    """Zero-gradient stall detection. An Adam step moves every parameter
    with a nonzero gradient by ~lr whatever the gradient's scale, so
    params bitwise unchanged after the first step mean the gradient was
    exactly zero; with the iterative MLL that is CG returning its zero
    start (ops/cg.py). One host read for all leaves together."""
    moved = torch.stack([torch.any(a != b) for a, b in
                         zip(_leaves(params_prev), _leaves(params))]).any()
    with span("rpagp.sync"):
        moved = bool(moved)
    if not moved:
        print(
            "[warn] training stalled at step 0: the optimizer step changed "
            "no parameter (gradient exactly zero). With the iterative MLL "
            "this means CG made no progress on the initial system — enable "
            "preconditioning (spec.precond_rank ~ 15) or raise "
            "cg_max_iters.",
            file=sys.stderr,
        )


def train_to_convergence(
    loss_fn: Callable,
    params,
    train_config: TrainConfig,
    loss_args=(),
    sync_every: int = 1,
    generator=None,
    args_refresh=None,
    grad_hook=None,
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
    the call reads nothing back to the host).

    After step 0 (only), one host read checks that some parameter moved,
    and a `[warn] training stalled at step 0` line goes to stderr if none
    did (_warn_if_frozen).

    grad_hook: optional fn(leaves), run after each backward and before the
    optimizer step (the parallel path's gradient assembly,
    parallel/sharding.make_distributed_loss)."""
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
        with span("rpagp.train.step"):
            if args_refresh is not None and i > 0 \
                    and i % args_refresh[0] == 0:
                with torch.no_grad(), span("rpagp.train.refresh"):
                    loss_args = args_refresh[1](params, loss_args)
                refreshes += 1
            pprev = _tree_map(lambda t: t.detach().clone(), params)
            opt.zero_grad(set_to_none=True)
            with span("rpagp.train.loss"):
                loss = loss_fn(params, *loss_args, *extra)
            with span("rpagp.train.backward"):
                loss.backward()
                if grad_hook is not None:
                    grad_hook(_leaves(params))
            with span("rpagp.train.update"):
                opt.step()
                sched.step()
            if i == 0:
                _warn_if_frozen(pprev, params)
            pending.append((loss.detach(), pprev))
            if len(pending) < sync_every and i < max_iters - 1:
                continue  # keep the device queue full
            with span("rpagp.sync"):
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


_ADAM_SLOTS = ("exp_avg", "exp_avg_sq", "step")


def _adam_state(opt, params):
    """Adam's per-parameter state as dict trees shaped like `params`, one
    per slot (zeros and a 0 step before the first step, as Adam starts)."""
    def slot(p, name):
        if opt.state.get(p):
            return opt.state[p][name]
        return torch.tensor(0.0) if name == "step" else torch.zeros_like(p)

    return {name: _tree_map(lambda p: slot(p, name), params)
            for name in _ADAM_SLOTS}


def set_adam_state(opt, params, state):
    """Install the opt_state of a checkpoint (checkpoint_state) into `opt`,
    an Adam over `params`' leaves."""
    for p, *vals in zip(_leaves(params),
                        *(_leaves(state[name]) for name in _ADAM_SLOTS)):
        opt.state[p] = dict(zip(_ADAM_SLOTS, vals))


def checkpoint_state(params, opt, generator, step: int,
                     tracker: ConvergenceTracker) -> dict:
    """What a train_with_checkpointing checkpoint holds, as a dict tree of
    tensors: params, the tracker's best params / best / bad / EMA, Adam's
    exp_avg / exp_avg_sq / step (opt over params' leaves), the generator's
    state (an empty byte tensor without one) and the step counter. Also the
    `like` that utils.checkpoint.load_checkpoint reads one back with."""
    return {
        "params": params,
        "best_params": tracker.best_params,
        "opt_state": _adam_state(opt, params),
        "generator": (torch.zeros(0, dtype=torch.uint8) if generator is None
                      else generator.get_state()),
        "step": torch.tensor(step),
        "best": torch.tensor(tracker.best, dtype=torch.float64),
        "bad": torch.tensor(tracker.bad),
        "ema": torch.tensor(math.nan if tracker._ema is None
                            else tracker._ema, dtype=torch.float64),
    }


def train_with_checkpointing(
    loss_fn: Callable,
    params,
    checkpoint_dir: str,
    lr: float = 0.1,
    max_iters: int = 1000,
    patience: int = 20,
    rel_tol: float = 1e-6,
    checkpoint_every: int = 100,
    keep: int = 3,
    generator=None,
    loss_args=(),
    resume: bool = True,
) -> TrainResult:
    """`train_to_convergence` with periodic checkpoints and resume, under
    the same convergence contract (patience on the best loss, an EMA of
    it with a generator; the best params returned), at a constant `lr`
    with plain Adam, as the JAX package's train_with_checkpointing.

    Every `checkpoint_every` steps a checkpoint under `checkpoint_dir`
    (utils.checkpoint.Checkpointer, the last `keep` kept) carries the
    params, the best params, Adam's exp_avg / exp_avg_sq / step, the
    generator's state, the step counter and the tracker's best / bad /
    EMA, and losses.npy the loss history. With `resume`, a run starts
    from the newest checkpoint there: it continues the patience count and,
    with a generator (loss_fn(params, *loss_args, generator)), draws what
    an uninterrupted run would. `losses` then spans every segment, while
    `iterations` counts this call's steps. The loss is read to the host
    every step."""
    params = _tree_map(lambda t: t.detach().clone(), params)
    stochastic = generator is not None
    tracker = ConvergenceTracker(patience=patience, rel_tol=rel_tol,
                                 stochastic=stochastic,
                                 best_params=_tree_map(torch.clone, params))
    opt = torch.optim.Adam(_leaves(params), lr=lr)
    cp = Checkpointer(checkpoint_dir, every=checkpoint_every, keep=keep)
    losses_path = os.path.join(checkpoint_dir, "losses.npy")
    start = 0
    losses: list = []
    latest = cp.latest() if resume else None
    if latest is not None:
        state = load_checkpoint(latest, checkpoint_state(
            params, opt, generator, 0, tracker))
        start = int(state["step"])
        if os.path.exists(losses_path):
            losses = np.load(losses_path)[:start].tolist()
        if stochastic:
            generator.set_state(state["generator"])
        params = state["params"]
        opt = torch.optim.Adam(_leaves(params), lr=lr)
        set_adam_state(opt, params, state["opt_state"])
        tracker.best_params = state["best_params"]
        tracker.best, tracker.bad = float(state["best"]), int(state["bad"])
        ema = float(state["ema"])
        tracker._ema = None if math.isnan(ema) else ema
    for t in _leaves(params):
        t.requires_grad_(True)
    extra = (generator,) if stochastic else ()

    def save(step):
        path = cp.maybe_save(step, checkpoint_state(params, opt, generator,
                                                    step, tracker))
        if path is not None:
            np.save(losses_path, np.asarray(losses, dtype=np.float64))

    t0 = time.perf_counter()
    converged = False
    for i in range(start, max_iters):
        with span("rpagp.train.step"):
            pprev = _tree_map(lambda t: t.detach().clone(), params)
            opt.zero_grad(set_to_none=True)
            with span("rpagp.train.loss"):
                loss = loss_fn(params, *loss_args, *extra)
            with span("rpagp.train.backward"):
                loss.backward()
            with span("rpagp.train.update"):
                opt.step()
            with span("rpagp.sync"):
                lf = float(loss.detach())
            losses.append(lf)
            if not math.isfinite(lf):
                break
            # pair the loss with the params it was evaluated at
            converged = tracker.update(lf, pprev)
            save(i + 1)
            if converged:
                break
    return TrainResult(
        params=_tree_map(lambda t: t.detach(), tracker.best_params),
        losses=losses, iterations=len(losses) - start, converged=converged,
        wall_time_s=time.perf_counter() - t0,
        best_loss=(tracker.best if tracker.best != float("inf")
                   else float("nan")))


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
        with span("rpagp.train.step"):
            opt.zero_grad(set_to_none=True)
            with span("rpagp.train.loss"):
                loss = loss_fn(params)
            with span("rpagp.train.backward"):
                loss.backward()
            with span("rpagp.train.update"):
                opt.step()
            losses.append(loss.detach())
    return _tree_map(lambda t: t.detach(), params), torch.stack(losses)
