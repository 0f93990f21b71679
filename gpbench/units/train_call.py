"""Unit "train_call": one rpagp_torch.train.train_to_convergence call of
the spec's max_iters steps on rpagp_torch.mll.mll, with the loss closure,
sync_every, probe generator and preconditioner refresh that
runner.run_split passes, on caches that set-up prepared once; every call
starts from the same initial hyperparameters. The exact GP's training
call on whichever path the program's own dispatch takes for the spec and
n (dense Cholesky, grid solver, BBMM, SKI + BBMM).

The mix's keys: "fold" (the fold whose training rows the calls fit),
"warmup_steps" (the steps of set-up's recorded call), "trace_units"
(calls under the profiler), "sync_every".

What the check compares is recorded in set-up's call, which goes
through the window's own call and feed: its first CHECKED_STEPS steps
(the trainer's grad_hook, kept as `record`) and what the check's
recorder keeps (`recorded`). Neither changes the work.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpbench.reference import data

CHECKED_STEPS = 3


def _leaf_names(tree):
    """Leaf names in the order the trainer hands its grad_hook the leaves
    (sorted keys, depth first), last path component only."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _leaf_names(tree[k])
        else:
            out.append(k)
    return out


class StepRecorder:
    """grad_hook for train_to_convergence: keeps the start params and the
    first gradient (step 0), and the params after CHECKED_STEPS updates
    (the hook of step CHECKED_STEPS sees them before its update)."""

    def __init__(self, params):
        self.names = _leaf_names(params)
        self.step = 0
        self.start = self.grad = self.end = None

    def __call__(self, leaves):
        if self.step == 0:
            self.start = {n: t.detach().clone()
                          for n, t in zip(self.names, leaves)}
            self.grad = {n: t.grad.detach().clone()
                         for n, t in zip(self.names, leaves)}
        elif self.step == CHECKED_STEPS:
            self.end = {n: t.detach().clone()
                        for n, t in zip(self.names, leaves)}
        self.step += 1

    def record(self, losses) -> dict:
        if self.end is None or len(losses) < CHECKED_STEPS:
            raise RuntimeError(f"the recorded call ran {self.step} steps; "
                               f"the check needs {CHECKED_STEPS + 1}")
        return {"losses": list(losses[:CHECKED_STEPS]), "grad": self.grad,
                "start": self.start, "end": self.end}


def _with_iters(exp, iters: int):
    tr = dataclasses.replace(exp.train, max_iters=iters, patience=iters)
    return dataclasses.replace(exp, train=tr)


class Unit:
    """One trainer call of the spec's max_iters steps."""

    def __init__(self, cfg, mix, seed: int, device, checks):
        from rpagp_torch.utils.config import experiment_spec_from_dict

        self.cfg, self.mix, self.seed, self.checks = cfg, mix, seed, checks
        self.device = torch.device(device)
        self.exp = experiment_spec_from_dict(cfg, name=cfg["name"])
        self.spec = self.exp.model

    def setup(self):
        from rpagp_torch.mll import mll as mll_fn
        from rpagp_torch.models import exact_gp
        from rpagp_torch.ops import grid_solve
        from rpagp_torch.train import train_to_convergence

        self._train = train_to_convergence
        d = self.cfg["data"]
        X, y = data.synthetic(d["n"], d["d"], self.seed, self.device)
        idx = data.fold_indices(d["n"], d["folds"], self.seed, self.device)
        s = data.zscored_split(X, y, *idx[self.mix["fold"]])
        del X, y
        self.x, self.y = s["train_x"], s["train_y"]
        spec, n, dim = self.spec, self.x.shape[0], self.x.shape[1]
        self.n_train = n
        self.proj = data.gaussian_projection(dim, spec.kernel.J, self.seed)
        self.params, buffers = exact_gp.init_model(spec, dim, proj=self.proj,
                                                   device=self.device)
        self.buffers = exact_gp.prepare_buffers(spec, self.params, buffers,
                                                self.x, y_train=self.y)
        self.loss = lambda p, b, xx, yy, *g: -mll_fn(spec, p, b, xx, yy,
                                                     *g) / n
        # the probe generator and the preconditioner refresh, as run_split
        grid = grid_solve.use_grid_solver(spec, n)
        iterative = (n > spec.max_cholesky_size or spec.kernel.ski) \
            and not grid
        self.gen = self.refresh = None
        if iterative:
            self.gen = torch.Generator(device=self.device).manual_seed(
                self.seed + 1)
            if spec.precond_refresh > 1 and spec.precond_rank > 0:
                self.refresh = (spec.precond_refresh, lambda p, a: (
                    exact_gp.refresh_preconditioner(spec, p, a[0], a[1]),)
                    + a[1:])
        rec = StepRecorder(self.params)
        with self.checks.recorder(self) as self.recorded:
            res = self._call(_with_iters(self.exp, self.mix["warmup_steps"]),
                             grad_hook=rec)
        self.record = rec.record(res.losses)

    def _call(self, exp, grad_hook=None):
        return self._train(self.loss, self.params, exp.train,
                           loss_args=(self.buffers, self.x, self.y),
                           sync_every=self.mix["sync_every"],
                           generator=self.gen, args_refresh=self.refresh,
                           grad_hook=grad_hook)

    def unit(self, i: int) -> dict:
        res = self._call(self.exp)
        return {"steps": res.iterations,
                "ok": all(math.isfinite(v) for v in res.losses)}

    def traced_unit(self) -> dict:
        """mix["trace_units"] calls, as the window makes them."""
        outs = [self.unit(i) for i in range(self.mix["trace_units"])]
        return {"steps": sum(o["steps"] for o in outs), "units": len(outs),
                "ok": all(o["ok"] for o in outs)}

    def release(self):
        """Drop the program's state but what the check judges."""
        self.judged = self.checks.judged(self)
        self.buffers = self.params = self.loss = self.refresh = None
