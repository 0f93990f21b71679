"""The general traffic generator: reads a mix (gpbench/traffic/<mix>.json)
and drives the program with it, one closed loop, each unit after the
last. The unit:

  "train_call"  one rpagp_torch.train.train_to_convergence call of the
                spec's max_iters steps on rpagp_torch.mll.mll, with the
                loss closure, sync_every, probe generator and
                preconditioner refresh that runner.run_split passes, on
                caches that set-up prepared once; every call starts from
                the same initial hyperparameters.

The mix's keys: "unit", "fold" (the fold whose training rows the calls
fit), "warmup_steps" (the steps of set-up's recorded call),
"trace_units" (calls under the profiler), "sync_every".

What the check compares is recorded in set-up's call, which goes
through the window's own call and feed: its first three steps (the
trainer's grad_hook) and the first SKI MVM of its first step, input and
product (a wrapper around the name rpagp_torch.ops.ski.ski_mvm that the
step calls). Neither changes the work.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpbench.reference import check, data

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


class FirstMVM:
    """While entered, keeps the first SKI MVM of the points with
    themselves (K V) that the program computes: V and K V, (n, t)."""

    def __enter__(self):
        from rpagp_torch.ops import ski

        self.mod, self.orig = ski, ski.ski_mvm
        self.V = self.KV = None

        def mvm(spec, kparams, state, V, state_rhs=None):
            out = self.orig(spec, kparams, state, V, state_rhs=state_rhs)
            if self.V is None and (state_rhs is None or state_rhs is state):
                self.V, self.KV = V.detach().clone(), out.detach().clone()
            return out

        ski.ski_mvm = mvm
        return self

    def __exit__(self, *exc):
        self.mod.ski_mvm = self.orig
        return False


def _with_iters(exp, iters: int):
    tr = dataclasses.replace(exp.train, max_iters=iters, patience=iters)
    return dataclasses.replace(exp, train=tr)


def _leaf_look(got, ref) -> dict:
    """Per leaf: the program's and the reference's first-gradient norms,
    and the norms of their changes over the checked steps."""
    look = {}
    for k in check.LEAVES:
        dp = (got["end"][k] - got["start"][k]).double().cpu()
        dr = (ref["end"][k] - ref["start"][k]).double().cpu()
        look[k] = [float(got["grad"][k].double().norm()),
                   float(ref["grad"][k].double().norm()),
                   float(dp.norm()), float(dr.norm())]
    return look


class TrainCalls:
    """Unit: one trainer call of the spec's max_iters steps."""

    def __init__(self, cfg, mix, seed: int, device):
        from rpagp_torch.utils.config import experiment_spec_from_dict

        self.cfg, self.mix, self.seed = cfg, mix, seed
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
        with FirstMVM() as mvm:
            res = self._call(_with_iters(self.exp, self.mix["warmup_steps"]),
                             grad_hook=rec)
        self.record = rec.record(res.losses)
        # held on the host, so that the window's device peak is the
        # program's alone
        self.mvm = (mvm.V.cpu(), mvm.KV.cpu())

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
        self.judged = {"tfrac": self.buffers["ski_state"].tfrac}
        self.buffers = self.params = self.loss = self.refresh = None

    def check(self, control: str | None = None) -> dict:
        """The compared numbers: the program's, or with `control` a
        precision, those of the reference computed in it and put in the
        program's place. The reference's MVM is applied to the program's
        V, which it judges as an input, as a served model's tokens are."""
        from gpbench.reference import common, ski_bbmm

        spec, m, J = self.spec, self.spec.kernel.grid_size, self.spec.kernel.J
        lr, seed = self.exp.train.lr, self.seed + 1
        V, KV = (check.rows(a, self.n_train).to(self.x.device)
                 for a in self.mvm)

        def steps(dtype):
            op = ski_bbmm.Operator(self.x, self.proj, m, dtype)
            p0 = common.zero_params(J, dtype, self.x.device)
            kv = op.kernel_mvm(p0, V.to(dtype))
            return _bbmm_steps(op, self.y, p0, spec, lr, seed), op.t.T, kv

        with common.precision("f64") as f64:
            ref, t_ref, kv_ref = steps(f64)
        if control is None:
            got, tfrac, kv = self.record, self.judged["tfrac"], KV
            self._steps = (got, ref)
        else:
            with common.precision(control) as lo:
                got, tfrac, kv = steps(lo)
        out = check.training(got, ref)
        out["tfrac"] = check.widest(tfrac, t_ref)
        out["mvm"] = check.columns(kv, kv_ref)
        return out

    def leaves(self) -> dict:
        """The last program check's per-leaf look (_leaf_look)."""
        return _leaf_look(*self._steps)


def _bbmm_steps(op, y, p0, spec, lr, seed) -> dict:
    """The reference's first steps on the SKI + BBMM estimate, each on the
    probe normals the program's step drew."""
    from gpbench.reference import common, ski_bbmm

    normals = ski_bbmm.probe_normals(seed, op.n, spec.precond_rank,
                                     spec.num_probes, CHECKED_STEPS,
                                     y.device)
    steps = [lambda p, e=e: ski_bbmm.loss_and_grad(
        op, p, y, *e, spec.precond_rank, spec.cg_max_iters, spec.cg_tol)
        for e in normals]
    losses, grad, end = common.adam_steps(p0, lr, steps)
    return {"losses": losses, "grad": grad, "start": p0, "end": end}


KINDS = {"train_call": TrainCalls}


def make(cfg, mix, seed: int, device):
    return KINDS[mix["unit"]](cfg, mix, seed, device)
