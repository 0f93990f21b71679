"""The check of the SKI + BBMM exact GP (a configuration's "reference":
"ski_bbmm"), against gpbench/reference/ski_bbmm.py, a plain float64 SKI
+ BBMM estimate worked out again from x, y, the projection and the probe
normals. Its contract is harness.py's:

  recorder(unit)  FirstMVM: entered around set-up's recorded call, it
                  keeps the first SKI MVM of the points with themselves
                  that the program computes, input V and product K V, by
                  a wrapper around the name rpagp_torch.ops.ski.ski_mvm
                  that the step calls; it changes no work
  judged(unit)    the points' grid coordinates (tfrac), taken at
                  release() before the program's state is dropped
  compare(unit, control=None)
                  the numbers of reference/check.py: loss, grad, change,
                  change_worst, tfrac, mvm
  leaves(unit)    the last comparison's per-leaf look (readings.py)
"""

from __future__ import annotations

from gpbench.reference import check


class FirstMVM:
    """While entered, keeps the first SKI MVM of the points with
    themselves (K V) that the program computes: V and K V, (n, t), held
    on the host once the call is over, so that the window's device peak
    is the program's alone."""

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
        if exc[0] is None:
            if self.V is None:
                raise RuntimeError("the recorded call made no SKI MVM: "
                                   "the ski_bbmm check needs one")
            self.V, self.KV = self.V.cpu(), self.KV.cpu()
        return False


def recorder(unit):
    return FirstMVM()


def judged(unit) -> dict:
    return {"tfrac": unit.buffers["ski_state"].tfrac}


def compare(unit, control: str | None = None) -> dict:
    """The compared numbers: the program's, or with `control` a
    precision, those of the reference computed in it and put in the
    program's place. The reference's MVM is applied to the program's V,
    which it judges as an input, as a served model's tokens are."""
    from gpbench.reference import common, ski_bbmm

    spec = unit.spec
    m, J = spec.kernel.grid_size, spec.kernel.J
    lr, seed = unit.exp.train.lr, unit.seed + 1
    x, y = unit.x, unit.y
    V, KV = (check.rows(a, unit.n_train).to(x.device)
             for a in (unit.recorded.V, unit.recorded.KV))

    def steps(dtype):
        op = ski_bbmm.Operator(x, unit.proj, m, dtype)
        p0 = common.zero_params(J, dtype, x.device)
        kv = op.kernel_mvm(p0, V.to(dtype))
        return (_bbmm_steps(op, y, p0, spec, lr, seed,
                            len(unit.record["losses"])), op.t.T, kv)

    with common.precision("f64") as f64:
        ref, t_ref, kv_ref = steps(f64)
    if control is None:
        got, tfrac, kv = unit.record, unit.judged["tfrac"], KV
        unit.looked = (got, ref)
    else:
        with common.precision(control) as lo:
            got, tfrac, kv = steps(lo)
    out = check.training(got, ref)
    out["tfrac"] = check.widest(tfrac, t_ref)
    out["mvm"] = check.columns(kv, kv_ref)
    return out


def leaves(unit) -> dict:
    """Per leaf of the last program comparison: the program's and the
    reference's first-gradient norms, and the norms of their changes
    over the checked steps."""
    got, ref = unit.looked
    look = {}
    for k in check.LEAVES:
        dp = (got["end"][k] - got["start"][k]).double().cpu()
        dr = (ref["end"][k] - ref["start"][k]).double().cpu()
        look[k] = [float(got["grad"][k].double().norm()),
                   float(ref["grad"][k].double().norm()),
                   float(dp.norm()), float(dr.norm())]
    return look


def _bbmm_steps(op, y, p0, spec, lr, seed, n_steps) -> dict:
    """The reference's first steps on the SKI + BBMM estimate, each on the
    probe normals the program's step drew."""
    from gpbench.reference import common, ski_bbmm

    normals = ski_bbmm.probe_normals(seed, op.n, spec.precond_rank,
                                     spec.num_probes, n_steps, y.device)
    steps = [lambda p, e=e: ski_bbmm.loss_and_grad(
        op, p, y, *e, spec.precond_rank, spec.cg_max_iters, spec.cg_tol)
        for e in normals]
    losses, grad, end = common.adam_steps(p0, lr, steps)
    return {"losses": losses, "grad": grad, "start": p0, "end": end}
