"""The flagship spec's batched PCG in the JAX package and in the port, on
one operator, one preconditioner and one right-hand side, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_cg_zero_start_probe.py \
        --n 25000 100000 [--noise 0.0913]

For each n: synthetic HouseElectric (the loader's deterministic subsample
of ceil(n / 0.9) + 1 rows, the train fold of split 0 cut to n rows), the
spec `specs/rp_ski_houseelectric_j20.json` with solver "bbmm" at the JAX
package's initial params (key 0), and:

  - the SKI geometry of each package (tfrac compared);
  - the JAX package's rank-15 preconditioner, handed to the port (the
    port's own build is compared with it);
  - B = [y - mean, L e_s + sqrt(noise) e_b] from numpy normals (seed 1),
    the forward's right-hand sides;
  - `rpagp.ops.cg.batched_pcg` and `rpagp_torch.ops.cg.batched_pcg`, each
    with its own package's SKI operator, for the spec's cg_max_iters.

Prints one JSON line a n: each package's best relative
residual a column (the value `batched_pcg` returns: 1.0 exactly when no
iterate beat the zero start), whether each returned the zero start for
y's column, the relative gap between the two packages' solutions, y's
column's preconditioned residual a iteration from each package's CG
coefficients (sqrt(r_k^T M^-1 r_k / r_0^T M^-1 r_0) = the square root of
the product of its betas), and the seconds each package's CG took. As a
probe of rounding: the port's CG again on B (1 + 2^-20), the same system
in exact arithmetic (CG is invariant to the scale of its right-hand
side), its best relative residual for y's column.
--threads sets the port's CPU threads. --noise sets the likelihood noise
in place of the initial 0.693 (0.0913 is where 20 training steps took
the flagship on the card).
"""
import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPEC = os.path.join(ROOT, "specs", "rp_ski_houseelectric_j20.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[25000])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--noise", type=float, default=None)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from rpagp.models import exact_gp as jgp
    from rpagp.ops import cg as jcg
    from rpagp.ops import iterative as jiter
    from rpagp.ops import precond as jprecond
    from rpagp.utils.config import load_spec as jload_spec
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cg as tcg
    from rpagp_torch.ops import iterative, precond
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec
    from rpagp_torch.utils.convert import to_torch

    torch.set_num_threads(args.threads)
    jspec = dataclasses.replace(jload_spec(SPEC).model, solver="bbmm")
    spec = dataclasses.replace(load_spec(SPEC).model, solver="bbmm")

    @functools.partial(jax.jit, static_argnums=(0, 1))
    def jax_pcg(jspec, iters, params, jb, x, pre, B):
        noise = jgp.noise_value(params)
        A = jiter._make_A_mvm(jspec, params, jb, x, noise,
                              state=jb["ski_state"])
        return jcg.batched_pcg(A, B, lambda R: jprecond.apply_inverse(pre, R),
                               max_iters=iters, tol=jspec.cg_tol)

    def traj(betas):
        b = np.asarray(betas, np.float64)[:, 0]
        return [round(float(v), 4) for v in np.sqrt(np.cumprod(np.abs(b)))]

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    for n in args.n:
        ds = datasets.load_dataset("houseelectric",
                                   max_points=math.ceil(n / 0.9) + 1)
        split = next(datasets.kfold_splits(ds, k=10, seed=0,
                                           equal_train=True))
        x, y = split.train_x[:n], split.train_y[:n]
        n = x.shape[0]
        params, kbuf = jax.device_get(
            jgp.init_model(jax.random.key(0), jspec, x.shape[1]))
        if args.noise is not None:
            # softplus^-1 of the noise above the floor
            v = args.noise - jgp.NOISE_FLOOR
            params["raw_noise"] = np.float32(v + math.log(-math.expm1(-v)))
        xj = jnp.asarray(x)
        jb = {**kbuf, "ski_state": jgp._prepare_geometry_jit(
            jspec, params["kernel"], kbuf["kernel"], xj)}
        noise_j = jgp.noise_value(params)
        pre = jax.device_get(jiter._build_pre(jspec, params, jb, xj, noise_j))
        yc = np.asarray(y - jgp.mean_fn(jspec, params, xj), np.float64)
        rng = np.random.default_rng(1)
        es = rng.standard_normal((spec.precond_rank, spec.num_probes))
        eb = rng.standard_normal((n, spec.num_probes))
        Z = (np.asarray(pre.L, np.float64) @ es
             + math.sqrt(float(pre.noise)) * eb)
        B = np.concatenate([yc[:, None], Z], axis=1).astype(np.float32)

        p = to_torch(params, device="cpu")
        xt = torch.from_numpy(x)
        b = exact_gp.prepare_buffers(spec, p, to_torch(kbuf, device="cpu"), xt)
        noise = exact_gp.noise_value(p)
        A = iterative._make_A_mvm(spec, p, b, xt, noise, state=b["ski_state"])
        pre_t = to_torch(pre, device="cpu")
        own = iterative._build_pre(spec, p, b, xt, noise)
        geo = {"tfrac_rel": rel(b["ski_state"].tfrac,
                                jb["ski_state"].tfrac),
               "own_precond_L_rel": rel(own.L, pre.L),
               "own_precond_logdet_rel": rel(float(own.logdet),
                                             float(pre.logdet))}
        iters = spec.cg_max_iters
        t0 = time.perf_counter()
        rj = jax.device_get(jax_pcg(jspec, iters, params, jb, xj, pre,
                                    jnp.asarray(B)))
        t1 = time.perf_counter()
        with torch.no_grad():
            rt = tcg.batched_pcg(
                A, torch.from_numpy(B),
                lambda R: precond.apply_inverse(pre_t, R),
                max_iters=iters, tol=spec.cg_tol)
            t2 = time.perf_counter()
            rs = tcg.batched_pcg(
                A, torch.from_numpy(B) * (1.0 + 2.0 ** -20),
                lambda R: precond.apply_inverse(pre_t, R),
                max_iters=iters, tol=spec.cg_tol)
        xj0, xt0 = np.asarray(rj.solution), rt.solution.numpy()

        print(json.dumps({
            "n": int(n), "cg_iters": iters,
            "noise": float(noise_j),
            "jax_residual": np.asarray(rj.residual_norm).tolist(),
            "port_residual": rt.residual_norm.tolist(),
            "jax_y_zero_start": bool(np.all(xj0[:, 0] == 0)),
            "port_y_zero_start": bool(np.all(xt0[:, 0] == 0)),
            "solution_rel_gap": rel(xt0, xj0),
            "jax_y_precond_residual": traj(rj.betas),
            "port_y_precond_residual": traj(rt.betas),
            "port_y_residual_rhs_scaled": float(rs.residual_norm[0]),
            "jax_s": round(t1 - t0, 1), "port_s": round(t2 - t1, 1),
            **geo}), flush=True)


if __name__ == "__main__":
    main()
