"""Experiment runner CLI: datasets x CV splits -> CSV of RMSE/NLL/time
(port of rpagp/runner.py, single device: the dense Cholesky path, the
exact grid-solver path (degree-1 and product SKI), the BBMM path and
SVGP). Every spec in specs/ runs.

Usage:
  python -m rpagp_torch.runner --model_spec specs/rp_poly_j20.json \
      --datasets sml --splits 10 --max_splits 1
  python -m rpagp_torch.runner --model_spec specs/rp_ski_houseelectric_j20.json \
      --datasets houseelectric --splits 10 --max_splits 1
  python -m rpagp_torch.runner --model_spec specs/rp_bbmm_elevators.json \
      --datasets elevators --splits 10 --max_splits 1
  python -m rpagp_torch.runner --model_spec specs/rp_ski_d2_j6.json \
      --datasets protein --splits 10 --max_splits 1
  python -m rpagp_torch.runner --model_spec specs/svgp_m512.json \
      --datasets elevators --splits 10 --max_splits 1
  python -m rpagp_torch.runner --model_spec specs/rp_ski_d2_j6.json \
      --datasets protein --splits 10 --max_splits 1 --profile traces/

--profile LOGDIR traces the first split with torch.profiler
(utils.profiling.trace) and writes its Chrome-trace JSON into LOGDIR.

--distributed trains row-sharded over a process group (parallel/): NCCL
with one card a rank, or gloo with --device cpu; --comp_shards c makes
the mesh data x comp and shards the BBMM kernel's components over comp.
Start N ranks with torchrun; without it the world is this one process:
  torchrun --nproc_per_node N -m rpagp_torch.runner --distributed \
      --model_spec specs/rp_ski_houseelectric_j20.json \
      --datasets houseelectric --splits 10 --max_splits 1
Rank 0 alone prints the rows and writes the CSV.
"""

from __future__ import annotations

import argparse
import csv
import sys
import time

import torch

from .mll import mll as mll_fn, posterior as posterior_fn
from .models import exact_gp
from .ops import grid_solve
from .ops.exact import gaussian_nll
from .train import train_to_convergence
from .utils import datasets as data_mod
from .utils.config import ExperimentSpec, load_spec
from .utils.profiling import trace

CSV_COLUMNS = [
    "dataset",
    "split",
    "model",
    "n_train",
    "n_test",
    "rmse",
    "nll",
    "mll",
    "train_time_s",
    "iterations",
    "synthetic_data",
]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_split(exp: ExperimentSpec, split, seed: int = 0, device="cuda",
              timings: dict | None = None, distributed: bool = False,
              comp_shards: int = 1):
    """Train on one split and evaluate on its test fold; returns the
    metrics dict of one CSV row. The projection is drawn from a CPU
    torch.Generator seeded with `seed`, so it does not depend on the
    device; the BBMM path's probes from a generator on the device seeded
    with seed + 1. timings, when given, receives prepare/train/posterior
    seconds (each ends in a device synchronize). An SVGP spec
    (model_family "svgp") takes _run_split_svgp.
    distributed=True trains row-sharded over the process group
    (_run_split_distributed; parallel.multihost.initialize brings up a
    world of one when none is), on a data x comp_shards mesh."""
    if exp.model_family not in ("exact_gp", "svgp"):
        raise ValueError(f"unknown model family {exp.model_family!r}")
    if distributed:
        from .parallel import multihost

        device = multihost.initialize(device)
    device = torch.device(device)
    if exp.model_family == "svgp":
        return _run_split_svgp(exp, split, seed, device, timings,
                               distributed)
    if distributed:
        return _run_split_distributed(exp, split, seed, device, timings,
                                      comp_shards)
    spec = exp.model
    x = torch.as_tensor(split.train_x, device=device)
    y = torch.as_tensor(split.train_y, device=device)
    xt = torch.as_tensor(split.test_x, device=device)
    yt = torch.as_tensor(split.test_y, device=device)
    n = x.shape[0]

    tP = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    params, buffers = exact_gp.init_model(spec, x.shape[1], generator=gen,
                                          device=device)
    buffers = exact_gp.prepare_buffers(spec, params, buffers, x, y_train=y)
    _sync(device)
    t_prepare = time.perf_counter() - tP

    # the dense Cholesky and grid solvers are deterministic; the BBMM
    # loss draws new probes every step and the trainer smooths its
    # patience with an EMA
    grid = grid_solve.use_grid_solver(spec, n)
    iterative = (n > spec.max_cholesky_size or spec.kernel.ski) and not grid
    gen_probes = refresh = None
    if iterative:
        gen_probes = torch.Generator(device=device).manual_seed(seed + 1)
        if spec.precond_refresh > 1 and spec.precond_rank > 0:
            # rebuild the cached preconditioner every precond_refresh steps
            refresh = (spec.precond_refresh, lambda p, a: (
                exact_gp.refresh_preconditioner(spec, p, a[0], a[1]),)
                + a[1:])
    t0 = time.perf_counter()
    res = train_to_convergence(
        lambda p, b, xx, yy, *g: -mll_fn(spec, p, b, xx, yy, *g) / n,
        params,
        exp.train,
        loss_args=(buffers, x, y),
        sync_every=8,
        generator=gen_probes,
        args_refresh=refresh,
    )
    _sync(device)
    train_time = time.perf_counter() - t0

    tQ = time.perf_counter()
    mu, var = posterior_fn(spec, res.params, buffers, x, y, xt)
    rmse = float(torch.sqrt(torch.mean((mu - yt) ** 2)))
    nll = float(gaussian_nll(yt, mu, var))
    t_post = time.perf_counter() - tQ
    if timings is not None:
        timings.update(prepare_s=t_prepare, train_s=train_time,
                       posterior_s=t_post)
    # the ladders are silent by design: say once per split whether the
    # factor at the returned params left the exact level
    if grid:
        diag = grid_solve.factor_diagnostics(spec, res.params, buffers)
        t_max, c_over = diag["t_jitter_mult_max"], diag["c_jitter_over_noise"]
        if t_max > 1.0 or c_over > 0.0:
            print(f"[diag] grid-factor jitter fallback engaged at best "
                  f"params: T-ladder x{t_max:.3g}, C-chol {c_over:.3g} * "
                  f"noise", file=sys.stderr)
    return {
        "rmse": rmse,
        "nll": nll,
        "mll": -res.best_loss,
        "train_time_s": train_time,
        "iterations": res.iterations,
        "refreshes": res.refreshes,
        "n_train": int(n),
        "n_test": int(xt.shape[0]),
    }


def _run_split_svgp(exp: ExperimentSpec, split, seed, device, timings,
                    distributed=False):
    """SVGP: minibatch ELBO training, then the variational predictive. The
    inducing subset is drawn from a CPU generator seeded with `seed`, the
    epochs' shuffles from one on the device seeded with seed + 1;
    max_iters // 10 epochs (at least 1), the spec's batch size and lr, and
    mll the last epoch's -loss, as the JAX package's runner reports. With
    distributed=True each minibatch's rows shard over the data mesh
    (svgp.train_svgp_distributed)."""
    from .models import svgp

    spec = exp.model
    x = torch.as_tensor(split.train_x, device=device)
    y = torch.as_tensor(split.train_y, device=device)
    xt = torch.as_tensor(split.test_x, device=device)
    yt = torch.as_tensor(split.test_y, device=device)
    tP = time.perf_counter()
    params, buffers = svgp.init_svgp_params(
        spec, x, num_inducing=min(exp.num_inducing, x.shape[0]),
        generator=torch.Generator().manual_seed(seed), device=device)
    _sync(device)
    t_prepare = time.perf_counter() - tP
    t0 = time.perf_counter()
    kw = dict(generator=torch.Generator(device=device).manual_seed(seed + 1),
              batch_size=exp.batch_size,
              num_epochs=max(1, exp.train.max_iters // 10), lr=exp.train.lr)
    if distributed:
        from .parallel import sharding

        res = svgp.train_svgp_distributed(
            spec, params, buffers, x, y, sharding.make_mesh(device=device),
            **kw)
    else:
        res = svgp.train_svgp(spec, params, buffers, x, y, **kw)
    _sync(device)
    train_time = time.perf_counter() - t0
    tQ = time.perf_counter()
    mu, var = svgp.svgp_predict(spec, res.params, buffers, xt)
    rmse = float(torch.sqrt(torch.mean((mu - yt) ** 2)))
    nll = float(gaussian_nll(yt, mu, var))
    if timings is not None:
        timings.update(prepare_s=t_prepare, train_s=train_time,
                       posterior_s=time.perf_counter() - tQ)
    return {
        "rmse": rmse,
        "nll": nll,
        "mll": -res.losses[-1] if res.losses else float("nan"),
        "train_time_s": train_time,
        "iterations": len(res.losses),
        "n_train": int(x.shape[0]),
        "n_test": int(xt.shape[0]),
    }


def _run_split_distributed(exp: ExperimentSpec, split, seed, device,
                           timings, comp_shards=1):
    """Row-sharded training over the process group and the sharded
    posterior (the JAX package's _run_split_distributed): the rows are
    trimmed to a multiple of the data axis and each rank keeps its block;
    the exact grid solver with its per-dataset caches when the spec takes
    it (no collective a step), else the BBMM estimator (probes from a
    device generator seeded with seed + 1 on every rank, the
    preconditioner on the full X each rank holds). The loop is
    train_to_convergence's (losses read every 8 steps, the step-0 stall
    check), with the gradient assembly between backward and Adam."""
    from .parallel import sharding

    spec = exp.model
    mesh = sharding.make_mesh(comp=comp_shards, device=device)
    n = (split.train_x.shape[0] // mesh.data) * mesh.data
    x = torch.as_tensor(split.train_x[:n], device=device)
    y = torch.as_tensor(split.train_y[:n], device=device)
    xt = torch.as_tensor(split.test_x, device=device)
    yt = torch.as_tensor(split.test_y, device=device)

    tP = time.perf_counter()
    params, buffers = exact_gp.init_model(
        spec, x.shape[1], generator=torch.Generator().manual_seed(seed),
        device=device)
    x_local, y_local = sharding.shard_rows(x, mesh), sharding.shard_rows(y,
                                                                         mesh)
    state, S4, uy, u1, vc = sharding.prepare_distributed_grid(
        spec, params, buffers, x_local, mesh, y_local=y_local)
    grid = None if S4 is None else (S4, uy, u1, vc)
    if grid is None:
        state = sharding.prepare_distributed_ski(spec, params, buffers,
                                                 x_local, mesh)
    _sync(device)
    t_prepare = time.perf_counter() - tP

    loss_fn, assemble = sharding.make_distributed_loss(spec, mesh, n)
    gen = (None if grid is not None
           else torch.Generator(device=device).manual_seed(seed + 1))
    t0 = time.perf_counter()
    res = train_to_convergence(
        lambda p, *a: loss_fn(p, buffers, x_local, y_local, state, grid, x,
                              *a),
        params, exp.train, sync_every=8, generator=gen, grad_hook=assemble)
    _sync(device)
    train_time = time.perf_counter() - t0

    tQ = time.perf_counter()
    predict = sharding.make_distributed_posterior(spec, mesh, n)
    mu, var = predict(res.params, buffers, x_local, y_local, xt,
                      generator=torch.Generator(device=device).manual_seed(
                          seed + 2), x_full=x)
    rmse = float(torch.sqrt(torch.mean((mu - yt) ** 2)))
    nll = float(gaussian_nll(yt, mu, var))
    if timings is not None:
        timings.update(prepare_s=t_prepare, train_s=train_time,
                       posterior_s=time.perf_counter() - tQ)
    return {
        "rmse": rmse,
        "nll": nll,
        "mll": -res.best_loss,
        "train_time_s": train_time,
        "iterations": res.iterations,
        "refreshes": res.refreshes,
        "n_train": int(n),
        "n_test": int(xt.shape[0]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="RPA-GP experiment runner (PyTorch port: dense "
                    "Cholesky, exact grid, BBMM and SVGP paths)")
    ap.add_argument("--model_spec", required=True, help="path to JSON model spec")
    ap.add_argument("--datasets", nargs="+", required=True)
    ap.add_argument("--splits", type=int, default=10, help="k for k-fold CV")
    ap.add_argument("--max_splits", type=int, default=None,
                    help="run only the first m of the k folds")
    ap.add_argument("--output", default="results.csv")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_points", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernels, cpu "
                         "their plain versions")
    ap.add_argument("--profile", metavar="LOGDIR", default=None,
                    help="write a torch.profiler trace of the first split "
                         "to LOGDIR (Chrome-trace JSON)")
    ap.add_argument("--distributed", action="store_true",
                    help="row-sharded training and posterior over the "
                         "process group (torchrun's ranks, else a world of "
                         "one): NCCL on the card, gloo with --device cpu")
    ap.add_argument("--comp_shards", type=int, default=1,
                    help="with --distributed: a data x comp_shards mesh, "
                         "the BBMM kernel's components sharded over comp")
    args = ap.parse_args(argv)

    exp = load_spec(args.model_spec)
    lead = True
    if args.distributed:
        from .parallel import multihost

        args.device = multihost.initialize(args.device)
        lead = multihost.process_zero()
    split_kw = dict(distributed=args.distributed,
                    comp_shards=args.comp_shards)
    rows = []
    for ds_name in args.datasets:
        ds = data_mod.load_dataset(ds_name, max_points=args.max_points)
        if ds.synthetic and lead:
            print(f"[warn] {ds_name}: no .mat found — synthetic fallback data",
                  file=sys.stderr)
        for i, split in enumerate(data_mod.kfold_splits(
                ds, k=args.splits, seed=args.seed, equal_train=True)):
            if args.max_splits is not None and i >= args.max_splits:
                break
            if args.profile and i == 0 and not rows and lead:
                with trace(args.profile, device=args.device):
                    m = run_split(exp, split, seed=args.seed + i,
                                  device=args.device, **split_kw)
                print(f"[profile] trace written to {args.profile}",
                      file=sys.stderr)
            else:
                m = run_split(exp, split, seed=args.seed + i,
                              device=args.device, **split_kw)
            rows.append({"dataset": ds_name, "split": i, "model": exp.name,
                         "synthetic_data": ds.synthetic, **m})
            if lead:
                print(f"{ds_name}[{i}] n={m['n_train']} rmse={m['rmse']:.4f} "
                      f"nll={m['nll']:.4f} iters={m['iterations']} "
                      f"t={m['train_time_s']:.1f}s")

    if lead:
        with open(args.output, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_COLUMNS,
                               extrasaction="ignore")
            w.writeheader()
            for r in rows:
                w.writerow(r)
        print(f"wrote {len(rows)} rows -> {args.output}")
    if args.distributed:
        multihost.shutdown()


if __name__ == "__main__":
    main()
