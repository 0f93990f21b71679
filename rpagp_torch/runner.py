"""Experiment runner CLI: datasets x CV splits -> CSV of RMSE/NLL/time
(port of rpagp/runner.py, single device, exact grid-solver path).

Usage:
  python -m rpagp_torch.runner --model_spec specs/rp_ski_houseelectric_j20.json \
      --datasets houseelectric --splits 10 --max_splits 1
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
              timings: dict | None = None):
    """Train on one split and evaluate on its test fold; returns the
    metrics dict of one CSV row. The projection is drawn from a CPU
    torch.Generator seeded with `seed`, so it does not depend on the
    device. timings, when given, receives prepare/train/posterior
    seconds (each ends in a device synchronize)."""
    device = torch.device(device)
    if exp.model_family != "exact_gp":
        raise NotImplementedError("SVGP is ROADMAP slice 11")
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

    t0 = time.perf_counter()
    res = train_to_convergence(
        lambda p, b, xx, yy: -mll_fn(spec, p, b, xx, yy) / n,
        params,
        exp.train,
        loss_args=(buffers, x, y),
        sync_every=8,
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
    # posterior's factor (at the returned params) left the exact level
    t_max = float(torch.max(grid_solve.stats["t_levels"]))
    c_over = float(grid_solve.stats["c_level"])
    if t_max > 1.0 or c_over > 0.0:
        print(f"[diag] grid-factor jitter fallback engaged at best params: "
              f"T-ladder x{t_max:.3g}, C-chol {c_over:.3g} * noise",
              file=sys.stderr)
    return {
        "rmse": rmse,
        "nll": nll,
        "mll": -res.best_loss,
        "train_time_s": train_time,
        "iterations": res.iterations,
        "n_train": int(n),
        "n_test": int(xt.shape[0]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="RPA-GP experiment runner (PyTorch port, exact grid path)")
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
    args = ap.parse_args(argv)

    exp = load_spec(args.model_spec)
    rows = []
    for ds_name in args.datasets:
        ds = data_mod.load_dataset(ds_name, max_points=args.max_points)
        if ds.synthetic:
            print(f"[warn] {ds_name}: no .mat found — synthetic fallback data",
                  file=sys.stderr)
        for i, split in enumerate(data_mod.kfold_splits(
                ds, k=args.splits, seed=args.seed, equal_train=True)):
            if args.max_splits is not None and i >= args.max_splits:
                break
            m = run_split(exp, split, seed=args.seed + i, device=args.device)
            rows.append({"dataset": ds_name, "split": i, "model": exp.name,
                         "synthetic_data": ds.synthetic, **m})
            print(f"{ds_name}[{i}] n={m['n_train']} rmse={m['rmse']:.4f} "
                  f"nll={m['nll']:.4f} iters={m['iterations']} "
                  f"t={m['train_time_s']:.1f}s")

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    print(f"wrote {len(rows)} rows -> {args.output}")


if __name__ == "__main__":
    main()
