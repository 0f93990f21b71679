"""Result aggregation: runner CSVs -> per-dataset summary tables (port of
rpagp/utils/results.py; the standard library only).

Collects one or more CSVs of rpagp_torch.runner (the JAX package's
columns) and prints mean ± std RMSE / NLL per dataset and model across
CV splits.

CLI:  python -m rpagp_torch.utils.results results_a.csv results_b.csv
"""

from __future__ import annotations

import csv
import math
import sys
from collections import defaultdict


def aggregate(paths):
    """-> {(dataset, model): {rmse_mean, rmse_std, nll_mean, nll_std,
    time_mean_s, n_splits}} from runner CSV files (sample std)."""
    rows = []
    for p in paths:
        with open(p) as f:
            rows.extend(csv.DictReader(f))
    groups = defaultdict(list)
    for r in rows:
        groups[(r["dataset"], r["model"])].append(r)

    def stats(vals):
        m = sum(vals) / len(vals)
        v = sum((x - m) ** 2 for x in vals) / max(1, len(vals) - 1)
        return m, math.sqrt(v)

    out = {}
    for key, rs in groups.items():
        rmse_m, rmse_s = stats([float(r["rmse"]) for r in rs])
        nll_m, nll_s = stats([float(r["nll"]) for r in rs])
        t_m, _ = stats([float(r["train_time_s"]) for r in rs])
        out[key] = {
            "rmse_mean": rmse_m,
            "rmse_std": rmse_s,
            "nll_mean": nll_m,
            "nll_std": nll_s,
            "time_mean_s": t_m,
            "n_splits": len(rs),
        }
    return out


def format_table(agg) -> str:
    """The aggregate as a fixed-width text table, one row per (dataset,
    model) in sorted order."""
    lines = [
        f"{'dataset':<16} {'model':<18} {'rmse':<16} {'nll':<16} "
        f"{'time(s)':<9} {'splits'}"
    ]
    for (ds, model), s in sorted(agg.items()):
        lines.append(
            f"{ds:<16} {model:<18} "
            f"{s['rmse_mean']:.4f}±{s['rmse_std']:.4f}   "
            f"{s['nll_mean']:.4f}±{s['nll_std']:.4f}   "
            f"{s['time_mean_s']:<9.1f} {s['n_splits']}"
        )
    return "\n".join(lines)


def main(argv=None):
    paths = argv if argv is not None else sys.argv[1:]
    if not paths:
        print("usage: python -m rpagp_torch.utils.results <results.csv> "
              "[...]")
        return 1
    print(format_table(aggregate(paths)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
