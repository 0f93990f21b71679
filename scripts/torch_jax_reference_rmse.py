"""The JAX package's test RMSE and NLL on split 0 of a dataset after a cut
number of training steps, on the CPU: the reference reading that
chip_smoke.py prints beside the port's run of the same spec and split.

    JAX_PLATFORMS=cpu python scripts/torch_jax_reference_rmse.py \
        --model_spec specs/rp_ski_d2_j6.json --dataset protein --max_iters 10
    JAX_PLATFORMS=cpu python scripts/torch_jax_reference_rmse.py \
        --model_spec specs/svgp_m512.json --dataset elevators

rpagp.runner.run_split with seed 0 (projection and initial parameters
from jax.random.key(0), which the port's torch generators do not
reproduce, so the two runs train different draws of the same model) on
the synthetic split 0 (k = 10, equal_train) that both packages' data
layers make. --max_iters replaces the spec's training.max_iters (SVGP:
epochs = max_iters // 10). The persistent AOT cache is off for the run
(arrays it serves segfault numpy conversion in this jax build). Prints
one line: spec, dataset, n_train, iterations, rmse, nll, seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_spec", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--max_iters", type=int, default=None)
    args = ap.parse_args()
    os.environ["RPAGP_AOT_CACHE"] = "off"

    from rpagp import runner
    from rpagp.utils import datasets
    from rpagp.utils.config import load_spec

    exp = load_spec(args.model_spec)
    if args.max_iters is not None:
        exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, max_iters=args.max_iters))
    ds = datasets.load_dataset(args.dataset)
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    t0 = time.perf_counter()
    m = runner.run_split(exp, split, seed=0)
    print(f"{exp.name} {args.dataset} split 0: n_train {m['n_train']}, "
          f"{m['iterations']} iterations, rmse {m['rmse']:.4f}, nll "
          f"{m['nll']:.4f} ({time.perf_counter() - t0:.1f} s, JAX on the "
          f"CPU)", flush=True)


if __name__ == "__main__":
    main()
