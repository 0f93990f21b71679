"""Operations of one SKI + BBMM training step (iterative_mll's value and
gradient) at a configuration's shapes, whatever computes them, with CG
run to cg_max_iters. t = num_probes + 1 columns; k = precond_rank.

Each CG iteration: the SKI MVM (W^T V and W G: 4 multiply-adds a point,
component and column each way; the Toeplitz products by 2m-point FFTs),
the preconditioner's Woodbury solve (L^T R and L w), and the CG vector
updates (six n x t passes of 2 operations). The gradient: one SKI MVM
and one more W^T pass. The preconditioner (k rows of J n 1-D kernel
values, 4 operations each, and the Schur updates) is rebuilt at every
step until the trainer's first refresh, then every precond_refresh
steps: its share over a call of max_iters steps."""

import math


def flops(cfg, n: int) -> float:
    J, m = cfg["kernel"]["J"], cfg["kernel"]["grid_size"]
    inf = cfg["inference"]
    t, k = inf["num_probes"] + 1, inf["precond_rank"]
    iters, every = inf["cg_max_iters"], inf.get("precond_refresh", 1)
    steps = cfg["training"]["max_iters"]
    fft = J * t * (2 * 5 * 2 * m * math.log2(2 * m) + 6 * (m + 1))
    per_iter = 16 * J * n * t + fft + 4 * n * k * t + 12 * n * t
    backward = 24 * J * n * t + fft
    build = k * (4 * J * n + 2 * n * k)
    builds = (min(every, steps) + max(0, math.ceil(steps / every) - 1)
              if every > 1 else steps)
    return iters * per_iter + backward + build * builds / steps
