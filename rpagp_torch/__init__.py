"""rpagp_torch — the PyTorch / CUDA port of rpagp for one NVIDIA H100.

The JAX package `rpagp` stays the reference; this package mirrors its
module names and imports nothing of it. Ported so far, with the kernels
each path runs written in CUDA (csrc/):
- the exact grid-solver path of the flagship degree-1 SKI model
  (prepare_buffers -> train_to_convergence on grid_mll -> grid_posterior,
  make_grid_predictor, grid_posterior_cov): K1 chol_linv
  (ops/cuda_chol.py), K2 interp_transpose and K3 interp_apply_sum
  (ops/cuda_interp.py);
- SKI + BBMM, degree-1 SKI specs past the grid solver's budget: CG + SLQ
  on ski.ski_mvm (K2, a Toeplitz product by FFT, K3), the cached
  preconditioner (precond_refresh), the SKI posteriors;
- the BBMM dense path (ops/iterative.py: batched PCG + SLQ training with
  the probe-estimator backward, the LOVE and chunked-CG posteriors): K4
  gram_mvm and K5 gram_mvm_bwd (ops/cuda_gram.py), the fused projected
  Gram x V product and its backward;
- the dense Cholesky branch (ops/exact.py, models/exact_gp.py: exact
  MLL, posterior, covariance, samples) with the full-D and limit kernels
  and every projection family: K1 chol_linv on each 512 leaf of
  block_chol.blocked_cholesky;
- product SKI (ops/ski_product.py), lowered to the exact grid solver: K1
  on the factor Toeplitz ladder and the p x p factor's leaves;
- SVGP (models/svgp.py): the whitened inducing-point ELBO and minibatch
  training;
- the parallel layer (parallel/, on torch.distributed): row-sharded
  training and posteriors over a process group on the grid, BBMM, SKI +
  BBMM and SVGP paths (the runner's --distributed), with the same
  kernels.
Every spec in specs/ runs, on either SKI interpolation plan (the sorted
one plain torch); train_with_checkpointing resumes training from its
checkpoints (utils/checkpoint.py), utils/profiling.py traces a run and
utils/results.py tabulates the runner's CSVs. See ROADMAP.md for what
is left.

The public surface is the JAX package's: KernelSpec / ModelSpec,
init_model / prepare_buffers / exact_mll / predict, mll / posterior /
posterior_cov / sample_posterior / make_predictor, train_to_convergence /
train_fixed, gen_rp / space_equally, load_dataset / kfold_splits /
single_split.

Numerics: f32 throughout with TF32 off. The grid solver's Cholesky
factors sit at the edge of f32 conditioning, so every matmul runs in
full f32; importing the package sets torch's global switches so.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .models.exact_gp import (ModelSpec, exact_mll, init_model,  # noqa: E402
                              predict, prepare_buffers)
from .mll import (make_predictor, mll, posterior,  # noqa: E402
                  posterior_cov, sample_posterior)
from .ops.kernels import KernelSpec  # noqa: E402
from .projections import gen_rp, space_equally  # noqa: E402
from .train import train_fixed, train_to_convergence  # noqa: E402
from .utils.datasets import kfold_splits, load_dataset, single_split  # noqa: E402

__all__ = ["KernelSpec", "ModelSpec", "init_model", "prepare_buffers",
           "exact_mll", "predict", "mll", "posterior", "posterior_cov",
           "sample_posterior", "make_predictor", "gen_rp", "space_equally",
           "train_to_convergence", "train_fixed", "load_dataset",
           "kfold_splits", "single_split"]
