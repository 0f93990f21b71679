"""rpagp_torch — the PyTorch / CUDA port of rpagp for one NVIDIA H100.

The JAX package `rpagp` stays the reference; this package mirrors its
module names. Ported so far: the exact grid-solver path of the flagship
degree-1 SKI model (prepare_buffers -> train_to_convergence on grid_mll
-> grid_posterior), with the three kernels it runs written in CUDA
(csrc/): K1 chol_linv (ops/cuda_chol.py), K2 interp_transpose and K3
interp_apply_sum (ops/cuda_interp.py). See ROADMAP.md for the rest.

Numerics: f32 throughout with TF32 off. The grid solver's Cholesky
factors sit at the edge of f32 conditioning, so every matmul runs in
full f32; importing the package sets torch's global switches so.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .models.exact_gp import ModelSpec, init_model, prepare_buffers  # noqa: E402
from .ops.kernels import KernelSpec  # noqa: E402

__all__ = ["KernelSpec", "ModelSpec", "init_model", "prepare_buffers"]
