"""Smoke run of rpagp_torch on one CUDA card: builds the kernels, holds
each against its plain PyTorch version at its path's shapes, holds the
CUDA MLL of each path against the CPU one at full width, and drives each
ported path through rpagp_torch.runner.run_split at full size:
- the flagship exact grid-solver path (K1's cooperative kernel behind
  its two entry points, the 512 leaf and the (20, 256, 256) ladder batch;
  K2, K3), phases 2-4; K1 is also held bit for bit against the one-block
  kernel, on random matrices, at every level of the flagship's jitter
  ladder and on the flagship's C-factor leaves; K2 (one launch a call at
  any width) is held and timed through its C entry on uniform points at
  t = 1, 8, 11 (phase 2) and on the flagship split's own tfrac at t = 1,
  2, 8, 9, 512 and 513 (phase 4: prepare, the posterior, every SKI + BBMM
  CG iteration, the LOVE cross MVMs), beside cuSPARSE's SpMM of a CSR W^T
  and a scatter of precomputed taps by `index_add_`; K3 on uniform
  points at t = 1, 8 and 11 (phase 2) and on the split's tfrac and test
  tfrac (phase 4), beside `embedding_bag` over precomputed taps;
- the BBMM dense path on elevators (K4, K5), phases 5-7; phase 5 also
  prints the instruction mix of K4's and K5's inner loops from the built
  library's SASS;
- the dense Cholesky path (K6 / K7, the dense Gram and its backward, held
  against their float64 twins at its K(x, x) and its predictor's cross
  Gram in phase 5; K1's 512 leaf in the blocked factor of K + s^2 I) on
  rp_poly_j20 / sml, phase 8, then every other dense spec briefly;
- SKI + BBMM (K2 and K3 in every CG iteration and backward), phase 9:
  rp_poly_j20_ski on sml (m = 512, t = 11, K2 held with padding and points
  beyond the grid; its CUDA MLL against the CPU
  one, and against the exact grid solver forced at p = 10,240 with K1's
  (20, 512, 512) ladder batch), then the flagship spec with
  solver="bbmm" at n = 1.84M (the cached preconditioner, LOVE at rank
  512, the gap to grid_mll). Phase 4 also holds the grid path's cached
  predictor, posterior covariance and factor diagnostics;
- phase 10: K1's failure contract on indefinite (512, 512) blocks (both
  entry points: finite outputs, bit for bit the one-block kernel's);
  product SKI, rp_ski_d2_j6 on protein (the exact grid solver at
  p = J m^F = 1536; K1's (12, 16, 16) factor ladder and the p x p
  factor's leaves; its CUDA MLL against the CPU one); SVGP, svgp_m512 on
  elevators (its CUDA ELBO against the CPU one, all 50 epochs, no host
  read within an epoch);
- phase 11, the single-card surface beside the kernels: the sorted SKI
  plan (plain torch) at the flagship's full size against K2 / K3 and a
  float64 run of itself, and on rp_poly_j20_ski's SKI + BBMM step;
  train_with_checkpointing and its resume on rp_bbmm_elevators; the
  runner's --profile (a trace holding K1's kernel); the step-0 stall
  warning and the trainer's host reads. Each of its lines ends with the
  card's name and power limit;
- phase 12, the parallel path (rpagp_torch/parallel/) on a NCCL process
  group of one rank: the flagship grid spec through
  run_split(distributed=True) at full size against phase 4 (K1, K2, K3),
  the flagship with solver "bbmm" distributed (sharded_ski_mvm: K2, K3),
  rp_bbmm_elevators distributed (ring_mvm: K4, K5), each distributed MLL
  against the single-card one; svgp_m512's distributed epoch; and
  `torchrun --nproc_per_node 1 -m rpagp_torch.runner --distributed` as a
  subprocess (and the same without torchrun on 200,000 points). Its lines
  end with the card's name and power limit too.

Each phase prints its seconds.

    python3 chip_smoke.py

Exits non-zero, printing no result, on any failure or without a card.
Its last stdout line is {"ok": true, "device": {...}}; the line before
it holds the kernels' launch counts, errors and times.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPEC = os.path.join(ROOT, "specs", "rp_ski_houseelectric_j20.json")
SPEC_BBMM = os.path.join(ROOT, "specs", "rp_bbmm_elevators.json")
N_FLAGSHIP_TRAIN = 1_844_352  # synthetic HouseElectric split 0 (k=10)
N_ELEVATORS_TRAIN, N_ELEVATORS_TEST = 14_939, 1_660  # elevators split 0
SPEC_DENSE = os.path.join(ROOT, "specs", "rp_poly_j20.json")
N_SML_TRAIN, N_SML_TEST = 3_723, 414  # synthetic sml split 0 (k=10)
# test RMSE of the JAX package's run_split on that split after 10 steps
# (projection key 0, on the CPU), for the reader beside the port's
JAX_RMSE_SML_10 = 0.8957
# the dense specs besides rp_poly_j20, run briefly at n_train ~1000
DENSE_OTHERS = ("rp_poly_j10", "rp_poly_j10_d2", "rp_generalized_mixed",
                "rp_learned_proj_j10", "exact_rbf", "exact_matern52",
                "rp_limit", "additive_axes", "rp_sphere_j20_percomp",
                "rp_bbmm_elevators")

# the card's published peaks (H100 SXM at 700 W): HBM bytes/s, f32 FLOP/s outside the tensor cores, and the SFU's
# exponentials/s (16 per clock per SM, 132 SMs, 1.98 GHz boost clock)
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
EXP_S = 16 * 132 * 1.98e9


# K1's times before it served both entry points with one cooperative
# kernel (PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W): the
# single-matrix kernel at (1, 512, 512) and the one-block kernel at
# (20, 256, 256)
K1_LEAF_BEFORE_MS = "0.2248"
K1_BATCH_BEFORE_MS = "0.660-0.663"
# K2's time before it was rebuilt around the taps (every cell-owning
# thread walked every staged point), t = 1 at the flagship shape, PERF.md
# section 6, NVIDIA H100 80GB HBM3, 700.00 W
K2_BEFORE_MS = "14.303-14.373"
# K2's times before it carried many columns a pass (one column a pass at
# m >= 256, launches of 8 columns) on the flagship split's tfrac, PERF.md
# section 6, NVIDIA H100 80GB HBM3, 700.00 W: t = 1, 9 (the SKI + BBMM
# step's range) and 512
K2_BEFORE_T1_MS = "0.2164"
K2_T9_BEFORE_MS = "2.088-2.099"
K2_T512_BEFORE_MS = "138.28"
# K3's time before its redesign (one thread a point, its taps gathered
# from G through L1), t = 1 at the flagship shape, PERF.md section 6,
# NVIDIA H100 80GB HBM3, 700.00 W
K3_BEFORE_MS = "0.4513-0.455"


def bound(nbytes, flops=0.0, exps=0.0):
    """(bound_ms, bound_by, term): the least time the card could take for
    this work, the larger of the bytes over the memory rate and the
    operations over their peak rate."""
    terms = {"bytes": nbytes / HBM_BYTES_S, "f32": flops / F32_FLOPS_S,
             "exp": exps / EXP_S}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            term)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters=5, warmup=1):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel(a, b):
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.clamp(torch.linalg.norm(b),
                                                         min=1e-30))


def max_abs(a, b):
    import torch

    return float(torch.max(torch.abs(a.double().cpu() - b.double().cpu())))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase0_env():
    import torch

    card = _card_line()
    print(card, flush=True)
    import rpagp_torch  # noqa: F401  (sets the f32 matmul switches)

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "f32 matmul precision is not 'highest'")
    say(0, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)}; TF32 off")
    return card


def ptxas_usage(log, kernels):
    """{kernel<template args>: "R registers, S bytes spilled"} from the
    build's -Xptxas -v log, for the kernels whose name holds one of
    `kernels`."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            hit = next((k for k in kernels if k in fn), None)
            args = re.findall(r"L[ib](\d+)E", fn.split(hit)[-1]) if hit else []
            name = f"{hit}<{','.join(args)}>" if hit else None
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            out[name] = f"{spill.group(1)} bytes spilled"
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[name] = f"{regs.group(1)} registers, {out.get(name, '')}"
            name = None
    return out


def phase1_build():
    from rpagp_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    say(1, f"kernels built in {time.perf_counter() - t0:.2f} s "
           f"(nvcc {_build.build_seconds} s) -> "
           f"{os.path.relpath(_build.library_path(), ROOT)}")
    with open(_build.library_path()[:-3] + ".log") as f:
        usage = ptxas_usage(f.read(), ("transpose_own_kernel",
                                       "transpose_slots_kernel",
                                       "apply_sum_shifted_kernel",
                                       "apply_sum_rows_kernel",
                                       "gram_mvm_bwd_kernel"))
    say(1, "ptxas -v (K2 one-column and <slots>, K3 shifted <vec> and rows, "
           "K5 <base, columns>): "
           + "; ".join(f"{k} {v}" for k, v in sorted(usage.items())))


def _spd(B, b, gen, dev):
    import torch

    X = torch.randn(B, b, b, generator=gen).to(dev)
    A = X @ X.mT / b + 0.5 * torch.eye(b, device=dev)
    return 0.5 * (A + A.mT)


def _toeplitz_batch(dev):
    """The flagship's (20, 256, 256) RBF Toeplitz blocks at the initial
    lengthscale, on a grid built from 32768 synthetic 11-d points."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import grid_solve, ski
    from rpagp_torch.utils.config import load_spec

    spec = load_spec(SPEC).model
    gen = torch.Generator().manual_seed(1)
    params, buffers = exact_gp.init_model(spec, 11, generator=gen, device=dev)
    x = torch.randn(32768, 11, generator=gen).to(dev)
    state = ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"], x,
                          spec.kernel.grid_size)
    T = grid_solve._toeplitz_blocks(spec.kernel, params["kernel"], state)
    return T, spec.grid_jitter * T[:, 0, 0]


def phase2_kernels(results):
    import torch

    from rpagp_torch.ops import cuda_chol, cuda_interp, grid_solve

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    one_block = cuda_chol.ONE_BLOCK

    # --- K1, B = 1, b = 512: the diagonal leaf of the p x p factor, on the
    #     cooperative kernel; the one-block kernel on the same input must
    #     agree bit for bit (the same per-element arithmetic,
    #     csrc/chol_tile.cuh)
    A = _spd(1, 512, gen, dev)
    L, Li, ok = cuda_chol.chol_linv_cuda(A, "chol_linv")
    L1, Li1, ok1 = cuda_chol.chol_linv_cuda(A, one_block)
    Lp, Lip, okp = cuda_chol.chol_linv_plain(A)
    torch.cuda.synchronize()
    eL, eLi = rel(L, Lp), rel(Li, Lip)
    check(bool((ok == 1).all()) and torch.equal(ok, okp), "K1 b=512 ok flags")
    check(eL <= 1e-5 and eLi <= 1e-5, f"K1 b=512 rel L {eL:.2e} Linv {eLi:.2e}")
    res = rel(L @ L.mT, A)
    check(res <= 1e-5, f"K1 b=512 residual {res:.2e}")
    check(torch.equal(L, L1) and torch.equal(Li, Li1) and torch.equal(ok, ok1),
          f"K1 b=512 cooperative kernel differs from the one-block kernel: "
          f"max abs {max(max_abs(L, L1), max_abs(Li, Li1)):.2e}")
    L2, Li2, _ = cuda_chol.chol_linv_cuda(A, "chol_linv")
    check(torch.equal(L, L2) and torch.equal(Li, Li2),
          "K1 b=512 cooperative kernel not bit-identical on a repeat")

    def leaf():
        return cuda_chol.chol_linv_cuda(A, "chol_linv")

    # in turns: leaf, one-block, plain, leaf
    ms_a = cuda_ms(leaf, iters=20)
    ms1 = cuda_ms(lambda: cuda_chol.chol_linv_cuda(A, one_block), iters=20)
    pms = cuda_ms(lambda: cuda_chol.chol_linv_plain(A), iters=20)
    ms = 0.5 * (ms_a + cuda_ms(leaf, iters=20))
    G, C = cuda_chol.coop_grid(1, 512, dev)
    say(2, f"K1 (1,512,512): the one-block kernel {ms1:.4f} ms; the "
           f"cooperative kernel, G = {G} blocks of 256 threads, C = {C} "
           f"chain block, {ms:.4f} ms (the single-matrix kernel it replaced: "
           f"{K1_LEAF_BEFORE_MS} ms, PERF.md); bit for bit equal, and "
           f"repeatable")
    # Cholesky + triangular inverse: 2 b^3 / 3 flops; A in, L and Linv out
    bms, bby, _ = bound(4 * 3 * 512**2, flops=2 * 512**3 / 3)
    # the plain version is cuSOLVER (cholesky_ex + solve_triangular): it is
    # also the library call
    results["chol_linv"] = dict(max_abs_err=max(max_abs(L, Lp), max_abs(Li, Lip)),
                                ms=ms, plain_ms=pms, bound_ms=bms,
                                bound_by=bby, library_ms=pms)
    say(2, f"K1 (1,512,512) SPD: rel L {eL:.2e} Linv {eLi:.2e} "
           f"|LL^T-A|/|A| {res:.2e}; {ms:.3f} ms vs plain {pms:.3f} ms")

    def same_as_one_block(T, out):
        """The cooperative kernel's outputs `out` on T equal the one-block
        kernel's bit for bit, ok flags included."""
        ref = cuda_chol.chol_linv_cuda(T, one_block)
        return all(torch.equal(a, b) for a, b in zip(out, ref))

    # --- K1, B = 20, b = 256 on well-conditioned blocks: the 1e-5 bar
    S = _spd(20, 256, gen, dev)
    L0, Li0, ok0 = cuda_chol.chol_linv_cuda(S, "chol_linv_batched")
    Lp, Lip, okp = cuda_chol.chol_linv_plain(S)
    torch.cuda.synchronize()
    eL, eLi = rel(L0, Lp), rel(Li0, Lip)
    check(bool((ok0 == 1).all()) and torch.equal(ok0, okp),
          "K1 (20,256,256) SPD ok flags")
    check(eL <= 1e-5 and eLi <= 1e-5,
          f"K1 (20,256,256) SPD rel L {eL:.2e} Linv {eLi:.2e}")
    check(float(torch.max(torch.abs(torch.triu(L0, 1)))) == 0.0,
          "K1 L not exactly lower-triangular")
    check(same_as_one_block(S, (L0, Li0, ok0)),
          "K1 (20,256,256) SPD: the cooperative kernel differs from the "
          "one-block kernel")
    results["chol_linv_batched"] = dict(
        max_abs_err=max(max_abs(L0, Lp), max_abs(Li0, Lip)))
    say(2, f"K1 (20,256,256) SPD: rel L {eL:.2e} Linv {eLi:.2e}; L exactly "
           f"lower-triangular; bit for bit the one-block kernel's")

    # --- K1, B = 20, b = 256: the flagship Toeplitz blocks + jitter, every
    #     level of the ladder bit for bit against the one-block kernel
    T, eps0 = _toeplitz_batch(dev)
    eye = torch.eye(256, device=dev)
    chosen = None
    for mult in grid_solve._LADDER:
        Tl = (T + (mult * eps0)[:, None, None] * eye).contiguous()
        out = cuda_chol.chol_linv_cuda(Tl, "chol_linv_batched")
        Lp, Lip, okp = cuda_chol.chol_linv_plain(Tl)
        torch.cuda.synchronize()
        ok = out[2]
        same = same_as_one_block(Tl, out)
        say(2, f"K1 Toeplitz (20,256,256) jitter x{mult:g}: ok kernel "
               f"{int(ok.sum())}/20, plain {int(okp.sum())}/20, same blocks "
               f"{torch.equal(ok, okp)}; bit for bit the one-block kernel's "
               f"{same}")
        check(same, f"K1 Toeplitz jitter x{mult:g}: the cooperative kernel "
                    f"differs from the one-block kernel")
        if chosen is None and bool((okp == 1).all()) and bool((ok == 1).all()):
            chosen = (mult, Tl, *out, Lp, Lip, okp)
    check(chosen is not None, "K1 Toeplitz: no ladder level factors all")
    mult, Tj, L, Li, ok, Lp, Lip, okp = chosen
    # near the base level the pivots sit at f32 rounding, so the flags of
    # two correct factorizations can differ; they must agree where both
    # pass (the level the ladder would pick)
    check(torch.equal(ok, okp), "K1 Toeplitz ok flags differ from plain")
    res_k = rel(L @ L.mT, Tj)
    res_p = rel(Lp @ Lp.mT, Tj)

    def inv_residual(L, Li):  # |L Li - I| / (|L| |Li|), Frobenius, worst block
        num = torch.linalg.norm((L @ Li - eye).double(), dim=(-2, -1))
        den = (torch.linalg.norm(L.double(), dim=(-2, -1))
               * torch.linalg.norm(Li.double(), dim=(-2, -1)))
        return float(torch.max(num / den))

    inv_k, inv_p = inv_residual(L, Li), inv_residual(Lp, Lip)
    eL = rel(L, Lp)
    # these blocks sit at the edge of f32 (the reason for the ladder): two
    # correct factors differ by ~kappa(A) * eps, so L is held to that
    # bound, and both factors to a backward-error (residual) bar
    ev = torch.linalg.eigvalsh(Tj.double().cpu())
    kappa = float(torch.max(ev[:, -1] / ev[:, 0]))
    check(res_k <= 1e-5 and res_p <= 1e-5,
          f"K1 Toeplitz residual kernel {res_k:.2e} plain {res_p:.2e}")
    check(eL <= 10 * kappa * 2.0**-24,
          f"K1 Toeplitz rel L {eL:.2e} > 10 kappa eps (kappa {kappa:.2e})")
    # the inverse is held to a backward-error bar, b * eps: conditioning
    # enters Linv itself, not this residual
    check(bool(torch.isfinite(Li).all()) and inv_k <= 256 * 2.0**-24,
          f"K1 Toeplitz Linv residual {inv_k:.2e}")
    # in turns: cooperative, one-block, cuSOLVER, cooperative, one-block,
    # cuSOLVER, on the ladder level chosen above
    def batch():
        return cuda_chol.chol_linv_cuda(Tj, "chol_linv_batched")

    def one():
        return cuda_chol.chol_linv_cuda(Tj, one_block)

    def cusolver():
        return cuda_chol.chol_linv_plain(Tj)

    turns = [(f, cuda_ms(f, iters=20)) for f in (batch, one, cusolver) * 2]
    ms, pms = (statistics.mean(t for f, t in turns if f is g)
               for g in (batch, cusolver))
    G, C = cuda_chol.coop_grid(20, 256, dev)
    say(2, f"K1 (20,256,256) ladder blocks, in turns: the cooperative kernel "
           f"(G = {G} blocks, C = {C} chain blocks) "
           f"{', '.join(f'{t:.4f}' for f, t in turns if f is batch)} ms, the "
           f"one-block kernel "
           f"{', '.join(f'{t:.4f}' for f, t in turns if f is one)} ms, "
           f"cuSOLVER {', '.join(f'{t:.4f}' for f, t in turns if f is cusolver)}"
           f" ms (the one-block kernel before: {K1_BATCH_BEFORE_MS} ms, "
           f"PERF.md)")
    check(ms < pms, f"K1 (20,256,256): the cooperative kernel {ms:.4f} ms is "
                    f"not faster than cuSOLVER {pms:.4f} ms")
    bms, bby, _ = bound(4 * 3 * 20 * 256**2, flops=20 * 2 * 256**3 / 3)
    results["chol_linv_batched"].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                        bound_by=bby, library_ms=pms)
    say(2, f"K1 Toeplitz x{mult:g}: |LL^T-A|/|A| kernel {res_k:.2e} plain "
           f"{res_p:.2e}; rel L vs plain {eL:.2e} (max kappa {kappa:.2e}, "
           f"10 kappa eps {10 * kappa * 2.0**-24:.2e}); |L Linv - I|/"
           f"(|L||Linv|) kernel {inv_k:.2e} plain {inv_p:.2e}; {ms:.3f} ms "
           f"vs plain {pms:.3f} ms")

    # --- K1: one indefinite block leaves the others alone
    Sb = S.clone()
    Sb[3] -= 10.0 * eye
    L1, Li1, ok1 = cuda_chol.chol_linv_cuda(Sb, "chol_linv_batched")
    torch.cuda.synchronize()
    keep = torch.arange(20, device=dev) != 3
    check(float(ok1[3]) == 0.0 and bool((ok1[keep] == 1).all()),
          "K1 indefinite block flags")
    check(bool(torch.isfinite(L1).all() and torch.isfinite(Li1).all()),
          "K1 indefinite outputs not finite")
    check(torch.equal(L1[keep], L0[keep]) and torch.equal(Li1[keep], Li0[keep]),
          "K1 indefinite block changed the others")
    check(same_as_one_block(Sb, (L1, Li1, ok1)),
          "K1 indefinite batch: the cooperative kernel differs from the "
          "one-block kernel")
    say(2, "K1 indefinite block 3: ok=0, others bit-identical, all finite; "
           "bit for bit the one-block kernel's")

    # --- K1 gradient through the autograd.Function, kernel vs plain (CPU)
    for shape, fn in (((512, 512), cuda_chol.chol_linv),
                      ((20, 256, 256), cuda_chol.chol_linv_batched)):
        A0 = (_spd(1, shape[-1], gen, "cpu")[0] if len(shape) == 2
              else _spd(20, 256, gen, "cpu"))
        R1, R2 = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
        grads = []
        for d in ("cuda", "cpu"):
            Ad = A0.to(d).requires_grad_(True)
            Ls, Lis, _ = fn(0.5 * (Ad + Ad.mT))
            (torch.sum(Ls * R1.to(d)) + torch.sum(Lis * R2.to(d))).backward()
            grads.append(Ad.grad)
        eg = rel(grads[0], grads[1])
        check(eg <= 1e-4, f"K1 gradient rel {eg:.2e} at {shape}")
        say(2, f"K1 gradient {shape}: rel vs plain {eg:.2e}")

    # --- K2 / K3 at the flagship shapes: n = 1,844,352, J = 20, m = 256
    J, n, m = 20, N_FLAGSHIP_TRAIN, 256
    tf = (1.0 + (m - 4.0) * torch.rand(J, n, generator=gen)).to(dev)
    tf[:, :4] = torch.tensor([-1.5, -0.25, m - 1.0, m + 0.5])  # grid edges
    tf[:, -1000:] = -100.0  # padding
    for t in (1, 8, 11):
        V = torch.randn(n, t, generator=gen).to(dev)
        G = torch.randn(J, t, m, generator=gen).to(dev)
        U = cuda_interp.interp_transpose_cuda(tf, V, m)
        Up = cuda_interp.interp_transpose_plain(tf, V, m)
        O = cuda_interp.interp_apply_sum_cuda(tf, G)
        Op = cuda_interp.interp_apply_sum_plain(tf, G)
        torch.cuda.synchronize()
        eU, eO = rel(U, Up), rel(O, Op)
        check(eU <= 1e-5 and eO <= 1e-5, f"K2/K3 t={t}: rel {eU:.2e} {eO:.2e}")
        lhs = float(torch.sum(U.double() * G.double()))
        rhs = float(torch.sum(V.double() * O.double()))
        # relative to the Cauchy-Schwarz bound |<U, G>| <= |U| |G|
        adj = abs(lhs - rhs) / float(torch.linalg.norm(U.double())
                                     * torch.linalg.norm(G.double()))
        check(adj <= 1e-5, f"K2/K3 adjoint identity {adj:.2e}")
        check(bool((O[-1000:] == 0).all()), "K3 padding rows not zero")
        check(torch.equal(cuda_interp.interp_apply_sum_cuda(tf, G), O),
              "K3 not deterministic")
        V2 = V.clone()
        V2[-1000:] = 1e6
        U2 = cuda_interp.interp_transpose_cuda(tf, V2, m)
        check(torch.equal(U2, U), "K2 padding contributes")
        U3 = cuda_interp.interp_transpose_cuda(tf, V, m)
        check(torch.equal(U3, U), "K2 not deterministic")
        ms_t, _ = k2_c_entry_ms(tf, V, m, iters=20)
        pms_t = cuda_ms(lambda: cuda_interp.interp_transpose_plain(tf, V, m),
                        iters=2)
        ms_a = cuda_ms(lambda: cuda_interp.interp_apply_sum_cuda(tf, G),
                       iters=20)
        pms_a = cuda_ms(lambda: cuda_interp.interp_apply_sum_plain(tf, G),
                        iters=2)
        # tfrac, V in and U out (K2), or tfrac, G in and out (K3); 4
        # taps per point and component, one FMA per column each
        nbytes = 4 * (J * n + n * t + J * t * m)
        bms, bby, _ = bound(nbytes, flops=2 * 4 * J * n * t)
        say(2, f"K2 t={t} (uniform points): rel {eU:.2e}, {ms_t:.4f} ms vs "
               f"plain {pms_t:.3f} ms (the kernel it replaced, t = 1: "
               f"{K2_BEFORE_MS} ms, PERF.md); K3 t={t}: rel {eO:.2e}, "
               f"{ms_a:.4f} ms vs plain {pms_a:.3f} ms, bound {bms:.4f} ms "
               f"({bby}; the kernel before its redesign, t = 1: "
               f"{K3_BEFORE_MS} ms, PERF.md); adjoint {adj:.1e}; padding "
               f"exact; K2 and K3 repeat bit for bit")
        if t == 1:  # the main path's width
            lms, erel = embedding_bag_ms(tf, G, Op)
            say(2, f"K3 t=1 yardstick: embedding_bag over the taps "
                   f"precomputed outside the timed call (not the same "
                   f"function) {lms:.4f} ms, rel vs plain {erel:.2e}")
            yard = k2_yardsticks(tf, V, m, Up)
            say(2, "K2 t=1 yardsticks, built outside the timed call: "
                   + ", ".join(f"{k} {v[0]:.4f} ms (rel {v[1]:.1e})"
                               for k, v in yard.items()))
            results["interp_transpose"] = dict(
                max_abs_err=max_abs(U, Up), ms=ms_t, plain_ms=pms_t,
                bound_ms=bms, bound_by=bby, library_ms=yard["sparse.mm"][0])
            results["interp_apply_sum"] = dict(
                max_abs_err=max_abs(O, Op), ms=ms_a, plain_ms=pms_a,
                bound_ms=bms, bound_by=bby, library_ms=lms)


def _device_ms(fn, calls, names, top=0):
    """torch.profiler over `calls` calls of fn: the device time per call of
    every kernel and copy, and of the kernels whose name holds each of
    `names`, in ms; with top > 0 also the `top` largest kernels by device
    time per call, as (name, ms) pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in dev) / 1e3 / calls
    by = {k: sum(e.self_device_time_total for e in dev
                 if k in e.key) / 1e3 / calls for k in names}
    if not top:
        return total, by
    largest = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    return total, by, [(e.key, e.self_device_time_total / 1e3 / calls)
                       for e in largest]


def _grad_relerr(ga, gb):
    """|ga - gb| / |gb| over all gradient leaves together."""
    num = sum(float(((a.cpu().double() - b.cpu().double()) ** 2).sum())
              for a, b in zip(ga, gb))
    den = sum(float((b.cpu().double() ** 2).sum()) for b in gb)
    return math.sqrt(num / max(den, 1e-30))


def phase3_slice():
    """grid_mll value and gradient, CUDA (kernels) against CPU (plain
    versions), J=20, m=256, D=11, n=32768, identical params and data.

    Evaluated at the spec's grid_jitter and at 1e-4, both held to the bar.
    At the spec's, the Toeplitz pivots of the base level sit at f32
    rounding, where cuSOLVER (the CUDA probe) and LAPACK (the CPU probe)
    may pick different ladder levels for a block; the line says whether
    they did. At 1e-4 every block factors at the base level on both, so
    the two devices must make the same choices there.

    The 512x512 leaves that the CUDA runs hand K1 (the diagonal blocks of
    the p x p C factor) are kept, and the cooperative kernel is held bit
    for bit, ok flags included, against the one-block kernel on each."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import block_chol, cuda_chol, grid_solve
    from rpagp_torch.utils.config import load_spec

    spec = load_spec(SPEC).model
    n, D = 32768, 11
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(n, D, generator=gen)
    Wd = torch.randn(D, 11, generator=gen) / math.sqrt(D)
    y = torch.sin(x @ Wd).sum(1) / math.sqrt(11) + 0.1 * torch.randn(
        n, generator=gen)
    params0, buf0 = exact_gp.init_model(spec, D, generator=gen, device="cpu")

    def to(tree, d):  # fresh leaf copies on device d
        return {k: to(v, d) if isinstance(v, dict) else v.to(d, copy=True)
                for k, v in tree.items()}

    prepared = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        b = exact_gp.prepare_buffers(spec, to(params0, d), to(buf0, d),
                                     x.to(d), y_train=y.to(d))
        prepared[d] = (b, x.to(d), y.to(d), time.perf_counter() - t0)

    c_leaves = []

    def recording(A):  # block_chol's K1 call, keeping each CUDA leaf
        if A.is_cuda:
            c_leaves.append(A.detach().clone())
        return cuda_chol.chol_linv(A)

    for jitter in (spec.grid_jitter, 1e-4):
        sp = dataclasses.replace(spec, grid_jitter=jitter)
        out = {}
        for d, (b, xd, yd, _) in prepared.items():
            p = to(params0, d)
            leaves = [p["raw_noise"], p["mean_const"],
                      p["kernel"]["raw_lengthscale"],
                      p["kernel"]["raw_outputscale"]]
            for t in leaves:
                t.requires_grad_(True)
            grid_solve.reset_stats()
            t0 = time.perf_counter()
            block_chol.chol_linv = recording
            try:
                v = grid_solve.grid_mll(sp, p, b, xd, yd)
            finally:
                block_chol.chol_linv = cuda_chol.chol_linv
            v.backward()
            out[d] = (float(v.detach()), [t.grad for t in leaves],
                      grid_solve.stats["t_levels"].cpu(),
                      float(grid_solve.stats["c_level"]),
                      time.perf_counter() - t0)
        (vg, gg, tg, cg, sg), (vc, gc, tc, cc, sc) = out["cuda"], out["cpu"]
        erel = abs(vg - vc) / abs(vc)
        grel = _grad_relerr(gg, gc)
        same = torch.equal(tg, tc) and cg == cc
        say(3, f"grid_mll J={spec.kernel.J} m={spec.kernel.grid_size} D={D} "
               f"n={n} grid_jitter {jitter:g}: "
               f"value cuda {vg:.8g} cpu {vc:.8g} rel {erel:.2e}; grad relerr "
               f"{grel:.2e}; T-ladder levels cuda {sorted(set(tg.tolist()))} "
               f"cpu {sorted(set(tc.tolist()))}, the same per block {same}; "
               f"C level cuda {cg} cpu {cc}; step {sg:.2f} s cuda, {sc:.2f} s "
               f"cpu (prepare {prepared['cuda'][3]:.1f} s cuda, "
               f"{prepared['cpu'][3]:.1f} s cpu)")
        if jitter != spec.grid_jitter:
            check(same, "ladder levels differ between CUDA and CPU")
        check(erel <= 1e-5, f"grid_mll value rel {erel:.2e} > 1e-5")
        check(grel <= 1e-4, f"grid_mll grad relerr {grel:.2e} > 1e-4")

    check(len(c_leaves) > 0, "no K1 leaf on the CUDA grid_mll runs")
    oks, same = [], 0
    for A in c_leaves:
        L, Li, ok = cuda_chol.chol_linv_cuda(A[None], "chol_linv")
        L1, Li1, ok1 = cuda_chol.chol_linv_cuda(A[None], cuda_chol.ONE_BLOCK)
        oks.append((int(ok), int(ok1)))
        same += torch.equal(L, L1) and torch.equal(Li, Li1)
    say(3, f"{len(c_leaves)} C-factor leaves {tuple(c_leaves[0].shape)} of the "
           f"CUDA grid_mll runs: ok flags cooperative kernel "
           f"{[a for a, _ in oks]}, one-block kernel {[b for _, b in oks]}; "
           f"bit for bit equal on {same}/{len(c_leaves)}")
    check(all(a == b for a, b in oks),
          "C-factor leaves: ok flags differ between the K1 kernels")
    check(same == len(c_leaves), "C-factor leaves: the K1 kernels differ")


def _taps(tf, m):
    """Every point's four taps as csrc/interp.cu taps() computes them:
    weights (J, n, 4), cells (J, n, 4), and whether each is kept (cell on
    the grid, point not padding)."""
    import torch

    fl = torch.floor(tf)
    f = tf - fl
    g = 1.0 - f

    def inner(s):
        return ((1.5 * s - 2.5) * s) * s + 1.0

    def outer(s):
        return ((-0.5 * s + 2.5) * s - 4.0) * s + 2.0

    w = torch.stack([outer(1.0 + f), inner(f), inner(g), outer(1.0 + g)], -1)
    cells = fl.clamp(-16, m + 16).long()[..., None] - 1 + torch.arange(
        4, device=tf.device)
    kept = ((tf > -8.0) & (tf < m + 8.0))[..., None] & (cells >= 0) & (
        cells < m)
    return w, cells, kept


def k2_c_entry_ms(tf, V, m, iters):
    """K2's ms by CUDA events through its C entry, the wrapper's chunk,
    scratch and output allocated outside the timed calls (these launches
    are not counted), and the output of the last call."""
    import torch

    from rpagp_torch.ops import _build, cuda_interp

    J, n = tf.shape
    t = V.shape[1]
    chunk = cuda_interp.transpose_chunk(J, n, t, m)
    part = torch.empty(-(-n // chunk) * J * t * m, device=tf.device)
    U = torch.empty(J, t, m, device=tf.device)
    lib, stream = _build.lib(), _build.stream_ptr(tf.device)

    def call():
        err = lib.rpagp_interp_transpose(
            tf.data_ptr(), V.data_ptr(), part.data_ptr(), U.data_ptr(), J, n,
            t, m, chunk, stream)
        check(err == 0, f"K2's C entry refused the call: {err}")

    return cuda_ms(call, iters=iters), U


def k2_yardsticks(tf, V, m, plain, scatter=True):
    """K2's library yardsticks on the same inputs, each built outside the
    timed call: torch.sparse.mm (cuSPARSE SpMM) of W^T as a CSR matrix
    (J m, n) times V, the same function once W is built; and, where its
    taps fit on the card (scatter=True), index_add_ of the taps' products
    w V[i] (kept taps, t) into (J m, t) (atomics, not the same function).
    Returns {name: (ms, rel against the plain version's `plain`)}."""
    import torch

    J, n = tf.shape
    t = V.shape[1]
    iters = 3 if t >= 512 else 10
    w, cells, kept = _taps(tf, m)
    dev = tf.device
    rows = (torch.arange(J, device=dev)[:, None, None] * m + cells)[kept]
    cols = torch.arange(n, device=dev)[None, :, None].expand(J, n, 4)[kept]
    vals = w[kept]
    del w, cells, kept
    W = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (J * m, n),
                                check_invariants=False
                                ).coalesce().to_sparse_csr()

    def spmm():
        return torch.sparse.mm(W, V)

    out = {"sparse.mm": (cuda_ms(spmm, iters=iters),
                         rel(spmm().view(J, m, t).transpose(1, 2), plain))}
    del W
    if scatter:
        src = vals[:, None] * V[cols]
        acc = torch.zeros(J * m, t, device=dev)

        def add():
            return acc.zero_().index_add_(0, rows, src)

        out["index_add_"] = (cuda_ms(add, iters=iters),
                             rel(add().view(J, m, t).transpose(1, 2), plain))
        del src, acc
    return out


def embedding_bag_ms(tf, G, plain):
    """K3's yardstick: one `embedding_bag` call (mode "sum") over the taps
    precomputed outside the timed call, a bag of 4 J rows j m + cell of
    the (J m, t) table of G a point, a tap off the grid at row 0 with
    weight 0 (not the same function: K3 computes its taps). Returns its
    ms and its rel against the plain version's `plain`."""
    import torch

    J, n = tf.shape
    t, m = G.shape[1], G.shape[2]
    w, cells, kept = _taps(tf, m)
    jj = torch.arange(J, device=tf.device)[:, None, None]
    idx = torch.where(kept, jj * m + cells, 0).permute(1, 0, 2).reshape(
        n, 4 * J)
    wts = torch.where(kept, w, 0.0).permute(1, 0, 2).reshape(n, 4 * J)
    del w, cells, kept
    table = G.permute(0, 2, 1).reshape(J * m, t).contiguous()

    def bag():
        return torch.nn.functional.embedding_bag(
            idx, table, per_sample_weights=wts, mode="sum")

    e = rel(bag(), plain)
    return cuda_ms(bag, iters=10), e


def k2_on_split(tf, tf_test, results):
    """K2 on the flagship split's own tfrac (projected data crowding the
    grid's middle, unlike phase 2's uniform points) at the paths' widths:
    t = 2 (prepare's U^T [y, 1]), 1 (the posterior), 8, 9 (every SKI +
    BBMM CG iteration, the flagship's 8 probes and y) and 512, 513 (the
    LOVE posterior's cross MVMs at love_rank, love_rank + 1): rel vs plain,
    bit-for-bit repeats, the K2/K3 adjoint, padding and points far beyond
    the grid adding nothing; timed by CUDA events through the C entry
    beside the bound and, at t = 1, 9 and 512, the library yardsticks
    (`k2_yardsticks`; index_add_'s taps do not fit at t = 512). Then K3 at
    t = 1 on the split's tfrac and on its test tfrac (n_test), beside
    `embedding_bag` over precomputed taps (not the same function)."""
    import torch

    from rpagp_torch.ops import cuda_interp

    J, n = tf.shape
    m = 256
    gen = torch.Generator().manual_seed(4)
    occupied = torch.bincount(torch.floor(tf[0]).long().clamp(0, m - 1),
                              minlength=m)
    say(4, f"the split's tfrac (J={J}, n={n}): component 0's busiest cell "
           f"holds {int(occupied.max())} points ({100 * float(occupied.max()) / n:.2f}%), "
           f"its 16 busiest {100 * float(occupied.sort().values[-16:].sum()) / n:.1f}%")
    beyond = torch.tensor([-1e6, -1e4, -50.0, -3.0, -2.001, m + 1.001,
                           m + 1.5, m + 7.0, m + 1e4, 1e6], device=tf.device)
    by_width = results["interp_transpose"].setdefault("on_split", {})
    for t in (2, 1, 8, 9, 512, 513):
        V = torch.randn(n, t, generator=gen).to(tf.device)
        G = torch.randn(J, t, m, generator=gen).to(tf.device)
        before = cuda_interp.launches["interp_transpose"]
        U = cuda_interp.interp_transpose_cuda(tf, V, m)
        check(cuda_interp.launches["interp_transpose"] - before == 1,
              f"K2 at t={t}: not one launch")
        Up = cuda_interp.interp_transpose_plain(tf, V, m)
        O = cuda_interp.interp_apply_sum_cuda(tf, G)
        torch.cuda.synchronize()
        e = rel(U, Up)
        check(e <= 1e-5, f"K2 on the split's tfrac t={t}: rel {e:.2e}")
        check(torch.equal(cuda_interp.interp_transpose_cuda(tf, V, m), U),
              f"K2 on the split's tfrac t={t}: not bit-identical on a repeat")
        adj = abs(float(torch.sum(U.double() * G.double()))
                  - float(torch.sum(V.double() * O.double()))) / float(
            torch.linalg.norm(U.double()) * torch.linalg.norm(G.double()))
        check(adj <= 1e-5, f"K2/K3 adjoint on the split's tfrac {adj:.2e}")
        del O, G
        tfp, Vp = tf.clone(), V.clone()
        tfp[:, -1000:] = -100.0
        tfp[:, 100:110] = beyond
        Vp[-1000:] = 1e6
        Vp[100:110] = 1e6
        check(torch.equal(cuda_interp.interp_transpose_cuda(tfp, Vp, m),
                          cuda_interp.interp_transpose_cuda(tfp, V, m)),
              f"K2 t={t}: padding or points beyond the grid contribute on "
              f"the split's tfrac")
        del tfp, Vp
        ms, Uc = k2_c_entry_ms(tf, V, m, iters=3 if t >= 512 else 20)
        check(torch.equal(Uc, U), f"K2 t={t}: the C entry differs from the "
                                  f"wrapper")
        bms, bby, _ = bound(4 * (J * n + n * t + J * t * m),
                            flops=2 * 4 * J * n * t)
        before_ms = {1: K2_BEFORE_T1_MS, 9: K2_T9_BEFORE_MS,
                     512: K2_T512_BEFORE_MS}.get(t)
        line = (f"K2 on the split's tfrac t={t} (one launch): rel {e:.2e}, "
                f"repeats bit for bit, adjoint {adj:.1e}, padding and 10 "
                f"points beyond the grid exact; {ms:.4f} ms (C entry), bound "
                f"{bms:.4f} ms ({bby})"
                + (f"; the kernel before this design {before_ms} ms, PERF.md"
                   if before_ms else ""))
        row = dict(ms=ms, bound_ms=bms, bound_by=bby, max_abs_err=max_abs(U, Up))
        if t in (1, 9, 512):
            yard = k2_yardsticks(tf, V, m, Up, scatter=t < 512)
            line += "; " + ", ".join(
                f"{k} {v[0]:.4f} ms (rel {v[1]:.1e})" for k, v in yard.items())
            line += " (built outside the timed call)"
            row["library_ms"] = yard["sparse.mm"][0]
            row["index_add_ms"] = yard.get("index_add_", (None,))[0]
        by_width[t] = row
        say(4, line)
        del U, Up, Uc, V
    # the same shape in turns: the split's tfrac, uniform points, and the
    # split's tfrac sorted per component (each lane's points then share
    # cells: back-to-back read-modify-writes of one word)
    V = torch.randn(n, 1, generator=gen).to(tf.device)
    kinds = {"split": tf,
             "uniform": (1.0 + (m - 4.0) * torch.rand(J, n, generator=gen)
                         ).to(tf.device),
             "sorted": torch.sort(tf, dim=1).values.contiguous()}
    turns = [(k, cuda_ms(lambda: cuda_interp.interp_transpose_cuda(
        kinds[k], V, m), iters=20))
        for k in ("split", "uniform", "sorted", "sorted", "uniform", "split")]
    say(4, "K2 t=1 in turns: " + ", ".join(f"{k} {v:.4f} ms" for k, v in turns))

    # K3 at the path's width (t = 1): on the split's tfrac (prepare's Vq0)
    # and its test tfrac (the posterior mean, n_test; four copies taken in
    # turn, so that each call reads its 16 MB from HBM, not from L2)
    for label, x in (("tfrac", tf), ("test tfrac", tf_test)):
        nx = x.shape[1]
        G = torch.randn(J, 1, m, generator=gen).to(tf.device)
        O = cuda_interp.interp_apply_sum_cuda(x, G)
        Op = cuda_interp.interp_apply_sum_plain(x, G)
        e = rel(O, Op)
        check(e <= 1e-5, f"K3 on the split's {label}: rel {e:.2e}")
        check(torch.equal(cuda_interp.interp_apply_sum_cuda(x, G), O),
              f"K3 on the split's {label}: not bit-identical on a repeat")
        xp = x.clone()
        xp[:, -1000:] = -100.0
        check(bool((cuda_interp.interp_apply_sum_cuda(xp, G)[-1000:] == 0)
                   .all()), f"K3 padding rows not zero on the split's {label}")
        copies = [x] if nx == n else [x.clone() for _ in range(4)]
        turn = [0]

        def k3():
            turn[0] += 1
            return cuda_interp.interp_apply_sum_cuda(
                copies[turn[0] % len(copies)], G)

        ms = cuda_ms(k3, iters=20)
        bms, _, _ = bound(4 * (J * nx + nx + J * m), flops=2 * 4 * J * nx)
        line = (f"K3 on the split's {label} t=1 (n={nx}): rel {e:.2e}, "
                f"repeats bit for bit, padding exact; {ms:.4f} ms, bound "
                f"{bms:.4f} ms")
        if nx == n:
            lms, el = embedding_bag_ms(x, G, Op)
            line += (f"; embedding_bag over precomputed taps (not the same "
                     f"function) {lms:.4f} ms, rel {el:.2e}")
        say(4, line)
    turns = [(k, cuda_ms(lambda: cuda_interp.interp_apply_sum_cuda(
        kinds[k], G), iters=20))
        for k in ("split", "uniform", "sorted", "sorted", "uniform", "split")]
    say(4, "K3 t=1 in turns: " + ", ".join(f"{k} {v:.4f} ms" for k, v in turns))


# phase 4's run_split of the flagship, for phase 12's distributed run
_PHASE4 = {}


def _run_split_losses(runner, *args, **kw):
    """(runner.run_split(*args, **kw), its training losses): the losses
    taken from the trainer's result as it returns."""
    real, losses = runner.train_to_convergence, []

    def trainer(*a, **k):
        res = real(*a, **k)
        losses.extend(res.losses)
        return res

    runner.train_to_convergence = trainer
    try:
        return runner.run_split(*args, **kw), losses
    finally:
        runner.train_to_convergence = real


def phase4_main_path(results):
    import torch

    from rpagp_torch import runner
    from rpagp_torch.mll import mll
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_chol, cuda_interp, grid_solve, ski
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=10))
    t0 = time.perf_counter()
    split = _split("houseelectric")
    say(4, f"synthetic HouseElectric split 0: train {split.train_x.shape}, "
           f"test {split.test_x.shape}, made in {time.perf_counter() - t0:.1f} s")
    check(split.train_x.shape[0] == N_FLAGSHIP_TRAIN, "unexpected n_train")

    counters = (cuda_chol.launches, cuda_interp.launches)
    for c in counters:
        for k in c:
            c[k] = 0
    grid_solve.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    m, losses = _run_split_losses(runner, exp, split, seed=0, device=dev,
                                  timings=timings)
    torch.cuda.synchronize()
    launches = {**cuda_chol.launches, **cuda_interp.launches}
    stats = dict(grid_solve.stats)
    peak = torch.cuda.max_memory_allocated()
    # factors in the run: one per training step, one in the posterior and
    # one in the runner's factor_diagnostics
    n_factor = m["iterations"] + 2
    say(4, f"run_split: prepare {timings['prepare_s']:.2f} s, train "
           f"{timings['train_s']:.2f} s ({m['iterations']} steps), posterior "
           f"{timings['posterior_s']:.2f} s; rmse {m['rmse']:.4f} nll "
           f"{m['nll']:.4f} mll {m['mll']:.5f}; host reads "
           f"{stats['host_reads']} over {n_factor} factorizations "
           f"({stats['host_reads'] / n_factor:.2f} each); ladder escalations "
           f"T {stats['t_escalations']} C {stats['c_escalations']}; last "
           f"T levels {sorted(set(stats['t_levels'].tolist()))} C "
           f"{float(stats['c_level'])}; peak memory {peak / 2**30:.2f} GiB; "
           f"launches {launches}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
        results[k]["launches"] = v
        results[k].setdefault("launches_by_path", {})["grid"] = v
    _PHASE4.update(losses=losses, rmse=m["rmse"])
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(m["rmse"] < 0.9, f"rmse {m['rmse']:.4f} >= 0.9: learned nothing")

    # 5 more training steps at the flagship size, timed per step
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    gen = torch.Generator().manual_seed(0)
    params, buffers = exact_gp.init_model(exp.model, x.shape[1], generator=gen,
                                          device=dev)
    buffers = exact_gp.prepare_buffers(exp.model, params, buffers, x, y_train=y)
    # the test tfrac as grid_posterior builds it: a grid over the union of
    # the train and test projections
    xt = torch.as_tensor(split.test_x, device=dev)
    kspec, kp, kb = exp.model.kernel, params["kernel"], buffers["kernel"]
    z, zt = (ski.project(kspec, kp, kb, a) for a in (x, xt))
    span = (torch.minimum(z.amin(1), zt.amin(1)),
            torch.maximum(z.amax(1), zt.amax(1)))
    tf_test = ski.build_ski(kspec, kp, kb, xt, kspec.grid_size,
                            z_bounds=span).tfrac
    del z, zt
    k2_on_split(buffers["ski_state"].tfrac, tf_test, results)
    leaves = [params["raw_noise"], params["mean_const"],
              *params["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=exp.train.lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -mll(exp.model, params, buffers, x, y) / n
        loss.backward()
        opt.step()
        return loss

    grid_solve.reset_stats()
    events = []
    for _ in range(6):  # the first is a warm-up
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss = step()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events[1:]]
    med = statistics.median(step_ms)
    say(4, f"5 extra steps: median {med:.2f} ms/step "
           f"(all {', '.join(f'{v:.2f}' for v in step_ms)}); host reads "
           f"{grid_solve.stats['host_reads'] / 6:.2f}/step; loss "
           f"{float(loss.detach()):.5f}")
    busy, by = _device_ms(step, 3, ("chol_linv_coop_kernel",))
    if busy == 0:
        say(4, "torch.profiler recorded no device time: the step's device "
               "breakdown is not measured")
    else:
        k1 = by["chol_linv_coop_kernel"]
        say(4, f"torch.profiler over 3 more steps: device busy {busy:.2f} "
               f"ms/step (idle {100 * (1 - busy / med):.0f}% of the {med:.2f} "
               f"ms step); K1's cooperative kernel (ten leaves and the ladder "
               f"batch) {k1:.2f} ms/step ({100 * k1 / busy:.1f}% of device "
               f"time)")
    grid_posteriors(exp.model, params, buffers, x, y, xt)


def grid_posteriors(spec, params, buffers, x, y, xt):
    """The grid path's other posteriors at the params of the timed steps:
    make_grid_predictor on the test fold against grid_posterior (another
    grid: the train range extended by half its span each side, so close,
    not equal), grid_posterior_cov on 512 test points (its diagonal
    against grid_posterior's variance on the same points, symmetry, a
    Cholesky with the observation noise), and factor_diagnostics against
    the ladder levels the last grid_mll chose."""
    import torch

    from rpagp_torch.ops import cuda_chol, grid_solve

    params = {k: ({kk: vv.detach() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.detach())
              for k, v in params.items()}
    yt = torch.as_tensor(_split("houseelectric").test_y, device=x.device)
    with torch.no_grad():
        mu, var = grid_solve.grid_posterior(spec, params, buffers, x, y, xt)
        _zero([cuda_chol.launches])
        t0 = time.perf_counter()
        predict = grid_solve.make_grid_predictor(spec, params, buffers, x, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mu_p, var_p = predict(xt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k1 = dict(cuda_chol.launches)
        mu_p2, _ = predict(xt)
        em, ev = rel(mu_p, mu), rel(var_p, var)
        rmse = float(torch.sqrt(torch.mean((mu - yt) ** 2)))
        rmse_p = float(torch.sqrt(torch.mean((mu_p - yt) ** 2)))
        say(4, f"make_grid_predictor: factor {t1 - t0:.2f} s (K1 launches "
               f"{k1}), a {xt.shape[0]}-point batch {t2 - t1:.2f} s; against "
               f"grid_posterior on the test fold: mean rel {em:.2e}, variance "
               f"rel {ev:.2e}; rmse {rmse_p:.4f} (grid_posterior's "
               f"{rmse:.4f}); repeat bit for bit {torch.equal(mu_p2, mu_p)}")
        check(k1["chol_linv"] > 0 and k1["chol_linv_batched"] > 0,
              f"the grid predictor's factor ran no K1: {k1}")
        check(em <= 1e-2 and ev <= 1e-4, f"the grid predictor against "
              f"grid_posterior: mean rel {em:.2e}, variance rel {ev:.2e}")
        check(torch.equal(mu_p2, mu_p), "the grid predictor not repeatable")

        xs = xt[:512]
        mu_c, cov = grid_solve.grid_posterior_cov(spec, params, buffers, x, y,
                                                  xs, observation_noise=True)
        mu_s, var_s = grid_solve.grid_posterior(spec, params, buffers, x, y,
                                                xs)
        ed, emc = rel(torch.diagonal(cov), var_s), rel(mu_c, mu_s)
        sym = torch.equal(cov, cov.T)
        chol_ok = bool(torch.linalg.cholesky_ex(cov).info == 0)
        say(4, f"grid_posterior_cov on 512 test points: diagonal against "
               f"grid_posterior's variance rel {ed:.2e}, mean rel {emc:.2e}; "
               f"exactly symmetric {sym}; Cholesky with the observation "
               f"noise succeeds {chol_ok}")
        check(ed <= 1e-4 and emc <= 1e-4, f"grid_posterior_cov against "
              f"grid_posterior: {ed:.2e}, {emc:.2e}")
        check(sym and chol_ok, "grid_posterior_cov not symmetric PD")

        grid_solve.grid_mll(spec, params, buffers, x, y)
        t_lv = float(torch.max(grid_solve.stats["t_levels"]))
        c_lv = float(grid_solve.stats["c_level"])
        diag = grid_solve.factor_diagnostics(spec, params, buffers)
        say(4, f"factor_diagnostics {diag}; the ladder levels of the last "
               f"grid_mll: T x{t_lv:.6g}, C {c_lv:.3g} * noise")
        check(diag == {"t_jitter_mult_max": t_lv, "c_jitter_over_noise": c_lv},
              "factor_diagnostics disagrees with the ladders' levels")


def _gram_case(n, m, t, J, gen, dev):
    """Projected coordinates at the scale of z-scored data through a
    gaussian projection, weights softplus(0) / J, as at initialisation."""
    import torch

    z1 = torch.randn(n, J, generator=gen).to(dev)
    z2 = torch.randn(m, J, generator=gen).to(dev)
    w = torch.full((J,), math.log(2.0) / J, device=dev)
    V = torch.randn(m, t, generator=gen).to(dev)
    G = torch.randn(n, t, generator=gen).to(dev)
    return z1, z2, w, V, G


def _gram_bound(n, m, t, J, backward=False):
    """K4: n m J exps, 2 n m (J + t) f32 ops (the TPU kernel's own cost
    estimate), z1, z2, w, V in and out once; K5: the same exps,
    2 n m (2 J + t) ops, G in and dz, dw out besides."""
    if backward:
        return bound(4 * (2 * n * J + m * J + 2 * J + m * t + n * t),
                     flops=2 * n * m * (2 * J + t), exps=n * m * J)
    return bound(4 * (n * J + m * J + J + m * t + n * t),
                 flops=2 * n * m * (J + t), exps=n * m * J)


def _sass_loops(text):
    """The loops of one function's SASS (cuobjdump -sass): a list of
    (first, last) instruction indices, one per backward branch, and the
    opcodes in order."""
    import re

    ops, addr, labels, branches = [], {}, {}, []
    pending = []
    for line in text.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not ins:
            continue
        for name in pending:
            labels[name] = len(ops)
        pending = []
        words = ins.group(2).split()
        op = words[1] if words[0].startswith("@") else words[0]
        addr[int(ins.group(1), 16)] = len(ops)
        if op.startswith("BRA"):
            tgt = re.search(r"`\((\.L_x_\d+)\)|0x([0-9a-f]+)", ins.group(2))
            if tgt:
                branches.append((len(ops), tgt.group(1) or int(tgt.group(2), 16)))
        ops.append(op)
    loops = []
    for src, tgt in branches:
        first = labels.get(tgt) if isinstance(tgt, str) else addr.get(tgt)
        if first is not None and first <= src:
            loops.append((first, src))
    return loops, ops


def sass_mix(library, fn_key):
    """The instruction mix of a kernel's inner loop from the built
    library's SASS (cuobjdump -sass), for one instantiation (K4's or K5's
    at rbf, t = 11, the training shape): the innermost loop that holds
    MUFU.EX2, the loop over components. Returns a dict, or None where
    cuobjdump is missing or no such loop is found."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300).stdout
    for chunk in re.split(r"\n\s+Function : ", out):
        name = chunk.split("\n", 1)[0]
        if fn_key not in name:
            continue
        loops, ops = _sass_loops(chunk)
        with_ex2 = [lp for lp in loops
                    if any(o.startswith("MUFU.EX2") for o in ops[lp[0]:lp[1] + 1])]
        if not with_ex2:
            return None
        first, last = min(with_ex2, key=lambda lp: lp[1] - lp[0])
        body = ops[first:last + 1]
        mix = collections.Counter(o.split(".")[0] if not o.startswith("MUFU")
                                  else o for o in body)
        return {"function": name.strip(), "instructions": len(body),
                "mufu_ex2": mix.get("MUFU.EX2", 0),
                "mix": dict(mix.most_common())}
    return None


# K4's times before its redesign, by label: the first design (one 64-row
# block per SM wave, accurate expf, the Gram recomputed per 32 columns of
# V), PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W
K4_BEFORE_MS = {"train": "1.599-1.612", "posterior CG/Lanczos": "1.332-1.514",
                "cross K*Q": "1.795-1.810"}
# K5's time before its redesign (the first port: accurate expf, per-component
# sums in local memory, one 64-row block per SM wave), the training shape,
# PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W
K5_BEFORE_MS = "2.392-2.413"
SASS_KEYS = {"K4": "gram_mvm_narrow_kernelILi0ELi12E",
             "K5": "gram_mvm_bwd_kernelILi0ELi12E"}


def phase5_gram_kernels(results):
    """K4 / K5 against their plain versions at the BBMM path's shapes;
    first the instruction mix of K4's inner loop at the training shape.
    Then K6 / K7 against their float64 twins at the dense path's shapes."""
    import torch

    from rpagp_torch.ops import _build
    from rpagp_torch.ops import cuda_gram as cg

    for kernel, key in SASS_KEYS.items():
        mix = sass_mix(_build.library_path(), key)
        if mix is None:
            say(5, f"{kernel}'s SASS: not read (no cuobjdump, or no loop with "
                   f"MUFU.EX2 found)")
            continue
        per = mix["instructions"] / max(mix["mufu_ex2"], 1)
        say(5, f"{kernel}'s SASS ({mix['function']}): the loop over "
               f"components holds {mix['instructions']} instructions, "
               f"{mix['mufu_ex2']} of them MUFU.EX2, {per:.2f} an exp "
               f"({mix['mix']}); the exp unit takes 8 issue cycles of a "
               f"sub-partition per warp MUFU.EX2, so below 8 an exp this "
               f"loop alone is bound by the exp unit, not by issue")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    n, nt, J = N_ELEVATORS_TRAIN, N_ELEVATORS_TEST, 10
    cases = [("train", n, n, 11, "rbf"), ("posterior CG/Lanczos", n, n, 1, "rbf"),
             ("cross K*Q", nt, n, 256, "rbf"), ("small", 2000, 1500, 11,
                                                 "matern32")]
    for label, rows, cols, t, base in cases:
        z1, z2, w, V, G = _gram_case(rows, cols, t, J, gen, dev)
        out = cg.gram_mvm_cuda(z1, z2, w, V, base)
        outp = cg.gram_mvm_plain(z1, z2, w, V, base)
        torch.cuda.synchronize()
        e = rel(out, outp)
        check(e <= 1e-5, f"K4 {label}: rel {e:.2e}")
        check(torch.equal(out, cg.gram_mvm_cuda(z1, z2, w, V, base)),
              f"K4 {label}: not bit-identical on a repeat")
        ms = cuda_ms(lambda: cg.gram_mvm_cuda(z1, z2, w, V, base))
        pms = cuda_ms(lambda: cg.gram_mvm_plain(z1, z2, w, V, base), iters=2)
        bms, bby, term = _gram_bound(rows, cols, t, J)
        plan = cg.gram_mvm_plan(rows, cols, J, t, base, dev)
        line = (f"K4 {label} ({rows}, {cols}, J={J}, t={t}, {base}): rel "
                f"{e:.2e}, repeats bit for bit; {ms:.4f} ms (grid G = "
                f"{plan[0]}, {plan[1]} z2 chunks) vs plain {pms:.3f} ms, "
                f"bound {bms:.3f} ms ({term})")
        if label in K4_BEFORE_MS:
            line += f"; the first design {K4_BEFORE_MS[label]} ms"
        if label == "train":
            results["gram_mvm"] = dict(max_abs_err=max_abs(out, outp), ms=ms,
                                       plain_ms=pms, bound_ms=bms,
                                       bound_by=bby, library_ms=None)
        # K5 at every case: against the plain version in float32 and in
        # float64 (the 1e-5 bar is held against the latter)
        dz, dw = cg.gram_mvm_bwd_cuda(z1, z2, w, V, G, base)
        dzp, dwp = cg.gram_mvm_bwd_plain(z1, z2, w, V, G, base)
        dz64, dw64 = cg.gram_mvm_bwd_plain(
            *(a.double() for a in (z1, z2, w, V, G)), base)
        torch.cuda.synchronize()
        ez, ew = rel(dz, dz64), rel(dw, dw64)
        check(ez <= 1e-5 and ew <= 1e-5,
              f"K5 {label}: rel dz {ez:.2e} dw {ew:.2e}")
        for _ in range(3):
            dz2, dw2 = cg.gram_mvm_bwd_cuda(z1, z2, w, V, G, base)
            check(torch.equal(dz, dz2) and torch.equal(dw, dw2),
                  f"K5 {label}: not bit-identical on a repeat")
        line += (f"; K5 rel dz {ez:.2e} dw {ew:.2e} (vs the float32 plain "
                 f"{rel(dz, dzp):.2e} {rel(dw, dwp):.2e}), repeats bit for "
                 f"bit")
        if label == "train":
            ms5 = cuda_ms(lambda: cg.gram_mvm_bwd_cuda(z1, z2, w, V, G, base))
            pms5 = cuda_ms(lambda: cg.gram_mvm_bwd_plain(z1, z2, w, V, G, base),
                           iters=2)
            bms5, bby5, term5 = _gram_bound(rows, cols, t, J, backward=True)
            results["gram_mvm_bwd"] = dict(
                max_abs_err=max(max_abs(dz, dzp), max_abs(dw, dwp)), ms=ms5,
                plain_ms=pms5, bound_ms=bms5, bound_by=bby5, library_ms=None)
            plan5 = cg.gram_mvm_bwd_plan(rows, cols, J, t, base, dev)
            line += (f"; {ms5:.4f} ms (grid G = {plan5[0]}, {plan5[1]} z2 "
                     f"chunks) vs plain {pms5:.3f} ms, bound {bms5:.3f} ms "
                     f"({term5}); the first design {K5_BEFORE_MS} ms")
            # gradients through the autograd.Function against the plain VJP
            ts = [a.clone().requires_grad_(True) for a in (z1, z2, w, V)]
            cg.projected_gram_mvm(*ts, base).backward(G)
            plain = (cg.gram_mvm_bwd_plain(z1, z2, w, V, G, base)[0],
                     cg.gram_mvm_bwd_plain(z2, z1, w, G, V, base)[0],
                     dwp, cg.gram_mvm_plain(z2, z1, w, G, base))
            errs = [rel(a.grad, b) for a, b in zip(ts, plain)]
            check(max(errs) <= 1e-4, f"K4/K5 gradients rel {errs}")
            line += ("; autograd.Function grads dz1/dz2/dw/dV rel "
                     + "/".join(f"{x:.2e}" for x in errs))
        say(5, line)

    # K6 / K7 at the exact cell's K(x, x) and its predictor's cross Gram
    # (J 20 on sml: n 3,723, n_test 414), RBF, against the float64 twins
    from gpbench.counts import gram as gram_counts

    J = 20
    for label, rows, cols in (("K(x, x)", N_SML_TRAIN, N_SML_TRAIN),
                              ("cross K(x*, x)", N_SML_TEST, N_SML_TRAIN)):
        same = rows == cols
        u1 = (1.5 * torch.randn(J, rows, generator=gen)).to(dev)
        u2 = u1 if same else (1.5 * torch.randn(J, cols, generator=gen)).to(dev)
        w = torch.full((J,), math.log(2.0) / J, device=dev)
        G = torch.randn(rows, cols, generator=gen).to(dev)
        before = dict(cg.launches)
        K = cg.dense_gram_cuda(u1, u2, w)
        du1, du2, dw = cg.dense_gram_bwd_cuda(u1, u2, w, G)
        torch.cuda.synchronize()
        check(cg.launches["dense_gram"] - before["dense_gram"] == 1
              and cg.launches["dense_gram_bwd"] - before["dense_gram_bwd"] == 1,
              f"K6 / K7 {label}: not one launch each at J = {J}")
        a1, aw, aG = u1.double(), w.double(), G.double()
        a2 = a1 if same else u2.double()
        K64 = cg.dense_gram_plain(a1, a2, aw)
        p1, p2, pw = cg.dense_gram_bwd_plain(a1, a2, aw, aG)
        if same:  # du1 is then the whole gradient of the coordinates
            p1 = p1 + p2
        errs = {"K": rel(K, K64), "du1": rel(du1, p1), "dw": rel(dw, pw)}
        if not same:
            errs["du2"] = rel(du2, p2)
        check(max(errs.values()) <= 1e-5, f"K6 / K7 {label}: rel {errs}")
        check(torch.equal(K, cg.dense_gram_cuda(u1, u2, w)),
              f"K6 {label}: not bit-identical on a repeat")
        check(not same or torch.equal(K, K.T),
              f"K6 {label}: K(x, x) not exactly symmetric")
        for _ in range(2):
            r1, r2, rw = cg.dense_gram_bwd_cuda(u1, u2, w, G)
            check(torch.equal(du1, r1) and torch.equal(dw, rw)
                  and (same or torch.equal(du2, r2)),
                  f"K7 {label}: not bit-identical on a repeat")
        ms6 = cuda_ms(lambda: cg.dense_gram_cuda(u1, u2, w))
        ms7 = cuda_ms(lambda: cg.dense_gram_bwd_cuda(u1, u2, w, G))
        pms6 = cuda_ms(lambda: cg.dense_gram_plain(u1, u2, w), iters=2)
        pms7 = cuda_ms(lambda: cg.dense_gram_bwd_plain(u1, u2, w, G), iters=2)
        # counts/gram.py's bytes and f32 operations, and one exp a value
        b6, b7 = (bound(*gram_counts.work(J, rows, cols, d),
                        exps=J * rows * cols) for d in ("fwd", "bwd"))
        say(5, f"K6 / K7 {label} ({rows}, {cols}, J={J}, rbf): rel "
               + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
               + f" against the float64 twins, repeat bit for bit; K6 "
               f"{ms6:.4f} ms vs plain {pms6:.3f} ms, K7 {ms7:.4f} ms vs "
               f"plain {pms7:.3f} ms; bound {b6[0]:.4f} / {b7[0]:.4f} ms "
               f"({b6[2]})")
        if same:
            results["dense_gram"] = dict(
                max_abs_err=max_abs(K, K64), ms=ms6, plain_ms=pms6,
                bound_ms=b6[0], bound_by=b6[1], library_ms=None)
            results["dense_gram_bwd"] = dict(
                max_abs_err=max(max_abs(du1, p1), max_abs(dw, pw)), ms=ms7,
                plain_ms=pms7, bound_ms=b7[0], bound_by=b7[1],
                library_ms=None)
        del K, K64, G, aG


def phase6_bbmm_mll():
    """iterative_mll value and gradient at J=10, D=18, n=4096 elevators
    rows, CUDA (K4/K5) against CPU (the blocked plain MVM), the same
    params, projection and probe normals on both devices."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import iterative
    from rpagp_torch.ops.exact import LOG_2PI
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    spec = load_spec(SPEC_BBMM).model
    n = 4096
    split = next(datasets.kfold_splits(datasets.load_dataset("elevators"),
                                       k=10, seed=0, equal_train=True))
    x = torch.as_tensor(split.train_x[:n])
    y = torch.as_tensor(split.train_y[:n])
    gen = torch.Generator().manual_seed(6)
    params0, buf0 = exact_gp.init_model(spec, x.shape[1], generator=gen,
                                        device="cpu")
    eps_small = torch.randn(spec.precond_rank, spec.num_probes, generator=gen)
    eps_big = torch.randn(n, spec.num_probes, generator=gen)

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d, copy=True)
                for k, v in tree.items()}

    out = {}
    for d in ("cuda", "cpu"):
        p = to(params0, d)
        leaves = [p["raw_noise"], p["mean_const"],
                  *p["kernel"].values()]
        for t in leaves:
            t.requires_grad_(True)
        stats = {}
        t0 = time.perf_counter()
        iq, ld = iterative.inv_quad_logdet_eps(
            spec, p, to(buf0, d), x.to(d), y.to(d), eps_small.to(d),
            eps_big.to(d), stats=stats)
        v = -0.5 * (iq + ld + n * LOG_2PI)
        v.backward()
        out[d] = (float(v.detach()), [t.grad for t in leaves],
                  (stats["cg"].alphas == 0).cpu(), time.perf_counter() - t0)
    (vg, gg, fg, sg), (vc, gc, fc, sc) = out["cuda"], out["cpu"]
    erel = abs(vg - vc) / abs(vc)
    grel = _grad_relerr(gg, gc)
    say(6, f"iterative_mll J={spec.kernel.J} D={x.shape[1]} n={n}: value cuda "
           f"{vg:.8g} cpu {vc:.8g} rel {erel:.2e}; grad relerr {grel:.2e}; "
           f"CG masks froze the same columns at the same iterations "
           f"{torch.equal(fg, fc)} (frozen iterations per column cuda "
           f"{fg.sum(0).tolist()} cpu {fc.sum(0).tolist()}); value+grad "
           f"{sg:.2f} s cuda, {sc:.2f} s cpu")
    check(erel <= 1e-4, f"iterative_mll value rel {erel:.2e} > 1e-4")
    check(grel <= 1e-3, f"iterative_mll grad relerr {grel:.2e} > 1e-3")


def _count_syncs(fn):
    """Run fn() with CUDA sync debugging on: the device->host
    synchronizations it made (each warns once), as {site: count}, a site
    being the innermost lines of this repository and of torch that led
    to it. The sync of switching the mode back is not fn's and is left
    out."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "warnings" not in f.filename]
        if any(f.name == "set_sync_debug_mode" for f in frames):
            return  # restoring the mode at the end syncs once itself
        ours = [f for f in frames if f.filename.startswith(ROOT)]
        shown = ours[-1:] + [f for f in frames
                             if f"{os.sep}torch{os.sep}" in f.filename][-1:]
        sites[" < ".join(f"{os.path.basename(f.filename)}:{f.lineno} "
                         f"{f.name}" for f in shown[::-1])] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sites)


def phase7_bbmm_main_path(results):
    """The BBMM path through run_split on rp_bbmm_elevators, elevators split
    0 (n_train 14,939, n_test 1,660): max_iters cut from 300 to 50 to fit
    the smoke run; then timed training steps at the same size."""
    import torch

    from rpagp_torch import runner
    from rpagp_torch.mll import mll
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_gram, iterative
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC_BBMM)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=50))
    split = next(datasets.kfold_splits(datasets.load_dataset("elevators"),
                                       k=10, seed=0, equal_train=True))
    check(split.train_x.shape[0] == N_ELEVATORS_TRAIN
          and split.test_x.shape[0] == N_ELEVATORS_TEST,
          f"unexpected elevators split {split.train_x.shape}")
    for k in cuda_gram.launches:
        cuda_gram.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings)
    torch.cuda.synchronize()
    launches = dict(cuda_gram.launches)
    peak = torch.cuda.max_memory_allocated()
    say(7, f"run_split rp_bbmm_elevators (max_iters 50 of 300): prepare "
           f"{timings['prepare_s']:.2f} s, train {timings['train_s']:.2f} s "
           f"({m['iterations']} steps), posterior {timings['posterior_s']:.2f}"
           f" s; rmse {m['rmse']:.4f} nll {m['nll']:.4f} mll {m['mll']:.5f}; "
           f"peak memory {peak / 2**30:.2f} GiB; launches {launches}")
    # K4 / K5 carry the BBMM MLL; the preconditioner's pivot rows are K6's
    # one-row Grams, and nothing differentiates a dense Gram there (no K7)
    for k in ("gram_mvm", "gram_mvm_bwd"):
        check(launches[k] > 0, f"kernel {k} was not launched on the BBMM path")
        results[k]["launches"] = launches[k]
        results[k].setdefault("launches_by_path", {})["bbmm"] = launches[k]
    check(launches["dense_gram"] > 0, "no K6 pivot row on the BBMM path")
    for k in ("dense_gram", "dense_gram_bwd"):
        results[k].setdefault("launches_by_path", {})["bbmm"] = launches[k]
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(m["rmse"] < 0.9, f"rmse {m['rmse']:.4f} >= 0.9: learned nothing")

    # training steps at the same size: syncs counted, then 5 timed
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    params, buffers = exact_gp.init_model(exp.model, x.shape[1],
                                          generator=torch.Generator()
                                          .manual_seed(0), device=dev)
    leaves = [params["raw_noise"], params["mean_const"],
              *params["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=exp.train.lr)
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -mll(exp.model, params, buffers, x, y, gen) / n
        loss.backward()
        opt.step()
        return loss

    step()  # warm-up
    syncs = _count_syncs(step)
    for k in cuda_gram.launches:
        cuda_gram.launches[k] = 0
    events = []
    for _ in range(5):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        opt.zero_grad(set_to_none=True)
        loss = -mll(exp.model, params, buffers, x, y, gen) / n
        e1.record()
        loss.backward()
        opt.step()
        e2.record()
        events.append((e0, e1, e2))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(c) for a, _, c in events]
    fwd_ms = statistics.median(a.elapsed_time(b) for a, b, _ in events)
    per_step = {k: v / 5 for k, v in cuda_gram.launches.items()}
    with torch.no_grad():
        noise = exact_gp.noise_value(params)
        pre_ms = cuda_ms(lambda: iterative._build_pre(exp.model, params,
                                                      buffers, x, noise),
                         iters=3)
    say(7, f"5 timed steps: median {statistics.median(step_ms):.2f} ms/step "
           f"(all {', '.join(f'{v:.2f}' for v in step_ms)}; forward median "
           f"{fwd_ms:.2f} ms, the rest backward + Adam); rank-"
           f"{exp.model.precond_rank} preconditioner alone {pre_ms:.2f} ms; "
           f"launches per step {per_step}; device->host syncs in one step "
           f"{sum(syncs.values())} {syncs} "
           f"(run_split's trainer adds one loss read per 8 steps); loss "
           f"{float(loss.detach()):.5f}")


def _dense_split(max_points=None):
    from rpagp_torch.utils import datasets

    ds = datasets.load_dataset("sml", max_points=max_points)
    return next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))


def _zero(counters):
    for c in counters:
        for k in c:
            c[k] = 0


def phase8_dense_main_path(results):
    """The dense Cholesky path through run_split on rp_poly_j20 (J = 20
    degree-1 RBF components, gaussian projection), synthetic sml split 0
    (n_train 3723, D = 26, n_test 414): max_iters cut from 1000 to 10.
    Every MLL forward factors K + s^2 I (padded to 4096) with eight K1
    leaves. Then at the same size: the steps' syncs, times and device
    breakdown, the factor against cuSOLVER, the CUDA MLL against the
    port's float64 CPU one, and the other dense specs at n_train ~1000."""
    import torch

    from rpagp_torch import runner
    from rpagp_torch.mll import mll
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import block_chol, cuda_chol, cuda_gram, exact, kernels
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC_DENSE)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=10))
    split = _dense_split()
    check(split.train_x.shape == (N_SML_TRAIN, 26)
          and split.test_x.shape[0] == N_SML_TEST,
          f"unexpected sml split {split.train_x.shape}")
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    # the loss at run_split's initial params (the same seed, projection and
    # data): the first step's loss
    params, buffers = exact_gp.init_model(
        exp.model, x.shape[1], generator=torch.Generator().manual_seed(0),
        device=dev)
    with torch.no_grad():
        loss0 = float(-mll(exp.model, params, buffers, x, y) / n)

    _zero([cuda_chol.launches, cuda_gram.launches])
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings)
    torch.cuda.synchronize()
    launches = {**cuda_chol.launches, **cuda_gram.launches}
    peak = torch.cuda.max_memory_allocated()
    forwards = m["iterations"] + 1  # the training steps and the posterior
    say(8, f"run_split rp_poly_j20 on sml split 0 (n_train {n}, n_test "
           f"{split.test_x.shape[0]}, max_iters 10 of 1000): prepare "
           f"{timings['prepare_s']:.3f} s, train {timings['train_s']:.3f} s "
           f"({m['iterations']} steps), posterior {timings['posterior_s']:.3f}"
           f" s; rmse {m['rmse']:.4f} (the JAX package on the CPU, 10 steps, "
           f"projection key 0: {JAX_RMSE_SML_10}) nll {m['nll']:.4f}; loss "
           f"{loss0:.5f} at the first step, best {-m['mll']:.5f}; peak memory "
           f"{peak / 2**30:.2f} GiB; launches {launches} over {forwards} "
           f"factorizations")
    check(launches["chol_linv"] == 8 * forwards,
          f"K1 leaf launches {launches['chol_linv']} != 8 x {forwards}")
    check(launches["chol_linv_batched"] == 0, "ladder batch on the dense path")
    results["chol_linv"].setdefault("launches_by_path", {})["dense"] = \
        launches["chol_linv"]
    # K6: each step's K(x, x), the posterior's K(x, x) and its cross Gram;
    # K7: each step's backward
    steps = m["iterations"]
    check(launches["dense_gram"] == steps + 2
          and launches["dense_gram_bwd"] == steps,
          f"K6 / K7 launches {launches['dense_gram']} / "
          f"{launches['dense_gram_bwd']} for {steps} steps and a posterior")
    for k in ("dense_gram", "dense_gram_bwd"):
        results[k]["launches"] = launches[k]
        results[k].setdefault("launches_by_path", {})["dense"] = launches[k]
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(-m["mll"] < loss0, f"the loss did not fall: best {-m['mll']:.5f} "
                             f"first {loss0:.5f}")
    check(m["rmse"] < 1.0, f"rmse {m['rmse']:.4f} >= 1.0: learned nothing")

    # training steps at the same size: K1 launches and syncs of one step,
    # then 5 timed (CUDA events) and 3 under torch.profiler
    leaves = [params["raw_noise"], params["mean_const"],
              *params["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=exp.train.lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -mll(exp.model, params, buffers, x, y) / n
        loss.backward()
        opt.step()
        return loss

    step()  # warm-up
    _zero([cuda_chol.launches, cuda_gram.launches])
    syncs = _count_syncs(step)
    check(cuda_chol.launches["chol_linv"] == 8,
          f"{cuda_chol.launches['chol_linv']} K1 launches in one step, not 8")
    check(cuda_gram.launches["dense_gram"] == 1
          and cuda_gram.launches["dense_gram_bwd"] == 1,
          f"K6 / K7 launches in one step {cuda_gram.launches}, not 1 / 1")
    torch.cuda.reset_peak_memory_stats()
    events = []
    for _ in range(5):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        opt.zero_grad(set_to_none=True)
        loss = -mll(exp.model, params, buffers, x, y) / n
        e1.record()
        loss.backward()
        opt.step()
        e2.record()
        events.append((e0, e1, e2))
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(c) for a, _, c in events]
    med = statistics.median(step_ms)
    fwd = statistics.median(a.elapsed_time(b) for a, b, _ in events)
    say(8, f"5 timed steps: median {med:.2f} ms/step (all "
           f"{', '.join(f'{v:.2f}' for v in step_ms)}; forward median "
           f"{fwd:.2f} ms, the rest backward + Adam); peak memory of a step "
           f"{step_peak / 2**30:.2f} GiB; launches in one step: K1 8, K6 1, "
           f"K7 1; "
           f"device->host syncs in one step {sum(syncs.values())} {syncs}")
    check(sum(syncs.values()) == 0, f"host reads in the dense step: {syncs}")
    busy, by, largest = _device_ms(step, 3, ("chol_linv_coop_kernel",),
                                   top=8)
    if busy == 0:
        say(8, "torch.profiler recorded no device time: the step's device "
               "breakdown is not measured")
    else:
        k1 = by["chol_linv_coop_kernel"]
        say(8, f"torch.profiler over 3 more steps: device busy {busy:.2f} "
               f"ms/step (idle {100 * (1 - busy / med):.0f}% of the "
               f"{med:.2f} ms step); K1's eight leaves {k1:.2f} ms/step "
               f"({100 * k1 / busy:.1f}% of device time); the largest "
               f"kernels, ms/step: "
               + "; ".join(f"{k[:70]} {v:.3f}" for k, v in largest))

    # the dense Khat on the card: symmetry, and the factor against cuSOLVER
    # (cholesky_ex, the same function) as a yardstick
    with torch.no_grad():
        kspec, kp, kb = exp.model.kernel, params["kernel"], buffers["kernel"]
        Khat = exact.add_jitter(kernels.gram(kspec, kp, kb, x, x),
                                exact_gp.noise_value(params),
                                exp.model.jitter)
        asym = float(torch.max(torch.abs(Khat - Khat.T)))
        xr = x[:, :8] / 4.0
        Kr = kernels.gram(kernels.KernelSpec(family="rbf"),
                          {"raw_lengthscale": torch.zeros(8, device=dev),
                           "raw_outputscale": torch.zeros((), device=dev)},
                          {}, xr, xr)
        asym_r = float(torch.max(torch.abs(Kr - Kr.T)))
        L = block_chol.blocked_cholesky(Khat)
        Lc = torch.linalg.cholesky_ex(Khat).L
        torch.cuda.synchronize()
        eL = rel(L, Lc)
        res_b, res_c = rel(L @ L.T, Khat), rel(Lc @ Lc.T, Khat)
        turns = [(f, cuda_ms(f, iters=10)) for f in (
            lambda: block_chol.blocked_cholesky(Khat),
            lambda: torch.linalg.cholesky_ex(Khat)) * 2]
        bms = statistics.mean(t for i, (_, t) in enumerate(turns) if i % 2 == 0)
        cms = statistics.mean(t for i, (_, t) in enumerate(turns) if i % 2 == 1)
    with torch.no_grad():
        fbusy, fby, flargest = _device_ms(
            lambda: block_chol.blocked_cholesky(Khat), 3,
            ("chol_linv_coop_kernel",), top=6)
    say(8, f"blocked_cholesky under torch.profiler: device {fbusy:.3f} ms a "
           f"call, K1's leaves {fby['chol_linv_coop_kernel']:.3f}; the "
           f"largest kernels, ms a call: "
           + "; ".join(f"{k[:70]} {v:.3f}" for k, v in flargest))
    say(8, f"Khat ({n}, {n}) on the card: exactly symmetric "
           f"{asym == 0.0} (max |K - K^T| {asym:.1e}; the full-D rbf Gram "
           f"by the sqdist GEMM: {asym_r == 0.0}, {asym_r:.1e}); "
           f"blocked_cholesky (8 K1 leaves, padded to 4096) in turns "
           f"{', '.join(f'{t:.3f}' for i, (_, t) in enumerate(turns) if i % 2 == 0)}"
           f" ms against cuSOLVER cholesky_ex "
           f"{', '.join(f'{t:.3f}' for i, (_, t) in enumerate(turns) if i % 2 == 1)}"
           f" ms (means {bms:.3f}, {cms:.3f}); rel L vs cuSOLVER's {eL:.2e}, "
           f"|LL^T - Khat|/|Khat| {res_b:.2e} (cuSOLVER's {res_c:.2e})")
    check(res_b <= 1e-5, f"blocked_cholesky residual {res_b:.2e}")
    del Khat, L, Lc, Kr

    # one CUDA value+grad against the port's float64 CPU computation of the
    # same inputs (run_split's initial params, projection and data)
    p0, b0 = exact_gp.init_model(exp.model, x.shape[1],
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")

    def to(tree, d, dtype):
        return {k: to(v, d, dtype) if isinstance(v, dict)
                else v.to(d, dtype, copy=True) for k, v in tree.items()}

    out = {}
    for d, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        p, b = to(p0, d, dtype), to(b0, d, dtype)
        lv = [p["raw_noise"], p["mean_const"], *p["kernel"].values()]
        for t in lv:
            t.requires_grad_(True)
        t0 = time.perf_counter()
        v = exact_gp.exact_mll(exp.model, p, b,
                               torch.as_tensor(split.train_x).to(d, dtype),
                               torch.as_tensor(split.train_y).to(d, dtype))
        v.backward()
        out[d] = (float(v.detach()), [t.grad for t in lv],
                  time.perf_counter() - t0)
    (vg, gg, sg), (vc, gc, sc) = out["cuda"], out["cpu"]
    erel = abs(vg - vc) / abs(vc)
    grel = _grad_relerr(gg, gc)
    say(8, f"exact_mll J=20 D=26 n={n}: value cuda f32 {vg:.8g} cpu f64 "
           f"{vc:.10g} rel {erel:.2e}; grad relerr {grel:.2e}; value+grad "
           f"{sg:.2f} s cuda, {sc:.2f} s cpu")
    check(erel <= 1e-5, f"exact_mll value rel {erel:.2e} > 1e-5")
    check(grel <= 1e-4, f"exact_mll grad relerr {grel:.2e} > 1e-4")

    # every other dense spec: 3 steps and a posterior at n_train ~1000
    # (above 512, so K1 factors the leaves)
    small = _dense_split(max_points=1111)
    ns = small.train_x.shape[0]
    for name in DENSE_OTHERS:
        e = load_spec(os.path.join(ROOT, "specs", f"{name}.json"))
        e = dataclasses.replace(e, train=dataclasses.replace(e.train,
                                                             max_iters=3))
        _zero([cuda_chol.launches])
        t0 = time.perf_counter()
        r = runner.run_split(e, small, seed=0, device=dev)
        torch.cuda.synchronize()
        k1 = cuda_chol.launches["chol_linv"]
        say(8, f"{name} on sml (n_train {ns}): rmse {r['rmse']:.4f} nll "
               f"{r['nll']:.4f} mll {r['mll']:.5f}, {r['iterations']} steps "
               f"+ posterior in {time.perf_counter() - t0:.2f} s; K1 leaves "
               f"{k1}")
        for k in ("rmse", "nll"):
            check(math.isfinite(r[k]), f"{name}: {k} not finite")
        check(k1 == 2 * (r["iterations"] + 1),
              f"{name}: {k1} K1 leaves for {r['iterations']} steps")


# the K2 and K3 kernels' names in csrc/interp.cu, for torch.profiler
K2_NAMES = ("transpose_own_kernel", "transpose_slots_kernel",
            "reduce_partials_kernel")
K3_NAMES = ("apply_sum_shifted_kernel", "apply_sum_rows_kernel")
SPEC_SKI_SML = os.path.join(ROOT, "specs", "rp_poly_j20_ski.json")
_SPLITS = {}  # data made once per run: name -> split 0


def _split(name):
    from rpagp_torch.utils import datasets

    if name not in _SPLITS:
        ds = datasets.load_dataset(name)
        _SPLITS[name] = next(datasets.kfold_splits(ds, k=10, seed=0,
                                                   equal_train=True))
    return _SPLITS[name]


def hold_interp(phase, label, tf, m, t, gen, tf_out=None, far=False):
    """K2 (W^T V on tf's points) and K3 (sum_j W_j G_j on tf_out's points,
    tf's when None) at width t against their plain versions: rel <= 1e-5,
    bit-for-bit repeats, K2 in one launch; far=True puts 11 points of tf
    and tf_out far beyond the grid (the -100 padding among them) and holds
    their rows at exact zero (K3) and their values out of U (K2). Both
    timed by CUDA events beside their bounds, K2 through its C entry.
    Returns the results of both (ms, plain_ms, bound_ms, max_abs_err)."""
    import torch

    from rpagp_torch.ops import cuda_interp

    dev = tf.device
    tf_out = tf if tf_out is None else tf_out
    J, n = tf.shape
    n_out = tf_out.shape[1]
    if far:
        tf, tf_out = tf.clone(), tf_out.clone()
        beyond = torch.tensor([-1e6, -1e4, -100.0, -50.0, -3.0, -2.001,
                               m + 1.001, m + 1.5, m + 7.0, m + 1e4, 1e6],
                              device=dev)
        tf[:, 100:111] = beyond
        tf_out[:, 100:111] = beyond
    V = torch.randn(n, t, generator=gen).to(dev)
    G = torch.randn(J, t, m, generator=gen).to(dev)
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    O = cuda_interp.interp_apply_sum_cuda(tf_out, G)
    Up = cuda_interp.interp_transpose_plain(tf, V, m)
    Op = cuda_interp.interp_apply_sum_plain(tf_out, G)
    torch.cuda.synchronize()
    eU, eO = rel(U, Up), rel(O, Op)
    check(eU <= 1e-5 and eO <= 1e-5,
          f"K2/K3 {label} t={t}: rel {eU:.2e} {eO:.2e}")
    check(torch.equal(cuda_interp.interp_transpose_cuda(tf, V, m), U),
          f"K2 {label} t={t}: not bit-identical on a repeat")
    check(torch.equal(cuda_interp.interp_apply_sum_cuda(tf_out, G), O),
          f"K3 {label} t={t}: not bit-identical on a repeat")
    line = ""
    if far:
        V2 = V.clone()
        V2[100:111] = 1e6
        check(torch.equal(cuda_interp.interp_transpose_cuda(tf, V2, m), U),
              f"K2 {label}: points beyond the grid contribute")
        check(bool((O[100:111] == 0).all()) and bool((Op[100:111] == 0).all()),
              f"K3 {label}: points beyond the grid are not zero")
        line = "; 11 points beyond the grid: K3 rows exactly 0, K2 ignores them"
    before = cuda_interp.launches["interp_transpose"]
    cuda_interp.interp_transpose_cuda(tf, V, m)
    check(cuda_interp.launches["interp_transpose"] - before == 1,
          f"K2 {label} t={t}: not one launch")
    ms_t, _ = k2_c_entry_ms(tf, V, m, iters=3 if t >= 512 else 10)
    ms_a = cuda_ms(lambda: cuda_interp.interp_apply_sum_cuda(tf_out, G),
                   iters=10)
    pms_t = cuda_ms(lambda: cuda_interp.interp_transpose_plain(tf, V, m),
                    iters=1)
    pms_a = cuda_ms(lambda: cuda_interp.interp_apply_sum_plain(tf_out, G),
                    iters=1)
    # tfrac, V in and U out (K2), or tfrac, G in and out (K3); 4 taps per
    # point and component, one FMA per column each
    b_t, by_t, _ = bound(4 * (J * n + n * t + J * t * m),
                         flops=2 * 4 * J * n * t)
    b_a, by_a, _ = bound(4 * (J * n_out + n_out * t + J * t * m),
                         flops=2 * 4 * J * n_out * t)
    say(phase, f"K2 {label} (J={J}, n={n}, m={m}, t={t}, one launch): rel "
               f"{eU:.2e}, {ms_t:.4f} ms (C entry) vs plain {pms_t:.3f}"
               f" ms, bound {b_t:.4f} ms ({by_t}); K3 (n={n_out}): rel "
               f"{eO:.2e}, {ms_a:.4f} ms vs plain {pms_a:.3f} ms, bound "
               f"{b_a:.4f} ms ({by_a}); repeats bit for bit{line}")
    return {"interp_transpose": dict(ms=ms_t, plain_ms=pms_t, bound_ms=b_t,
                                     max_abs_err=max_abs(U, Up)),
            "interp_apply_sum": dict(ms=ms_a, plain_ms=pms_a, bound_ms=b_a,
                                     max_abs_err=max_abs(O, Op))}


def _same_and_finite(out, ref):
    """(same, non-finite count): K1 outputs `out` (L, Linv, ok) equal
    `ref` bit for bit, and how many of out's values are not finite (0 by
    K1's failure contract, also where a matrix fails)."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(out, ref))
    return same, sum(int((~torch.isfinite(a)).sum()) for a in out)


def _timed_steps(step, steps, refresh_at=None, refresh=None):
    """Run `steps` training steps (step() returns after backward and the
    optimizer), each timed by CUDA events, forward apart: (step ms list,
    forward ms list, refresh ms or None). refresh() runs before step
    `refresh_at`, timed on its own."""
    import torch

    events, rev = [], None
    for i in range(steps):
        if i == refresh_at:
            r0, r1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            r0.record()
            refresh()
            r1.record()
            rev = (r0, r1)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        step(e)
        events.append(e)
    torch.cuda.synchronize()
    return ([a.elapsed_time(c) for a, _, c in events],
            [a.elapsed_time(b) for a, b, _ in events],
            None if rev is None else rev[0].elapsed_time(rev[1]))


def _adam_step(spec, params, buffers, x, y, gen):
    """(leaves, step(events)) of the trainer's step on the MLL: events
    (start, after forward, end) recorded around it."""
    import torch

    from rpagp_torch.mll import mll

    n = x.shape[0]
    leaves = [params["raw_noise"], params["mean_const"],
              *params["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=0.1)

    def step(ev=None):
        if ev:
            ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss = -mll(spec, params, buffers[0], x, y, gen) / n
        if ev:
            ev[1].record()
        loss.backward()
        opt.step()
        if ev:
            ev[2].record()
        return loss

    return leaves, step


def phase9_ski_bbmm(results):
    """SKI + BBMM at full width: (a) rp_poly_j20_ski on synthetic sml split
    0 (n_train 3723, D = 26, J = 20, m = 512, p = 10,240 > _P_MAX, so SKI +
    BBMM at any n; cg 100, rank 15, 10 probes): K2 and K3 at m = 512,
    t = 11 on the split's tfrac; the CUDA iterative MLL against the
    port's CPU one on the same probe normals; the same model on the exact
    grid solver (forced, p = 10,240; K1's (20, 512, 512) ladder batch held
    against the one-block kernel); run_split for 10 steps, then timed
    steps. (b) the flagship spec with solver="bbmm" (the paper's
    HouseElectric configuration: cg 20, rank 15, precond_refresh 10, 8
    probes, love_rank 512) on the full synthetic split (n_train
    1,844,352) for 20 steps (cut from 100): the cached preconditioner
    from step 10, the LOVE posterior at rank 512, the gap to grid_mll."""
    phase9a_ski_bbmm_sml(results)
    phase9b_ski_bbmm_houseelectric(results)


def phase9a_ski_bbmm_sml(results):
    """Phase 9 (a): rp_poly_j20_ski on synthetic sml split 0."""
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import (cuda_chol, cuda_gram, cuda_interp,
                                 grid_solve, iterative)
    from rpagp_torch.ops.exact import LOG_2PI
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    counters = (cuda_chol.launches, cuda_interp.launches, cuda_gram.launches)
    exp = load_spec(SPEC_SKI_SML)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=10))
    spec = exp.model
    m_grid = spec.kernel.grid_size
    split = _dense_split()
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    check(n == N_SML_TRAIN, f"unexpected sml split {split.train_x.shape}")
    check(not grid_solve.use_grid_solver(spec, n), "sml SKI spec takes the "
          "grid solver")
    p0, b0 = exact_gp.init_model(spec, x.shape[1],
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    params, kbuf = _to(p0, dev), _to(b0, dev)
    buffers = exact_gp.prepare_buffers(spec, params, kbuf, x, y_train=y)
    check(sorted(buffers) == ["kernel", "ski_state"],
          f"SKI + BBMM buffers {sorted(buffers)}")
    tf = buffers["ski_state"].tfrac
    hold_interp(9, "on sml's tfrac (every CG iteration)", tf, m_grid,
                spec.num_probes + 1, gen, far=True)

    # the CUDA MLL against the port's CPU one: run_split's initial params,
    # projection and data, the same probe normals (the CPU side, the plain
    # interpolation's dense (20, 3723, 512) W twice a CG iteration, on
    # every core)
    eps_small = torch.randn(spec.precond_rank, spec.num_probes, generator=gen)
    eps_big = torch.randn(n, spec.num_probes, generator=gen)
    threads = torch.get_num_threads()
    out = {}
    for d in ("cuda", "cpu"):
        torch.set_num_threads(os.cpu_count() if d == "cpu" else threads)
        p, b = _to(p0, d), _to(b0, d)
        xd, yd = x.to(d), y.to(d)
        b = exact_gp.prepare_buffers(spec, p, b, xd)
        lv = [p["raw_noise"], p["mean_const"], *p["kernel"].values()]
        for t in lv:
            t.requires_grad_(True)
        stats = {}
        t0 = time.perf_counter()
        iq, ld = iterative.inv_quad_logdet_eps(spec, p, b, xd, yd,
                                               eps_small.to(d),
                                               eps_big.to(d), stats=stats)
        v = -0.5 * (iq + ld + n * LOG_2PI)
        v.backward()
        out[d] = (float(v.detach()), [t.grad for t in lv],
                  (stats["cg"].alphas == 0).cpu(), time.perf_counter() - t0)
    torch.set_num_threads(threads)
    (vg, gg, fg, sg), (vc, gc, fc, sc) = out["cuda"], out["cpu"]
    erel, grel = abs(vg - vc) / abs(vc), _grad_relerr(gg, gc)
    say(9, f"iterative_mll SKI J={spec.kernel.J} m={m_grid} n={n}: value cuda {vg:.8g} cpu "
           f"{vc:.8g} rel {erel:.2e}; grad relerr {grel:.2e}; CG froze the "
           f"same iterations {torch.equal(fg, fc)} (per column cuda "
           f"{fg.sum(0).tolist()} cpu {fc.sum(0).tolist()}); value+grad "
           f"{sg:.2f} s cuda, {sc:.2f} s cpu ({os.cpu_count()} threads)")
    check(erel <= 1e-4, f"SKI iterative_mll value rel {erel:.2e} > 1e-4")
    check(grel <= 1e-3, f"SKI iterative_mll grad relerr {grel:.2e} > 1e-3")

    # the same model on the exact grid solver at the same params: p =
    # 10,240, K1's ladder batch at (20, 512, 512) and 20 leaves
    spec_g = dataclasses.replace(spec, solver="grid")
    bg = exact_gp.prepare_buffers(spec_g, params, kbuf, x, y_train=y)
    with torch.no_grad():
        T = grid_solve._toeplitz_blocks(spec.kernel, params["kernel"],
                                        bg["ski_state"])
        eye = torch.eye(m_grid, device=dev)
        levels = []
        for mult in grid_solve._LADDER:
            Tj = (T + (spec.grid_jitter * mult * T[:, 0, 0])[:, None, None]
                  * eye).contiguous()
            out = cuda_chol.chol_linv_cuda(Tj, "chol_linv_batched")
            ref = cuda_chol.chol_linv_cuda(Tj, cuda_chol.ONE_BLOCK)
            okp = cuda_chol.chol_linv_plain(Tj)[2]
            torch.cuda.synchronize()
            same, bad = _same_and_finite(out, ref)
            levels.append(f"x{mult:g}: ok {int(out[2].sum())}/{T.shape[0]} "
                          f"(one-block {int(ref[2].sum())}, cuSOLVER "
                          f"{int(okp.sum())}), {bad} non-finite outputs")
            check(same, f"K1 {tuple(T.shape)} at jitter x{mult:g}: not bit "
                        f"for bit the one-block kernel's")
            check(bad == 0, f"K1 {tuple(T.shape)} at jitter x{mult:g}: {bad} "
                            f"non-finite outputs")
        ms_b = cuda_ms(lambda: cuda_chol.chol_linv_cuda(Tj, "chol_linv_batched"))
        ms_o = cuda_ms(lambda: cuda_chol.chol_linv_cuda(Tj, cuda_chol.ONE_BLOCK),
                       iters=2)
        ms_c = cuda_ms(lambda: cuda_chol.chol_linv_plain(Tj))
        bms, bby, _ = bound(4 * 3 * T.numel(),
                            flops=T.shape[0] * 2 * m_grid**3 / 3)
        say(9, f"K1 ladder batch {tuple(T.shape)} on the sml SKI model's "
               f"Toeplitz blocks, every ladder level bit for bit the "
               f"one-block kernel's (L, Linv, ok) and every output finite, "
               f"failed blocks too: "
               f"{'; '.join(levels)}; at x{grid_solve._LADDER[-1]:g}: "
               f"{ms_b:.4f} ms vs one-block {ms_o:.4f} ms, cuSOLVER "
               f"{ms_c:.4f} ms, bound {bms:.4f} ms ({bby})")
        grid_solve.reset_stats()
        vgrid = float(grid_solve.grid_mll(spec_g, params, bg, x, y))
        vit = float(iterative.iterative_mll(spec, params, buffers, x, y,
                                            torch.Generator(device=dev)
                                            .manual_seed(1)))
    gap = abs(vit - vgrid) / n
    say(9, f"the same model on the exact grid solver (p = "
           f"{spec.kernel.J * m_grid}, forced): "
           f"grid_mll {vgrid:.6f}, iterative_mll {vit:.6f} (CUDA, seed 1), "
           f"{vg:.6f} (the normals above); per datum |iterative - grid| / n "
           f"{gap:.2e} (bar 5e-3); ladder escalations T "
           f"{grid_solve.stats['t_escalations']} C "
           f"{grid_solve.stats['c_escalations']}")
    check(gap <= 5e-3, f"SKI + BBMM vs grid per-datum gap {gap:.2e} > 5e-3")
    del bg, T, Tj, out, ref

    # run_split, then 5 timed steps at the same size
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if v}
    peak = torch.cuda.max_memory_allocated()
    say(9, f"run_split rp_poly_j20_ski on sml split 0 (max_iters 10 of 500): "
           f"prepare {timings['prepare_s']:.3f} s, train "
           f"{timings['train_s']:.3f} s ({m['iterations']} steps), posterior "
           f"{timings['posterior_s']:.3f} s (chunked CG); rmse "
           f"{m['rmse']:.4f} nll {m['nll']:.4f} mll {m['mll']:.5f}; peak "
           f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    for k in ("interp_transpose", "interp_apply_sum"):
        check(launches.get(k, 0) > 0, f"kernel {k} not launched on SKI + BBMM")
        results[k].setdefault("launches_by_path", {})["ski_bbmm"] = launches[k]
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(m["rmse"] < 1.0, f"rmse {m['rmse']:.4f} >= 1.0: learned nothing")

    gen_p = torch.Generator(device=dev).manual_seed(1)
    bufs = [buffers]
    _, step = _adam_step(spec, params, bufs, x, y, gen_p)
    step()  # warm-up
    syncs = _count_syncs(step)
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    step_ms, fwd_ms, _ = _timed_steps(step, 5)
    per_step = {k: v / 5 for c in counters for k, v in c.items() if v}
    step_peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms)
    busy, by = _device_ms(step, 2, K2_NAMES + K3_NAMES)
    k2 = sum(by[k] for k in K2_NAMES)
    k3 = sum(by[k] for k in K3_NAMES)
    say(9, f"5 timed steps: median {med:.2f} ms/step (all "
           f"{', '.join(f'{v:.2f}' for v in step_ms)}; forward median "
           f"{statistics.median(fwd_ms):.2f} ms); device busy {busy:.2f} "
           f"ms/step (idle {100 * (1 - busy / med):.0f}%), K2 {k2:.2f} ms "
           f"({100 * k2 / max(busy, 1e-9):.1f}%), K3 {k3:.2f} ms "
           f"({100 * k3 / max(busy, 1e-9):.1f}%); launches per step "
           f"{per_step}; device->host syncs in one step "
           f"{sum(syncs.values())} {syncs}; peak memory of a step "
           f"{step_peak / 2**30:.2f} GiB")


def phase9b_ski_bbmm_houseelectric(results):
    """Phase 9 (b): the flagship spec with solver="bbmm" on the full
    synthetic HouseElectric split."""
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import (cuda_chol, cuda_gram, cuda_interp,
                                 grid_solve, iterative)
    from rpagp_torch.ops.exact import LOG_2PI
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(10)
    counters = (cuda_chol.launches, cuda_interp.launches, cuda_gram.launches)
    exp = load_spec(SPEC)
    spec = dataclasses.replace(exp.model, solver="bbmm")
    exp = dataclasses.replace(exp, model=spec, train=dataclasses.replace(
        exp.train, max_iters=20))
    split = _split("houseelectric")
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    xt = torch.as_tensor(split.test_x, device=dev)
    n = x.shape[0]
    check(n == N_FLAGSHIP_TRAIN, "unexpected n_train")
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if v}
    peak = torch.cuda.max_memory_allocated()
    refreshes = m["refreshes"]
    say(9, f"run_split flagship spec, solver bbmm (max_iters 20 of 100), "
           f"HouseElectric split 0 (n_train {n}): prepare "
           f"{timings['prepare_s']:.2f} s, train {timings['train_s']:.2f} s "
           f"({m['iterations']} steps, {refreshes} preconditioner refresh), "
           f"posterior (LOVE rank 512) {timings['posterior_s']:.2f} s; rmse "
           f"{m['rmse']:.4f} nll {m['nll']:.4f} mll {m['mll']:.5f}; peak "
           f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    for k in ("interp_transpose", "interp_apply_sum"):
        check(launches.get(k, 0) > 0, f"kernel {k} not launched on the "
              "flagship's SKI + BBMM path")
        results[k].setdefault("launches_by_path",
                              {})["ski_bbmm_houseelectric"] = launches[k]
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(m["rmse"] < 0.9, f"rmse {m['rmse']:.4f} >= 0.9: learned nothing")
    check(refreshes == 1, f"{refreshes} preconditioner refreshes in 20 "
                          f"steps, not 1")

    # K2 / K3 at the path's shapes: every CG iteration (t = 9), the cross
    # MVMs of the posteriors at the spec's love_rank r (K2 on the train
    # points, K3 on the test points): t = r for run_split's LOVE posterior
    # (K_star Q), t = r + 1 for make_predictor ([alpha | Q]); points
    # beyond the grid
    params, kbuf = exact_gp.init_model(spec, x.shape[1],
                                       generator=torch.Generator()
                                       .manual_seed(0), device=dev)
    buffers = exact_gp.prepare_buffers(spec, params, kbuf, x, y_train=y)
    tf = buffers["ski_state"].tfrac
    m_grid = spec.kernel.grid_size
    st_tr, st_te = iterative._union_states(spec, params, buffers, x, xt)
    res9 = hold_interp(9, "on the flagship's tfrac (every CG iteration)", tf,
                       m_grid, spec.num_probes + 1, gen, far=True)
    say(9, f"the flagship's CG MVM at t = 9: K2 + K3 {res9['interp_transpose']['ms'] + res9['interp_apply_sum']['ms']:.3f} ms an iteration")
    for t in (spec.love_rank, spec.love_rank + 1):
        hold_interp(9, "posterior cross MVM (K2 on train, K3 on test)",
                    st_tr.tfrac, m_grid, t, gen, tf_out=st_te.tfrac, far=True)
    del st_tr, st_te
    del res9

    # 20 steps as the trainer takes them: the preconditioner built fresh in
    # steps 0-9, cached from step 10 on
    gen_p = torch.Generator(device=dev).manual_seed(1)
    bufs = [buffers]
    p_init = {k: ({kk: vv.clone() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.clone())
              for k, v in params.items()}
    _, step = _adam_step(spec, params, bufs, x, y, gen_p)

    def refresh():
        with torch.no_grad():
            bufs[0] = exact_gp.refresh_preconditioner(spec, params, bufs[0], x)

    _zero(counters)
    step_ms, fwd_ms, ref_ms = _timed_steps(step, 20, refresh_at=10,
                                           refresh=refresh)
    per_step = {k: v / 20 for c in counters for k, v in c.items() if v}
    syncs = _count_syncs(step)
    fresh_ms = statistics.median(step_ms[1:10])
    cached_ms = statistics.median(step_ms[10:])
    with torch.no_grad():
        noise = exact_gp.noise_value(params)
        pre_ms = cuda_ms(lambda: iterative._build_pre(spec, params, bufs[0],
                                                      x, noise), iters=3)
    busy, by = _device_ms(step, 2, K2_NAMES + K3_NAMES)
    k2 = sum(by[k] for k in K2_NAMES)
    k3 = sum(by[k] for k in K3_NAMES)
    say(9, f"20 timed steps: steps 1-9 (preconditioner built each step) "
           f"median {fresh_ms:.2f} ms/step, steps 10-19 (cached) median "
           f"{cached_ms:.2f} ms/step (all "
           f"{', '.join(f'{v:.1f}' for v in step_ms)}); forward median "
           f"{statistics.median(fwd_ms[1:10]):.2f} / "
           f"{statistics.median(fwd_ms[10:]):.2f} ms; the refresh "
           f"{ref_ms:.2f} ms, the rank-15 build alone {pre_ms:.2f} ms; device "
           f"busy {busy:.2f} ms/step (cached), K2 {k2:.2f} ms "
           f"({100 * k2 / max(busy, 1e-9):.1f}%), K3 {k3:.2f} ms "
           f"({100 * k3 / max(busy, 1e-9):.1f}%); launches per step "
           f"{per_step}; device->host syncs in one step "
           f"{sum(syncs.values())} {syncs}")

    # the gap to the exact grid solver, at the initial params and at those
    # after the 20 steps: the BBMM estimate at the spec's cg 20 and at 10x
    # the CG iterations (the same probe normals), the CG residuals
    spec_g = dataclasses.replace(spec, solver="grid")
    bg = exact_gp.prepare_buffers(spec_g, params, kbuf, x, y_train=y)
    gaps = {}
    for label, p, b in (("initial", p_init, buffers), ("after 20 steps",
                                                        params, bufs[0])):
        with torch.no_grad():
            p = {k: ({kk: vv.detach() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.detach())
                 for k, v in p.items()}
            vgrid = float(grid_solve.grid_mll(spec_g, p, bg, x, y))
            g2 = torch.Generator(device=dev).manual_seed(2)
            es = torch.randn(spec.precond_rank, spec.num_probes, generator=g2,
                             device=dev)
            eb = torch.randn(n, spec.num_probes, generator=g2, device=dev)
            line = []
            for cg in (spec.cg_max_iters, 10 * spec.cg_max_iters):
                stats = {}
                iq, ld = iterative.inv_quad_logdet_eps(
                    dataclasses.replace(spec, cg_max_iters=cg), p, b, x, y,
                    es, eb, stats=stats)
                vit = float(-0.5 * (iq + ld + n * LOG_2PI))
                r = stats["cg"].residual_norm
                gaps[(label, cg)] = abs(vit - vgrid) / n
                line.append(f"cg {cg}: iterative_mll {vit / n:.5f}/datum, "
                            f"gap {gaps[(label, cg)]:.2e}, CG relative "
                            f"residual y {float(r[0]):.1e} probes max "
                            f"{float(r[1:].max()):.1e}")
            say(9, f"against grid_mll at the {label} params (noise "
                   f"{float(exact_gp.noise_value(p)):.4g}): grid_mll "
                   f"{vgrid / n:.5f}/datum; " + "; ".join(line))
            check(math.isfinite(vgrid) and math.isfinite(vit),
                  "MLL not finite")
    say(9, f"per datum |iterative - grid| / n at the spec's cg "
           f"{spec.cg_max_iters}: {gaps[('initial', spec.cg_max_iters)]:.2e} "
           f"initial, {gaps[('after 20 steps', spec.cg_max_iters)]:.2e} after "
           f"20 steps (recorded; the sml model's bar is 5e-3)")


SPEC_PRODUCT = os.path.join(ROOT, "specs", "rp_ski_d2_j6.json")
SPEC_SVGP = os.path.join(ROOT, "specs", "svgp_m512.json")
N_PROTEIN_TRAIN, N_PROTEIN_TEST = 41_157, 4_573  # synthetic protein split 0
# test RMSE of the JAX package's run_split on the same splits, on the CPU
# with seed 0 (scripts/torch_jax_reference_rmse.py): rp_ski_d2_j6 on
# protein after 10 steps, svgp_m512 on elevators after its 50 epochs
JAX_RMSE_PROTEIN_D2_10 = 0.3435
JAX_RMSE_ELEVATORS_SVGP = 0.3542


def _to(tree, d):
    """A copy of a dict tree of tensors on device d."""
    return {k: _to(v, d) if isinstance(v, dict) else v.to(d, copy=True)
            for k, v in tree.items()}


def phase10_product_ski_and_svgp(results):
    """The last two specs: (a) K1's failure contract on indefinite blocks at
    b = 512; (b) product SKI, rp_ski_d2_j6 (J = 6 degree-2 RBF components,
    m = 16 per factor, M = 256, p = 1536 on the exact grid solver) on the
    full synthetic protein split 0; (c) SVGP, svgp_m512 (M = 512 inducing
    points, batch 1024, lr 0.01, 50 epochs) on the full elevators split 0."""
    phase10a_k1_failure_contract()
    phase10b_product_ski(results)
    phase10c_svgp()


def phase10a_k1_failure_contract():
    """Phase 10 (a): indefinite (512, 512) blocks through both K1 entry
    points: finite outputs, ok as cuSOLVER's cholesky_ex reports, bit for
    bit the one-block kernel's, L Linv = I to b eps."""
    import torch

    from rpagp_torch.ops import cuda_chol

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(10)
    b = 512
    eye = torch.eye(b, device=dev)
    A = _spd(4, b, gen, dev)
    # pivots 5 (panel 0) and 32 * 9 + 5 fail first; matrix 2 a symmetric
    # Gaussian matrix (indefinite from its first panels on); matrix 3 SPD
    for i, s0 in enumerate((5, 32 * 9 + 5)):
        A[i, s0:, s0:] -= 10.0 * eye[s0:, s0:]
    X = torch.randn(b, b, generator=gen).to(dev)
    A[2] = 0.5 * (X + X.mT)
    leaf = _spd(1, b, gen, dev)
    s0 = 32 * 15 + 5  # the first failing pivot in the last panel
    leaf[0, s0:, s0:] -= 10.0 * eye[s0:, s0:]
    lines = []
    for name, T in (("chol_linv_batched", A.contiguous()),
                    ("chol_linv", leaf.contiguous())):
        out = cuda_chol.chol_linv_cuda(T, name)
        ref = cuda_chol.chol_linv_cuda(T, cuda_chol.ONE_BLOCK)
        okp = (torch.linalg.cholesky_ex(T).info == 0).to(T.dtype)
        torch.cuda.synchronize()
        same, bad = _same_and_finite(out, ref)
        L, Linv = out[0].double(), out[1].double()
        res = torch.linalg.norm(L @ Linv - eye.double(), dim=(1, 2)) / (
            torch.linalg.norm(L, dim=(1, 2)) * torch.linalg.norm(Linv,
                                                                 dim=(1, 2)))
        check(same, f"K1 {name} {tuple(T.shape)} indefinite: not bit for bit "
                    f"the one-block kernel's")
        check(bad == 0, f"K1 {name} {tuple(T.shape)} indefinite: {bad} "
                        f"non-finite outputs")
        check(torch.equal(out[2], okp), f"K1 {name} ok {out[2].tolist()} vs "
                                        f"cuSOLVER {okp.tolist()}")
        check(float(res.max()) <= b * 2.0**-24,
              f"K1 {name}: |L Linv - I| {float(res.max()):.2e}")
        lines.append(f"{name} {tuple(T.shape)}: ok {out[2].tolist()} "
                     f"(cuSOLVER {okp.tolist()}), 0 non-finite outputs, bit "
                     f"for bit the one-block kernel's, |L Linv - I| / "
                     f"(|L| |Linv|) <= {float(res.max()):.2e}, max |Linv| "
                     f"{float(out[1].abs().max()):.3g}")
    say(10, "K1 on indefinite blocks: " + "; ".join(lines))


def phase10b_product_ski(results):
    """Phase 10 (b): rp_ski_d2_j6 on the full synthetic protein split 0."""
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import (cuda_chol, cuda_gram, cuda_interp,
                                 grid_solve, ski_product)
    from rpagp_torch.train import _leaves
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    counters = (cuda_chol.launches, cuda_interp.launches, cuda_gram.launches)
    exp = load_spec(SPEC_PRODUCT)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=10))
    spec = exp.model
    kspec = spec.kernel
    split = _split("protein")
    check(split.train_x.shape == (N_PROTEIN_TRAIN, 9)
          and split.test_x.shape[0] == N_PROTEIN_TEST,
          f"unexpected protein split {split.train_x.shape}")
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    p_rank = ski_product.grid_rank(kspec)
    check(ski_product.is_product(kspec) and p_rank == 1536
          and grid_solve.use_grid_solver(spec, n),
          f"rp_ski_d2_j6: p = {p_rank}, not on the grid solver")
    p0, b0 = exact_gp.init_model(spec, x.shape[1],
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")

    # the CUDA grid_mll against the port's CPU one: run_split's initial
    # params, projection and data, each side preparing its own buffers
    threads = torch.get_num_threads()
    out = {}
    for d in ("cuda", "cpu"):
        torch.set_num_threads(os.cpu_count() if d == "cpu" else threads)
        pd, bd = _to(p0, d), _to(b0, d)
        t0 = time.perf_counter()
        bufs = exact_gp.prepare_buffers(spec, pd, bd, x.to(d), y_train=y.to(d))
        lv = _leaves(pd)
        for t in lv:
            t.requires_grad_(True)
        v = grid_solve.grid_mll(spec, pd, bufs, x.to(d), y.to(d))
        v.backward()
        out[d] = (float(v.detach()), [t.grad for t in lv],
                  time.perf_counter() - t0)
        if d == "cuda":
            params, buffers = _to(p0, dev), bufs
    torch.set_num_threads(threads)
    (vg, gg, sg), (vc, gc, sc) = out["cuda"], out["cpu"]
    erel, grel = abs(vg - vc) / abs(vc), _grad_relerr(gg, gc)
    st = buffers["ski_state"]
    say(10, f"grid_mll rp_ski_d2_j6 (J={kspec.J}, F=2, m={kspec.grid_size}, "
            f"M={st.m ** 2}, p={p_rank}; geometry rows {st.tfrac.shape[0]}, "
            f"S {tuple(buffers['ski_uu'].shape)}) n={n}: value cuda {vg:.8g} "
            f"cpu {vc:.8g} rel {erel:.2e}; grad relerr {grel:.2e}; prepare + "
            f"value+grad {sg:.2f} s cuda, {sc:.2f} s cpu ({os.cpu_count()} "
            f"threads)")
    check(erel <= 1e-5, f"product grid_mll value rel {erel:.2e} > 1e-5")
    check(grel <= 1e-4, f"product grid_mll grad relerr {grel:.2e} > 1e-4")

    # K1 on the (12, 16, 16) factor ladder (padded to 32 by the wrapper)
    with torch.no_grad():
        Tf = ski_product.toeplitz_blocks_factors(kspec, params["kernel"], st)
        eye = torch.eye(Tf.shape[-1], device=dev)
        Tj = (Tf + (spec.grid_jitter * Tf[:, 0, 0])[:, None, None]
              * eye).contiguous()
        outk = cuda_chol.chol_linv_cuda(Tj, "chol_linv_batched")
        ref = cuda_chol.chol_linv_cuda(Tj, cuda_chol.ONE_BLOCK)
        Lp, Lip, okp = cuda_chol.chol_linv_plain(Tj)
        torch.cuda.synchronize()
        same, bad = _same_and_finite(outk, ref)
        eL, eLi = rel(outk[0], Lp), rel(outk[1], Lip)
        check(same and bad == 0, f"K1 {tuple(Tj.shape)}: bit for bit "
                                 f"{same}, {bad} non-finite")
        check(torch.equal(outk[2], okp) and bool((okp == 1).all()),
              f"K1 {tuple(Tj.shape)} ok {outk[2].tolist()}")
        check(eL <= 1e-5 and eLi <= 1e-5,
              f"K1 {tuple(Tj.shape)} rel L {eL:.2e} Linv {eLi:.2e}")
        ms_b = cuda_ms(lambda: cuda_chol.chol_linv_cuda(Tj,
                                                        "chol_linv_batched"),
                       iters=20)
        ms_o = cuda_ms(lambda: cuda_chol.chol_linv_cuda(
            Tj, cuda_chol.ONE_BLOCK), iters=20)
        ms_c = cuda_ms(lambda: cuda_chol.chol_linv_plain(Tj), iters=20)
        bms, bby, _ = bound(4 * 3 * Tj.numel(),
                            flops=Tj.shape[0] * 2 * Tj.shape[-1] ** 3 / 3)
        G, C = cuda_chol.coop_grid(Tj.shape[0], 32, dev)
    say(10, f"K1 factor ladder {tuple(Tj.shape)} (padded to 32; G = {G}, "
            f"C = {C}): bit for bit the one-block kernel's, rel L {eL:.2e} "
            f"Linv {eLi:.2e} against cuSOLVER; {ms_b:.4f} ms vs one-block "
            f"{ms_o:.4f} ms, cuSOLVER {ms_c:.4f} ms, bound {bms:.5f} ms "
            f"({bby})")

    # run_split, 10 steps of the spec's 300
    _zero(counters)
    grid_solve.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if v}
    peak = torch.cuda.max_memory_allocated()
    say(10, f"run_split rp_ski_d2_j6 on protein split 0 (max_iters 10 of "
            f"300): prepare {timings['prepare_s']:.3f} s, train "
            f"{timings['train_s']:.3f} s ({m['iterations']} steps), posterior "
            f"{timings['posterior_s']:.3f} s; rmse {m['rmse']:.4f} (the JAX "
            f"package on the CPU: {JAX_RMSE_PROTEIN_D2_10}) nll "
            f"{m['nll']:.4f} mll {m['mll']:.5f}; peak memory "
            f"{peak / 2**30:.2f} GiB; host reads {grid_solve.stats['host_reads']}"
            f"; ladder escalations T {grid_solve.stats['t_escalations']} C "
            f"{grid_solve.stats['c_escalations']}; launches {launches}")
    for k in ("chol_linv", "chol_linv_batched"):
        check(launches.get(k, 0) > 0, f"kernel {k} not launched on the "
                                      f"product SKI path")
        results[k].setdefault("launches_by_path", {})["product_ski"] = \
            launches[k]
    check(set(launches) <= {"chol_linv", "chol_linv_batched"},
          f"the product SKI path launched {launches}")
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(m["rmse"] < 1.0, f"rmse {m['rmse']:.4f} >= 1.0: learned nothing")

    # 5 timed steps at the same size, from the initial params
    _, step = _adam_step(spec, _to(params, dev), [buffers], x, y, None)
    step()  # warm-up
    syncs = _count_syncs(step)
    _zero(counters)
    grid_solve.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    step_ms, fwd_ms, _ = _timed_steps(step, 5)
    per_step = {k: v / 5 for c in counters for k, v in c.items() if v}
    reads = grid_solve.stats["host_reads"] / 5
    step_peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms)
    busy, by = _device_ms(step, 3, ("chol_linv_coop_kernel",))
    k1 = by["chol_linv_coop_kernel"]
    say(10, f"5 timed steps: median {med:.2f} ms/step (all "
            f"{', '.join(f'{v:.2f}' for v in step_ms)}; forward median "
            f"{statistics.median(fwd_ms):.2f} ms); device busy {busy:.2f} "
            f"ms/step (idle {100 * (1 - busy / med):.0f}%), K1 {k1:.3f} ms "
            f"({100 * k1 / max(busy, 1e-9):.1f}%); launches per step "
            f"{per_step}; host reads a step {reads:g} (ladder flags); "
            f"device->host syncs in one step {sum(syncs.values())} {syncs}; "
            f"peak memory of a step {step_peak / 2**30:.2f} GiB")


def phase10c_svgp():
    """Phase 10 (c): svgp_m512 on the full synthetic elevators split 0."""
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import svgp
    from rpagp_torch.ops import cuda_chol, cuda_gram, cuda_interp
    from rpagp_torch.train import _leaves
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    counters = (cuda_chol.launches, cuda_interp.launches, cuda_gram.launches)
    exp = load_spec(SPEC_SVGP)
    spec = exp.model
    split = _split("elevators")
    check(split.train_x.shape == (N_ELEVATORS_TRAIN, 18)
          and split.test_x.shape[0] == N_ELEVATORS_TEST,
          f"unexpected elevators split {split.train_x.shape}")
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n, b = x.shape[0], exp.batch_size
    params, buffers = svgp.init_svgp_params(
        spec, x, exp.num_inducing, generator=torch.Generator().manual_seed(0),
        device=dev)

    # the CUDA ELBO against the CPU one on one batch, at the initial params
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(1))[:b]
    out = {}
    for d in ("cuda", "cpu"):
        pd = _to(params, d)
        lv = _leaves(pd)
        for t in lv:
            t.requires_grad_(True)
        v = svgp.elbo(spec, pd, _to(buffers, d), x[idx.to(dev)].to(d),
                      y[idx.to(dev)].to(d), n)
        v.backward()
        out[d] = (float(v.detach()), [t.grad for t in lv])
    (vg, gg), (vc, gc) = out["cuda"], out["cpu"]
    erel, grel = abs(vg - vc) / abs(vc), _grad_relerr(gg, gc)
    say(10, f"ELBO svgp_m512 (M={exp.num_inducing}, batch {b}, D=18) at the "
            f"initial params: value cuda {vg:.8g} cpu {vc:.8g} rel "
            f"{erel:.2e}; grad relerr {grel:.2e} (inducing points included)")
    check(erel <= 1e-5, f"SVGP ELBO value rel {erel:.2e} > 1e-5")
    check(grel <= 1e-4, f"SVGP ELBO grad relerr {grel:.2e} > 1e-4")

    # run_split with all of the spec's epochs
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if v}
    peak = torch.cuda.max_memory_allocated()
    steps = n // b
    epochs = max(1, exp.train.max_iters // 10)
    say(10, f"run_split svgp_m512 on elevators split 0 ({epochs} epochs of "
            f"{steps} steps): prepare {timings['prepare_s']:.3f} s, train "
            f"{timings['train_s']:.3f} s ({m['iterations']} epochs), "
            f"posterior {timings['posterior_s']:.3f} s; rmse {m['rmse']:.4f} "
            f"(the JAX package on the CPU: {JAX_RMSE_ELEVATORS_SVGP}) nll "
            f"{m['nll']:.4f} mll {m['mll']:.5f}; peak memory "
            f"{peak / 2**30:.2f} GiB; kernel launches {launches} (none: the "
            f"SVGP path has no kernel of this package)")
    check(m["iterations"] == epochs, f"{m['iterations']} epochs")
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(m["rmse"] < 1.0, f"rmse {m['rmse']:.4f} >= 1.0: learned nothing")

    # an epoch and a step as train_svgp takes them: host reads, then times
    g = torch.Generator(device=dev).manual_seed(2)
    p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.clone().requires_grad_(True))
         for k, v in params.items()}
    opt = torch.optim.Adam(_leaves(p), lr=exp.train.lr)

    def batches():
        take = torch.randperm(n, generator=g, device=dev)[:steps * b]
        return x[take].reshape(steps, b, -1), y[take].reshape(steps, b)

    xs, ys = batches()
    svgp._epoch(spec, p, buffers, opt, xs[:1], ys[:1], n)  # warm-up
    step_syncs = _count_syncs(
        lambda: svgp._epoch(spec, p, buffers, opt, xs[:1], ys[:1], n))
    epoch_syncs = _count_syncs(lambda: svgp.train_svgp(
        spec, params, buffers, x, y, generator=g, batch_size=b, num_epochs=1,
        lr=exp.train.lr))
    epoch_ms = []
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        xs, ys = batches()
        svgp._epoch(spec, p, buffers, opt, xs, ys, n)
        e1.record()
        torch.cuda.synchronize()
        epoch_ms.append(e0.elapsed_time(e1))
    med = statistics.median(epoch_ms)
    busy, _ = _device_ms(lambda: svgp._epoch(spec, p, buffers, opt, xs, ys,
                                             n), 1, ())
    say(10, f"epochs of {steps} steps: {', '.join(f'{v:.2f}' for v in epoch_ms)}"
            f" ms (median {med / 1e3:.4f} s an epoch, {med / steps:.3f} "
            f"ms/step); device busy {busy / steps:.3f} ms/step (idle "
            f"{100 * (1 - busy / med):.0f}%); device->host syncs in a step "
            f"{sum(step_syncs.values())} {step_syncs}, in an epoch of "
            f"train_svgp {sum(epoch_syncs.values())} {epoch_syncs}")
    check(sum(step_syncs.values()) == 0, f"a step reads the host: {step_syncs}")
    check(sum(epoch_syncs.values()) == 1,
          f"an epoch reads the host {sum(epoch_syncs.values())} times")


def _card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""


def phase11_single_card_surface():
    """The single-card surface beside the kernels, each number printed with
    the card's name and power limit: (a) the sorted SKI plan at the
    flagship's full size against K2 / K3 and a float64 run of itself; (b)
    one SKI + BBMM step of rp_poly_j20_ski on sml on the sorted plan
    against the dense plan; (c) train_with_checkpointing on
    rp_bbmm_elevators, 20 steps against 10 and a resume to 20; (d) the
    runner's --profile on rp_ski_d2_j6 / protein; (e) the step-0 stall
    warning, and the trainer's host reads on the flagship grid step."""
    card = _card_line()

    def say11(msg):
        say(11, f"{msg} [{card}]")

    phase11a_sorted_plan(say11)
    phase11b_sorted_ski_bbmm(say11)
    phase11c_checkpoint_resume(say11)
    phase11d_profile(say11)
    phase11e_stall_warning(say11)


def _timed_with_peak(fn, iters=3):
    """(result, ms a call by CUDA events, GiB allocated above the start
    during one call)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    return out, cuda_ms(fn, iters=iters), peak


def phase11a_sorted_plan(say11):
    """Phase 11 (a): the sorted plan's W^T V and W G at J = 20, m = 256 on
    the full HouseElectric split (n = 1,844,352), t = 1 and 9, beside K2
    and K3 on the same points; each direction's error against the sorted
    plan in float64 on the card (the taps from tfrac in float64, the same
    order); ski_mvm's value and V-gradient on the sorted state against the
    dense one."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_interp, ski
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC)
    kspec = exp.model.kernel
    x = torch.as_tensor(_split("houseelectric").train_x, device=dev)
    n, m, J = x.shape[0], kspec.grid_size, kspec.J
    params, buffers = exact_gp.init_model(
        exp.model, x.shape[1], generator=torch.Generator().manual_seed(0),
        device=dev)
    kp, kb = params["kernel"], buffers["kernel"]
    st_d = ski.build_ski(kspec, kp, kb, x, m, plan="dense")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st_s = ski.build_ski(kspec, kp, kb, x, m, plan="sorted")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    plan_gib = (torch.cuda.memory_allocated() - base) / 2**30
    check(torch.equal(st_s.tfrac, st_d.tfrac), "the plans' tfrac differ")
    check(int(st_s.bounds[:, -1].min()) == n, "a point lies past the grid")
    # the same plan in float64: taps from tfrac in float64, the same order
    _, w4_64 = ski._tap_geometry(st_s.tfrac.double(), m)
    st64 = st_s._replace(
        w4=w4_64, cells=st_s.cells.double(),
        w4_sorted=torch.gather(w4_64, 2, st_s.order.long().expand(4, -1, -1)))
    say11(f"sorted plan of the flagship split (J={J}, n={n}, m={m}): built "
          f"in {t_build:.3f} s, {plan_gib:.3f} GiB beside the dense state "
          f"(i0, w4, order, w4_sorted, bounds)")
    gen = torch.Generator(device=dev).manual_seed(11)
    for t in (1, 9):
        V = torch.randn(n, t, generator=gen, device=dev)
        G = torch.randn(J, t, m, generator=gen, device=dev)
        U, ms_us, pk_us = _timed_with_peak(
            lambda: ski._interp_transpose_impl(st_s, V))
        Uk, ms_uk, pk_uk = _timed_with_peak(
            lambda: cuda_interp.interp_transpose_cuda(st_s.tfrac, V, m))
        O, ms_os, pk_os = _timed_with_peak(
            lambda: ski._interp_apply_impl(st_s, G).sum(0).T)
        Ok, ms_ok, pk_ok = _timed_with_peak(
            lambda: cuda_interp.interp_apply_sum_cuda(st_s.tfrac, G))
        with torch.no_grad():
            U64 = ski._interp_transpose_impl(st64, V.double())
            O64 = ski._interp_apply_impl(st64, G.double()).sum(0).T
        for name, a in (("W^T V", U), ("K2", Uk), ("W G", O), ("K3", Ok)):
            check(bool(torch.isfinite(a).all()), f"t={t} {name} not finite")
        b_ms, b_by, _ = bound(4 * (J * n + n * t + J * t * m),
                              flops=2 * 4 * J * n * t)
        say11(f"t={t}: W^T V sorted {ms_us:.4f} ms (+{pk_us:.3f} GiB "
              f"transient, rel to float64 {rel(U, U64):.2e}) vs K2 "
              f"{ms_uk:.4f} ms (+{pk_uk:.3f} GiB, rel {rel(Uk, U64):.2e}); "
              f"W G sorted {ms_os:.4f} ms (+{pk_os:.3f} GiB, rel "
              f"{rel(O, O64):.2e}) vs K3 {ms_ok:.4f} ms (+{pk_ok:.3f} GiB, "
              f"rel {rel(Ok, O64):.2e}); bound of each {b_ms:.4f} ms "
              f"({b_by}); sorted vs kernel rel {rel(U, Uk):.2e} (W^T V), "
              f"{rel(O, Ok):.2e} (W G)")
        del U, Uk, O, Ok, U64, O64
    del st64, w4_64
    W = torch.randn(n, 9, generator=gen, device=dev)
    got = {}
    for name, st in (("sorted", st_s), ("dense", st_d)):
        v = V.clone().requires_grad_(True)
        o = ski.ski_mvm(kspec, kp, st, v)
        torch.sum(o * W).backward()
        check(bool(torch.isfinite(o).all() and torch.isfinite(v.grad).all()),
              f"ski_mvm on the {name} plan not finite")
        got[name] = (o.detach(), v.grad)
    say11(f"ski_mvm at t=9, sorted against dense: value rel "
          f"{rel(got['sorted'][0], got['dense'][0]):.2e}, V-gradient rel "
          f"{rel(got['sorted'][1], got['dense'][1]):.2e}")
    del got, st_s, st_d, V, W
    torch.cuda.empty_cache()


def phase11b_sorted_ski_bbmm(say11):
    """Phase 11 (b): rp_poly_j20_ski on sml split 0 (J = 20, m = 512,
    t = 11) on the sorted plan (interp set to "sorted" in memory): the MLL
    value and gradient against the dense plan on the same probe normals;
    5 timed steps of each plan."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import iterative
    from rpagp_torch.ops.exact import LOG_2PI
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    spec_d = load_spec(SPEC_SKI_SML).model
    spec_s = dataclasses.replace(spec_d, kernel=dataclasses.replace(
        spec_d.kernel, interp="sorted"))
    split = _dense_split()
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    p0, b0 = exact_gp.init_model(spec_d, x.shape[1],
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    gen = torch.Generator().manual_seed(9)
    eps_small = torch.randn(spec_d.precond_rank, spec_d.num_probes,
                            generator=gen).to(dev)
    eps_big = torch.randn(n, spec_d.num_probes, generator=gen).to(dev)
    out = {}
    for name, spec in (("dense", spec_d), ("sorted", spec_s)):
        p = _to(p0, dev)
        b = exact_gp.prepare_buffers(spec, p, _to(b0, dev), x)
        check((b["ski_state"].order is not None) == (name == "sorted"),
              f"the {name} spec built the other plan")
        lv = [p["raw_noise"], p["mean_const"], *p["kernel"].values()]
        for t in lv:
            t.requires_grad_(True)
        iq, ld = iterative.inv_quad_logdet_eps(spec, p, b, x, y, eps_small,
                                               eps_big)
        v = -0.5 * (iq + ld + n * LOG_2PI)
        v.backward()
        pt = _to(p0, dev)
        _, step = _adam_step(spec, pt, [exact_gp.prepare_buffers(
            spec, pt, _to(b0, dev), x)], x, y,
            torch.Generator(device=dev).manual_seed(1))
        step()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        step_ms, fwd_ms, _ = _timed_steps(step, 5)
        out[name] = (float(v.detach()), [t.grad for t in lv], step_ms,
                     statistics.median(fwd_ms),
                     torch.cuda.max_memory_allocated() / 2**30)
        check(math.isfinite(out[name][0]), f"{name} MLL not finite")
    (vd, gd, sd, fd, md), (vs, gs, ss, fs, ms) = out["dense"], out["sorted"]
    say11(f"rp_poly_j20_ski on sml (n={n}), MLL on the same probe normals: "
          f"sorted {vs:.6f}, dense {vd:.6f}, value rel "
          f"{abs(vs - vd) / abs(vd):.2e}, gradient relerr "
          f"{_grad_relerr(gs, gd):.2e}; a step: sorted median "
          f"{statistics.median(ss):.2f} ms (all "
          f"{', '.join(f'{v:.2f}' for v in ss)}; forward {fs:.2f}; peak "
          f"{ms:.2f} GiB), dense median {statistics.median(sd):.2f} ms "
          f"(forward {fd:.2f}; peak {md:.2f} GiB) in the same run; phase 9 "
          f"(a) 150-161 ms in earlier runs")


def phase11c_checkpoint_resume(say11):
    """Phase 11 (c): rp_bbmm_elevators (K4 / K5; probes from a CUDA
    generator) on its full split through train_with_checkpointing: 20
    steps in one call against 10 and a resume to 20 in a fresh call (handed
    a generator of another seed); then the step-10 checkpoint loaded into a
    fresh Adam and generator on the card."""
    import tempfile

    import numpy as np
    import torch

    from rpagp_torch import train
    from rpagp_torch.mll import mll
    from rpagp_torch.models import exact_gp
    from rpagp_torch.utils import checkpoint
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC_BBMM)
    spec = exp.model
    split = _split("elevators")
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    check(n == N_ELEVATORS_TRAIN, f"unexpected elevators split {x.shape}")
    p0, b0 = exact_gp.init_model(spec, x.shape[1],
                                 generator=torch.Generator().manual_seed(0),
                                 device=dev)
    args = (exact_gp.prepare_buffers(spec, p0, b0, x), x, y)

    def loss(p, b, xx, yy, g):
        return -mll(spec, p, b, xx, yy, g) / n

    def run(d, iters, seed):
        t0 = time.perf_counter()
        r = train.train_with_checkpointing(
            loss, p0, d, lr=exp.train.lr, max_iters=iters,
            checkpoint_every=10, loss_args=args,
            generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        full, t_full = run(os.path.join(d, "a"), 20, 1)
        part, t_part = run(os.path.join(d, "b"), 10, 1)
        res, t_res = run(os.path.join(d, "b"), 20, 2)
        check(all(math.isfinite(v) for v in full.losses + res.losses),
              "checkpointed losses not finite")
        check(res.iterations == 10 and len(res.losses) == 20,
              f"resume: {res.iterations} steps, {len(res.losses)} losses")
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(res.losses, full.losses))
        pa, pb = train._leaves(res.params), train._leaves(full.params)
        par_rel = max(float(torch.linalg.norm((a - b).double())
                            / torch.linalg.norm(b.double()))
                      for a, b in zip(pa, pb))
        same = res.losses == full.losses and all(
            torch.equal(a, b) for a, b in zip(pa, pb))
        like = train.checkpoint_state(
            p0, torch.optim.Adam(train._leaves(p0)),
            torch.Generator(device=dev), 0,
            train.ConvergenceTracker(1, 0.0, best_params=p0))
        c_full, c_res = (checkpoint.load_checkpoint(
            os.path.join(d, s, "ckpt_00000020"), like) for s in ("a", "b"))
        ckpt_same = [p for (p, a), (_, b) in zip(
            checkpoint._flatten(c_full), checkpoint._flatten(c_res))
            if not torch.equal(a, b)]
        # the step-10 checkpoint into a fresh Adam and generator on the card
        path10 = os.path.join(d, "b", "ckpt_00000010")
        c10 = checkpoint.load_checkpoint(path10, like)
        params10 = c10["params"]
        opt = torch.optim.Adam(train._leaves(params10))
        train.set_adam_state(opt, params10, c10["opt_state"])
        back = train._adam_state(opt, params10)
        g = torch.Generator(device=dev)
        g.set_state(c10["generator"])
        with np.load(path10 + ".npz") as raw:
            saved = [raw[f"leaf_{i}"] for i in range(len(raw.files))]
        flat10 = checkpoint._flatten(c10)
        trip = (all(torch.equal(a, b) for k in ("exp_avg", "exp_avg_sq",
                                                "step")
                    for a, b in zip(train._leaves(back[k]),
                                    train._leaves(c10["opt_state"][k])))
                and torch.equal(g.get_state(), c10["generator"])
                and all(np.array_equal(a.cpu().numpy(), s)
                        for (_, a), s in zip(flat10, saved))
                and all(a.device.type == "cuda"
                        for a in train._leaves(c10["opt_state"]["exp_avg"])))
    say11(f"train_with_checkpointing rp_bbmm_elevators (n={n}): 20 steps "
          f"{t_full:.2f} s; 10 steps {t_part:.2f} s + resume to 20 "
          f"{t_res:.2f} s; resumed against uninterrupted: bit for bit "
          f"{same}, largest loss rel diff {loss_rel:.3e}, params "
          f"{par_rel:.3e}; step-20 checkpoints differ in "
          f"{len(ckpt_same)} of {len(checkpoint._flatten(c_full))} leaves "
          f"{ckpt_same}; loss {full.losses[0]:.5f} -> {full.losses[-1]:.5f}; "
          f"step-10 checkpoint into a fresh Adam and CUDA generator: "
          f"exp_avg / exp_avg_sq / step / generator state round-trip "
          f"exactly {trip}")
    check(trip, "the checkpoint's Adam or generator state did not "
                "round-trip")


def phase11d_profile(say11):
    """Phase 11 (d): runner.main on rp_ski_d2_j6 (cut to 10 steps) /
    protein, one split, with and without --profile: the trace's kernel
    events, K1's among them (launched through ctypes), and the split's
    train time both ways."""
    import csv
    import glob
    import tempfile

    from rpagp_torch import runner

    with open(SPEC_PRODUCT) as f:
        spec = json.load(f)
    spec["training"]["max_iters"] = 10
    with tempfile.TemporaryDirectory() as d:
        spec_path = os.path.join(d, "rp_ski_d2_j6_10.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        trace_dir = os.path.join(d, "trace")
        rows = {}
        for prof in (False, True):
            out = os.path.join(d, f"r{int(prof)}.csv")
            argv = ["--model_spec", spec_path, "--datasets", "protein",
                    "--splits", "10", "--max_splits", "1", "--output", out]
            t0 = time.perf_counter()
            runner.main(argv + (["--profile", trace_dir] if prof else []))
            wall = time.perf_counter() - t0
            with open(out) as f:
                rows[prof] = (next(csv.DictReader(f)), wall)
        files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        check(len(files) == 1, f"--profile wrote {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kern if "chol_linv_coop_kernel" in e.get("name", "")]
    check(len(k1) > 0, "the trace holds no chol_linv_coop_kernel event")
    (r0, w0), (r1, w1) = rows[False], rows[True]
    say11(f"runner.main --profile rp_ski_d2_j6 (10 steps) on protein split 0 "
          f"(n={r1['n_train']}): trace {size / 2**20:.2f} MiB, "
          f"{len(kern)} kernel events, {len(k1)} of chol_linv_coop_kernel "
          f"({sum(e.get('dur', 0) for e in k1) / 1e3:.3f} ms); train "
          f"{float(r1['train_time_s']):.3f} s traced, "
          f"{float(r0['train_time_s']):.3f} s untraced (main {w1:.2f} s and "
          f"{w0:.2f} s); rmse {float(r1['rmse']):.4f} and "
          f"{float(r0['rmse']):.4f}")


def phase11e_stall_warning(say11):
    """Phase 11 (e): the step-0 stall warning on CUDA params (once for a
    zero-gradient loss, never for a live one); the flagship grid MLL through
    train_to_convergence for 3 steps (sync_every 8), device->host syncs
    with the stall check and without it."""
    import contextlib
    import io

    import torch

    from rpagp_torch import train
    from rpagp_torch.mll import mll
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import grid_solve
    from rpagp_torch.utils.config import TrainConfig, load_spec

    dev = torch.device("cuda")
    warned = []
    for f in (lambda p: torch.sum(p["w"]) * 0.0,
              lambda p: torch.sum(p["w"] ** 2)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            train.train_to_convergence(f, {"w": torch.ones(3, device=dev)},
                                       TrainConfig(max_iters=3))
        warned.append(err.getvalue().count(
            "[warn] training stalled at step 0"))
    check(warned == [1, 0], f"stall warnings (zero gradient, live): {warned}")

    exp = load_spec(SPEC)
    spec = exp.model
    split = _split("houseelectric")
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    params, buffers = exact_gp.init_model(
        spec, x.shape[1], generator=torch.Generator().manual_seed(0),
        device=dev)
    buffers = exact_gp.prepare_buffers(spec, params, buffers, x, y_train=y)
    tc = dataclasses.replace(exp.train, max_iters=3)

    def fit():
        return train.train_to_convergence(
            lambda p, b, xx, yy: -mll(spec, p, b, xx, yy) / n, params, tc,
            loss_args=(buffers, x, y), sync_every=8)

    fit()  # warm-up
    grid_solve.reset_stats()
    on = _count_syncs(fit)
    grid_reads = grid_solve.stats["host_reads"]
    real = train._warn_if_frozen
    train._warn_if_frozen = lambda *a: None
    try:
        off = _count_syncs(fit)
    finally:
        train._warn_if_frozen = real
    stall = {s: c for s, c in on.items() if "_warn_if_frozen" in s}
    say11(f"stall warning on CUDA params: {warned[0]} line for a zero "
          f"gradient, {warned[1]} for a live loss; flagship grid MLL, 3 "
          f"steps of train_to_convergence (sync_every 8): device->host syncs "
          f"{sum(on.values())} with the stall check, {sum(off.values())} "
          f"without ({stall}); the grid solver's host reads "
          f"{grid_reads / 3:.2f} a step (phase 4: 4)")
    check(sum(on.values()) - sum(off.values()) == 1
          and sum(stall.values()) == 1,
          f"the stall check reads the host {sum(on.values())} - "
          f"{sum(off.values())} times")


def _fresh(params, grad=False):
    """A detached copy of a params tree (leaves requiring grad if asked)."""
    return {k: (_fresh(v, grad) if isinstance(v, dict)
                else v.detach().clone().requires_grad_(grad))
            for k, v in params.items()}


def _value_grad(fn, params, assemble=None):
    """(value, gradient leaves) of fn(p) at a fresh copy p of params;
    assemble(leaves) runs between backward and the read (the parallel
    path's gradient assembly)."""
    from rpagp_torch.train import _leaves

    p = _fresh(params, grad=True)
    v = fn(p)
    v.backward()
    if assemble is not None:
        assemble(_leaves(p))
    return float(v.detach()), [t.grad for t in _leaves(p)]


def _nccl_window(fn, calls):
    """torch.profiler over `calls` calls of fn: (host-side collective
    records a call {name: count}, device NCCL kernels a call {name:
    count}, their device ms a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    host, dev, ms = {}, {}, 0.0
    for e in prof.key_averages():
        key = e.key.lower()
        if not any(w in key for w in ("nccl", "allreduce", "all_reduce")):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = e.count / calls
            ms += e.self_device_time_total / 1e3 / calls
        else:
            host[e.key] = e.count / calls
    return host, dev, ms


def phase12_distributed(results):
    """Phase 12, the parallel path (rpagp_torch/parallel/) on a NCCL
    process group of one rank opened in this process on a FileStore in a
    temp directory: (a) the flagship grid spec through
    run_split(distributed=True) at full size, its distributed grid MLL at
    the initial params against grid_mll, its losses beside phase 4's, its
    steps timed and its collectives in a profiler window; (b) the flagship
    spec with solver "bbmm" distributed (sharded_ski_mvm in every CG
    iteration), its distributed MLL against the single-card SKI + BBMM MLL
    on the same probes; (c) rp_bbmm_elevators distributed (ring_mvm, K4 /
    K5), the same check; (d) svgp_m512: one distributed epoch against
    train_svgp's, and the runner's distributed SVGP branch; (e) the CLI
    as a subprocess, under torchrun with one rank and without torchrun.
    The card has one GPU, so the world is one rank: NCCL gives each rank
    its own card."""
    import tempfile

    import torch
    import torch.distributed as dist

    from rpagp_torch.parallel import multihost

    card = _card_line()

    def say12(msg):
        say(12, f"{msg} [{card}]")

    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize("cuda", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            check(dist.get_backend() == "nccl", "the group is not NCCL")
            for part in (phase12a_grid, phase12b_ski_bbmm, phase12c_bbmm):
                tp = time.perf_counter()
                part(results, say12)
                say12(f"{part.__name__} took {time.perf_counter() - tp:.1f} s")
            tp = time.perf_counter()
            phase12d_svgp(say12)
            say12(f"phase12d_svgp took {time.perf_counter() - tp:.1f} s")
        finally:
            multihost.shutdown()
        torch.cuda.empty_cache()
        tp = time.perf_counter()
        phase12e_cli(say12, tmp)
        say12(f"phase12e_cli took {time.perf_counter() - tp:.1f} s")


def phase12a_grid(results, say12):
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_chol, cuda_interp, grid_solve
    from rpagp_torch.parallel import sharding
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    counters = (cuda_chol.launches, cuda_interp.launches)
    exp = load_spec(SPEC)
    spec = exp.model
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=10))
    split = _split("houseelectric")
    mesh = sharding.make_mesh()
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n = x.shape[0]
    check(n == N_FLAGSHIP_TRAIN, "unexpected n_train")
    xl, yl = sharding.shard_rows(x, mesh), sharding.shard_rows(y, mesh)
    params, kbuf = exact_gp.init_model(spec, x.shape[1],
                                       generator=torch.Generator()
                                       .manual_seed(0), device=dev)

    # the distributed grid MLL at the initial params against grid_mll
    t0 = time.perf_counter()
    state, S4, uy, u1, vc = sharding.prepare_distributed_grid(
        spec, params, kbuf, xl, mesh, y_local=yl)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    buffers = exact_gp.prepare_buffers(spec, params, kbuf, x, y_train=y)
    vd, gd = _value_grad(
        lambda p: sharding.distributed_grid_mll(spec, p, xl, yl, state, S4,
                                                mesh, uy=uy, u1=u1, vc=vc),
        params, lambda lv: sharding.assemble_grads(lv, mesh, data_mean=True))
    vs, gs = _value_grad(lambda p: grid_solve.grid_mll(spec, p, buffers, x, y),
                         params)
    del buffers
    erel, grel = abs(vd - vs) / abs(vs), _grad_relerr(gd, gs)
    say12(f"(a) distributed_grid_mll at the initial params, flagship split "
          f"(n {n}, p {S4.shape[0] * S4.shape[1]}): {vd:.8g} against "
          f"grid_mll {vs:.8g}, value rel {erel:.2e}, gradient relerr "
          f"{grel:.2e}; prepare_distributed_grid {t_prep:.2f} s")
    check(erel <= 1e-5, f"distributed grid MLL value rel {erel:.2e} > 1e-5")
    check(grel <= 1e-4, f"distributed grid MLL grad relerr {grel:.2e} > 1e-4")

    if not _PHASE4:  # phase 12 driven without phase 4: its run_split here
        m4, losses4 = _run_split_losses(runner, exp, split, seed=0,
                                        device=dev)
        _PHASE4.update(losses=losses4, rmse=m4["rmse"])
    _zero(counters)
    grid_solve.reset_stats()
    timings = {}
    m, losses = _run_split_losses(runner, exp, split, seed=0, device=dev,
                                  timings=timings, distributed=True)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items()}
    reads = grid_solve.stats["host_reads"]
    lrel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                   _PHASE4["losses"]))
    say12(f"(a) run_split(distributed=True), flagship, 10 steps: prepare "
          f"{timings['prepare_s']:.2f} s, train {timings['train_s']:.2f} s, "
          f"posterior {timings['posterior_s']:.2f} s; rmse {m['rmse']:.4f} "
          f"(phase 4 {_PHASE4['rmse']:.4f}) nll {m['nll']:.4f} mll "
          f"{m['mll']:.5f}; losses "
          f"{', '.join(f'{v:.6f}' for v in losses)} against "
          f"phase 4's {', '.join(f'{v:.6f}' for v in _PHASE4['losses'])} "
          f"(largest rel {lrel:.2e}); grid host reads {reads}; launches "
          f"{launches}")
    for k in ("chol_linv", "chol_linv_batched", "interp_transpose",
              "interp_apply_sum"):
        check(launches[k] > 0, f"kernel {k} not launched on the distributed "
              "grid path")
        results[k].setdefault("launches_by_path", {})["grid_distributed"] = \
            launches[k]
    for k in ("rmse", "nll", "mll"):
        check(math.isfinite(m[k]), f"{k} not finite")
    check(m["rmse"] < 0.9, f"rmse {m['rmse']:.4f} >= 0.9: learned nothing")
    check(len(losses) == len(_PHASE4["losses"]) and lrel <= 1e-5,
          f"distributed losses depart from phase 4's by {lrel:.2e}")

    # timed steps of the distributed step and its collectives
    p = _fresh(params, grad=True)
    from rpagp_torch.train import _leaves

    opt = torch.optim.Adam(_leaves(p), lr=exp.train.lr)
    step = sharding.make_distributed_train_step(spec, mesh, opt, n)
    grid = (S4, uy, u1, vc)
    events = []
    for _ in range(6):  # the first is a warm-up
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        step(p, kbuf, xl, yl, ski_state=state, grid=grid)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events[1:]]
    host, devk, nccl_ms = _nccl_window(
        lambda: step(p, kbuf, xl, yl, ski_state=state, grid=grid), 3)
    med = statistics.median(step_ms)
    say12(f"(a) the distributed grid step: median {med:.2f} ms/step (all "
          f"{', '.join(f'{v:.2f}' for v in step_ms)}; phase 4's single-card "
          f"step in this run above); collectives a step (torch.profiler): "
          f"host records {host}, NCCL kernels {devk} {nccl_ms:.4f} ms")
    check(sum(host.values()) >= 1, "no collective ran in the distributed "
          "step (the gradient all-reduce)")


def phase12b_ski_bbmm(results, say12):
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_interp, iterative
    from rpagp_torch.ops.exact import LOG_2PI
    from rpagp_torch.parallel import sharding
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC)
    spec = dataclasses.replace(exp.model, solver="bbmm")
    exp = dataclasses.replace(exp, model=spec, train=dataclasses.replace(
        exp.train, max_iters=5))
    split = _split("houseelectric")
    mesh = sharding.make_mesh()
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n, t = x.shape[0], spec.num_probes
    _zero((cuda_interp.launches,))
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings,
                         distributed=True)
    torch.cuda.synchronize()
    launches = dict(cuda_interp.launches)
    say12(f"(b) run_split(distributed=True), flagship spec solver bbmm, 5 "
          f"steps (no preconditioner on the distributed SKI path, as the JAX "
          f"package's): prepare {timings['prepare_s']:.2f} s, train "
          f"{timings['train_s']:.2f} s ({m['iterations']} steps), posterior "
          f"(LOVE rank {spec.love_rank}) {timings['posterior_s']:.2f} s; rmse "
          f"{m['rmse']:.4f} nll {m['nll']:.4f}; launches {launches}")
    for k in ("interp_transpose", "interp_apply_sum"):
        check(launches[k] > 0, f"kernel {k} not launched on the distributed "
              "SKI + BBMM path")
        results[k].setdefault("launches_by_path",
                              {})["ski_bbmm_distributed"] = launches[k]
    check(math.isfinite(m["rmse"]) and math.isfinite(m["nll"]),
          "SKI + BBMM distributed metrics not finite")

    # the same probes: the distributed MLL against the single-card one
    # (M = noise I on both: the distributed SKI path's estimator)
    params, kbuf = exact_gp.init_model(spec, x.shape[1],
                                       generator=torch.Generator()
                                       .manual_seed(0), device=dev)
    xl, yl = sharding.shard_rows(x, mesh), sharding.shard_rows(y, mesh)
    st = sharding.prepare_distributed_ski(spec, params, kbuf, xl, mesh)
    g2 = torch.Generator(device=dev).manual_seed(2)
    eb = torch.randn(n, t, generator=g2, device=dev)
    vd, gd = _value_grad(
        lambda p: sharding.distributed_mll(spec, p, kbuf, xl, yl, eb, mesh,
                                           ski_state_local=st),
        params, lambda lv: sharding.assemble_grads(lv, mesh, data_mean=False))
    spec1 = dataclasses.replace(spec, precond_rank=0)
    b1 = {**kbuf, "ski_state": st}
    es = torch.zeros(0, t, device=dev)

    def single(p):
        iq, ld = iterative.inv_quad_logdet_eps(spec1, p, b1, x, y, es, eb)
        return -0.5 * (iq + ld + n * LOG_2PI)

    vs, gs = _value_grad(single, params)
    erel, grel = abs(vd - vs) / abs(vs), _grad_relerr(gd, gs)
    say12(f"(b) distributed_mll (sharded_ski_mvm, cg {spec.cg_max_iters}, t "
          f"{t}) against the single-card SKI + BBMM MLL on the same probes: "
          f"{vd:.8g} against {vs:.8g}, value rel {erel:.2e}, gradient relerr "
          f"{grel:.2e}")
    check(erel <= 1e-4, f"SKI + BBMM distributed value rel {erel:.2e} > 1e-4")
    check(grel <= 1e-3, f"SKI + BBMM distributed grad relerr {grel:.2e}")


def phase12c_bbmm(results, say12):
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_gram, iterative
    from rpagp_torch.ops.exact import LOG_2PI
    from rpagp_torch.parallel import sharding
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC_BBMM)
    spec = exp.model
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=5))
    split = _split("elevators")
    mesh = sharding.make_mesh()
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    n, t = x.shape[0], spec.num_probes
    _zero((cuda_gram.launches,))
    timings = {}
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings,
                         distributed=True)
    torch.cuda.synchronize()
    launches = dict(cuda_gram.launches)
    say12(f"(c) run_split(distributed=True), rp_bbmm_elevators, 5 steps: "
          f"prepare {timings['prepare_s']:.3f} s, train "
          f"{timings['train_s']:.2f} s ({m['iterations']} steps), posterior "
          f"(LOVE rank {spec.love_rank}) {timings['posterior_s']:.2f} s; rmse "
          f"{m['rmse']:.4f} nll {m['nll']:.4f}; launches {launches}")
    for k in ("gram_mvm", "gram_mvm_bwd"):
        check(launches[k] > 0, f"kernel {k} not launched on the distributed "
              "BBMM path (ring_mvm)")
        results[k].setdefault("launches_by_path",
                              {})["bbmm_distributed"] = launches[k]
    check(math.isfinite(m["rmse"]) and math.isfinite(m["nll"]),
          "BBMM distributed metrics not finite")

    params, kbuf = exact_gp.init_model(spec, x.shape[1],
                                       generator=torch.Generator()
                                       .manual_seed(0), device=dev)
    xl, yl = sharding.shard_rows(x, mesh), sharding.shard_rows(y, mesh)
    g2 = torch.Generator(device=dev).manual_seed(2)
    es = torch.randn(spec.precond_rank, t, generator=g2, device=dev)
    eb = torch.randn(n, t, generator=g2, device=dev)
    Lp, Cs, ld = sharding._preconditioner_rows(spec, params, kbuf, x, mesh)
    vd, gd = _value_grad(
        lambda p: sharding.distributed_mll(
            spec, p, kbuf, xl, yl, eb, mesh, pre_L_local=Lp,
            pre_chol_small=Cs, pre_logdet=ld, eps_small=es),
        params, lambda lv: sharding.assemble_grads(lv, mesh, data_mean=False))

    def single(p):
        iq, ldet = iterative.inv_quad_logdet_eps(spec, p, kbuf, x, y, es, eb)
        return -0.5 * (iq + ldet + n * LOG_2PI)

    vs, gs = _value_grad(single, params)
    erel, grel = abs(vd - vs) / abs(vs), _grad_relerr(gd, gs)
    say12(f"(c) distributed_mll (ring_mvm: K4, backward K5; rank-"
          f"{spec.precond_rank} preconditioner) against the single-card BBMM "
          f"MLL on the same probes: {vd:.8g} against {vs:.8g}, value rel "
          f"{erel:.2e}, gradient relerr {grel:.2e}")
    check(erel <= 1e-4, f"BBMM distributed value rel {erel:.2e} > 1e-4")
    check(grel <= 1e-3, f"BBMM distributed grad relerr {grel:.2e} > 1e-3")


def phase12d_svgp(say12):
    import torch

    from rpagp_torch import runner
    from rpagp_torch.models import svgp
    from rpagp_torch.parallel import sharding
    from rpagp_torch.train import _leaves
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC_SVGP)
    spec = exp.model
    split = _split("elevators")
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    params, buffers = svgp.init_svgp_params(
        spec, x, exp.num_inducing, generator=torch.Generator().manual_seed(0),
        device=dev)
    kw = dict(batch_size=exp.batch_size, num_epochs=1, lr=exp.train.lr)
    t0 = time.perf_counter()
    r1 = svgp.train_svgp(spec, params, buffers, x, y, generator=torch
                         .Generator(device=dev).manual_seed(1), **kw)
    t1 = time.perf_counter()
    rd = svgp.train_svgp_distributed(
        spec, params, buffers, x, y, sharding.make_mesh(),
        generator=torch.Generator(device=dev).manual_seed(1), **kw)
    t2 = time.perf_counter()
    lrel = abs(rd.losses[0] - r1.losses[0]) / abs(r1.losses[0])
    prel = _grad_relerr(_leaves(rd.params), _leaves(r1.params))
    say12(f"(d) svgp_m512 on elevators, one epoch of {x.shape[0] // exp.batch_size} "
          f"steps: train_svgp_distributed loss {rd.losses[0]:.8g} "
          f"({t2 - t1:.3f} s) against train_svgp {r1.losses[0]:.8g} "
          f"({t1 - t0:.3f} s), rel {lrel:.2e}; params relerr {prel:.2e}")
    check(lrel <= 1e-5, f"distributed SVGP epoch loss rel {lrel:.2e}")
    check(prel <= 1e-4, f"distributed SVGP params relerr {prel:.2e}")
    exp1 = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                              max_iters=10))
    m = runner.run_split(exp1, split, seed=0, device=dev, distributed=True)
    say12(f"(d) the runner's distributed SVGP branch, 1 epoch: rmse "
          f"{m['rmse']:.4f} nll {m['nll']:.4f}")
    check(m["iterations"] == 1 and math.isfinite(m["rmse"]),
          f"distributed SVGP run_split: {m}")


def phase12e_cli(say12, tmp):
    """The runner's CLI with --distributed as a subprocess: under torchrun
    with one rank on the full flagship split, then without torchrun (a
    world of one in the process) on its first 200,000 points."""
    import csv

    args = ["-m", "rpagp_torch.runner", "--distributed", "--model_spec",
            SPEC, "--datasets", "houseelectric", "--splits", "10",
            "--max_splits", "1"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    for label, cmd in (
            ("torchrun --nproc_per_node 1 -m rpagp_torch.runner "
             "--distributed", torchrun + args),
            ("python -m rpagp_torch.runner --distributed --max_points "
             "200000", [sys.executable] + args + ["--max_points", "200000"])):
        out = os.path.join(tmp, "distributed.csv")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--output", out], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        took = time.perf_counter() - t0
        check(proc.returncode == 0, f"{label} exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        with open(out) as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 1, f"{len(rows)} result rows")
        row = rows[0]
        say12(f"(e) {label}, the flagship spec (max_iters 100): {took:.1f} s "
              f"in all; row: n_train {row['n_train']} rmse "
              f"{float(row['rmse']):.4f} nll {float(row['nll']):.4f} "
              f"iterations {row['iterations']} train "
              f"{float(row['train_time_s']):.2f} s")
        check(math.isfinite(float(row["rmse"])) and float(row["rmse"]) < 0.9,
              f"{label}: row rmse {row['rmse']}")
        os.remove(out)


def kernel_entries(results):
    """The `kernels` line's entries: each kernel's source, the TPU kernel
    it replaces, and what the phases recorded of it."""
    source = {"chol_linv": "rpagp_torch/csrc/chol_linv_coop.cu",
              "chol_linv_batched": "rpagp_torch/csrc/chol_linv_coop.cu",
              "interp_transpose": "rpagp_torch/csrc/interp.cu",
              "interp_apply_sum": "rpagp_torch/csrc/interp.cu",
              "gram_mvm": "rpagp_torch/csrc/gram_mvm.cu",
              "gram_mvm_bwd": "rpagp_torch/csrc/gram_mvm.cu",
              "dense_gram": "rpagp_torch/csrc/gram_mvm.cu",
              "dense_gram_bwd": "rpagp_torch/csrc/gram_mvm.cu"}
    replaces = {"chol_linv": "rpagp/ops/pallas_chol.py:190",
                "chol_linv_batched": "rpagp/ops/pallas_chol.py:381",
                "interp_transpose": "rpagp/ops/pallas_interp.py:108",
                "interp_apply_sum": "rpagp/ops/pallas_interp.py:182",
                "gram_mvm": "rpagp/ops/pallas_gram.py:86",
                "gram_mvm_bwd": "rpagp/ops/pallas_gram.py:173",
                # no TPU kernel: the JAX package's dense Gram is plain jnp
                "dense_gram": None, "dense_gram_bwd": None}
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # launches: on the grid or BBMM path's run_split (K6 / K7: on the dense
    # path's); launches_by_path: on each path's run_split that launched the
    # kernel (K1's leaf on the grid, dense and product SKI paths, its ladder
    # on the grid and product SKI paths, K2 and K3 on the grid and both
    # SKI + BBMM runs, K6 on the BBMM and dense paths, K7 on the dense; phase
    # 12's distributed runs: K1-K3 on grid_distributed, K2 and K3 on
    # ski_bbmm_distributed, K4 and K5 on bbmm_distributed)
    return [{"name": k, "route": "cuda", "source": source[k],
             "replaces": replaces[k], **{f: r[f] for f in keys},
             "launches_by_path": r["launches_by_path"]}
            for k, r in results.items()]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    results = {}
    for phase, fn in enumerate((
            phase0_env, phase1_build, lambda: phase2_kernels(results),
            phase3_slice, lambda: phase4_main_path(results),
            lambda: phase5_gram_kernels(results), phase6_bbmm_mll,
            lambda: phase7_bbmm_main_path(results),
            lambda: phase8_dense_main_path(results),
            lambda: phase9_ski_bbmm(results),
            lambda: phase10_product_ski_and_svgp(results),
            phase11_single_card_surface,
            lambda: phase12_distributed(results))):
        tp = time.perf_counter()
        fn()
        say(phase, f"phase {phase} took {time.perf_counter() - tp:.1f} s")
    kernels = kernel_entries(results)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as exc:  # report the failing phase, print no result
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
