"""The exact MLL's closed-form VJP on one card: three routes to Khat^{-1}
from the factor, and the MLL's value and gradient against autograd
through the blocked factor, at the dense cell's Khat.

    python scripts/torch_ab_exact_vjp.py [--reps 10] [--n N] [--device cpu]

Khat is the exact cell's K(x, x) + (s^2 + jitter) I in float32:
specs/rp_poly_j20.json on sml split 0 (n_train 3,723, or its first
`--n` points), at the initial hyperparameters of seed 0. From its factor
L (block_chol.blocked_cholesky):
- the routes to Khat^{-1}: `torch.cholesky_inverse(L)`; L^{-1} by
  `torch.linalg.solve_triangular`, then L^{-T} L^{-1} by one GEMM; L^{-1}
  as before, then a second triangular solve with L^T (the program's).
  For each: ms a call by CUDA events in turns (A, B, C, C, B, A; `--reps`
  calls each after a warm-up), the device's kernels a call and their ms
  (torch.profiler), the host reads of a call (CUDA sync debugging), and
  the rel gaps to the float64 inverse (norm-wise) and to its trace (the
  noise's gradient is alpha^T alpha less that trace);
- the MLL's value and gradient in K and the noise: `exact.cholesky_mll`
  (the closed form) against the same MLL by autograd through
  `blocked_cholesky`; ms and kernels of the forward and of the backward,
  host reads, and each one's gradient in K (its symmetric part) against
  float64's 1/2 (alpha alpha^T - Khat^{-1}).
Prints the card's name and power limit and the TF32 switches first, then
one JSON line, also written to chiprun_out/ab_exact_vjp.json. `--device
cpu` rehearses it (host clock; no sync count).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _ms(fn, reps: int, cuda: bool) -> float:
    import torch

    fn()
    if not cuda:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernels(fn, cuda: bool):
    """(device events a call, their device ms a call) of fn, profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not cuda:
        return None, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("rpagp.")]
    return len(ops), sum(e.device_time for e in ops) / 1e3


def _rel(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main(argv=None) -> int:
    import torch

    from chip_smoke import _count_syncs
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import exact, kernels
    from rpagp_torch.ops.block_chol import blocked_cholesky
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
              f"{torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device(args.device)
    exp = load_spec(os.path.join(ROOT, "specs", "rp_poly_j20.json"))
    split = next(datasets.kfold_splits(datasets.load_dataset("sml"), k=10,
                                       seed=0, equal_train=True))
    x = torch.as_tensor(split.train_x, device=dev)
    y = torch.as_tensor(split.train_y, device=dev)
    if args.n:
        x, y = x[:args.n], y[:args.n]
    spec = exp.model
    params, buffers = exact_gp.init_model(
        spec, x.shape[1], generator=torch.Generator().manual_seed(0),
        device=dev)
    with torch.no_grad():
        K = kernels.gram(spec.kernel, params["kernel"], buffers["kernel"],
                         x, x)
        yc = y - exact_gp.mean_fn(spec, params, x)
        noise = exact_gp.noise_value(params)
        Khat = exact.add_jitter(K, noise, spec.jitter)
        L = blocked_cholesky(Khat)
        L64 = torch.linalg.cholesky(Khat.double())
        inv64 = torch.cholesky_inverse(L64)
        a64 = torch.cholesky_solve(yc.double()[:, None], L64)[:, 0]
        grad64 = 0.5 * (torch.outer(a64, a64) - inv64)
    n = x.shape[0]
    eye = torch.eye(n, dtype=L.dtype, device=dev)

    def by_potrs():
        return torch.cholesky_inverse(L)

    def by_trsm_gemm():
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        return Li.mT @ Li

    def by_trsm_trsm():
        Li = torch.linalg.solve_triangular(L, eye, upper=False)
        return torch.linalg.solve_triangular(L.mT, Li, upper=True)

    routes = {"cholesky_inverse": by_potrs, "trsm_gemm": by_trsm_gemm,
              "trsm_trsm": by_trsm_trsm}
    ms = {k: [] for k in routes}
    for name in [*routes, *reversed(routes)]:
        ms[name].append(_ms(routes[name], args.reps, cuda))
    out = {"n": n, "device": torch.cuda.get_device_name(0) if cuda
           else "cpu", "routes": {}}
    for name, fn in routes.items():
        launches, busy = _kernels(fn, cuda)
        inv = fn()
        out["routes"][name] = {
            "ms": ms[name], "ms_median": statistics.median(ms[name]),
            "launches": launches, "device_ms": busy,
            "syncs": _count_syncs(fn) if cuda else None,
            "rel_to_f64": _rel(inv, inv64),
            "trace_rel_to_f64": abs(float(torch.trace(inv.double())
                                          - torch.trace(inv64)))
            / float(torch.trace(inv64))}

    def old_mll(Kl, s):
        Lo = blocked_cholesky(exact.add_jitter(Kl, s, spec.jitter))
        alpha = torch.cholesky_solve(yc[:, None], Lo)[:, 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(Lo)))
        return -0.5 * (yc @ alpha + logdet + n * exact.LOG_2PI)

    def new_mll(Kl, s):
        return exact.cholesky_mll(Kl, yc, s, spec.jitter)

    out["mll"] = {}
    for name, fn in (("closed_form", new_mll), ("autograd", old_mll)):
        Kl = K.clone().requires_grad_(True)
        s = noise.clone().requires_grad_(True)

        def fwd():
            return fn(Kl, s)

        def fwd_bwd():
            Kl.grad = s.grad = None
            fn(Kl, s).backward()

        fwd_bwd()
        v = float(fwd().detach())
        gK = 0.5 * (Kl.grad + Kl.grad.T)
        f_launch, f_busy = _kernels(fwd, cuda)
        t_launch, t_busy = _kernels(fwd_bwd, cuda)
        out["mll"][name] = {
            "value": v, "value_f64": float(-0.5 * (
                yc.double() @ a64 + 2.0 * torch.log(torch.diagonal(L64)).sum()
                + n * exact.LOG_2PI)),
            "grad_K_rel_to_f64": _rel(gK, grad64),
            "grad_noise_rel_to_f64": abs(float(s.grad) - float(
                torch.trace(grad64))) / abs(float(torch.trace(grad64))),
            "forward_ms": _ms(fwd, args.reps, cuda),
            "forward_backward_ms": _ms(fwd_bwd, args.reps, cuda),
            "forward_launches": f_launch, "forward_device_ms": f_busy,
            "backward_launches": None if t_launch is None
            else t_launch - f_launch,
            "backward_device_ms": None if t_busy is None
            else t_busy - f_busy,
            "syncs": _count_syncs(fwd_bwd) if cuda else None}
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_exact_vjp.json"),
              "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
