"""Smoke run of rpagp_torch on one CUDA card: builds the kernels, holds
each against its plain PyTorch version at the main path's shapes, holds
the CUDA grid MLL against the CPU one at full width, and drives the
flagship main path (prepare -> training steps -> posterior) through
rpagp_torch.runner.run_split at full size.

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
N_FLAGSHIP_TRAIN = 1_844_352  # synthetic HouseElectric split 0 (k=10)


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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card, flush=True)
    import rpagp_torch  # noqa: F401  (sets the f32 matmul switches)

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "f32 matmul precision is not 'highest'")
    say(0, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)}; TF32 off")
    return card


def phase1_build():
    from rpagp_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    say(1, f"kernels built in {time.perf_counter() - t0:.2f} s "
           f"(nvcc {_build.build_seconds} s) -> "
           f"{os.path.relpath(_build.library_path(), ROOT)}")


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

    # --- K1, B = 1, b = 512: the diagonal leaf of the p x p factor
    A = _spd(1, 512, gen, dev)
    L, Li, ok = cuda_chol.chol_linv_cuda(A, "chol_linv")
    Lp, Lip, okp = cuda_chol.chol_linv_plain(A)
    torch.cuda.synchronize()
    eL, eLi = rel(L, Lp), rel(Li, Lip)
    check(bool((ok == 1).all()) and torch.equal(ok, okp), "K1 b=512 ok flags")
    check(eL <= 1e-5 and eLi <= 1e-5, f"K1 b=512 rel L {eL:.2e} Linv {eLi:.2e}")
    res = rel(L @ L.mT, A)
    check(res <= 1e-5, f"K1 b=512 residual {res:.2e}")
    ms = cuda_ms(lambda: cuda_chol.chol_linv_cuda(A, "chol_linv"))
    pms = cuda_ms(lambda: cuda_chol.chol_linv_plain(A))
    results["chol_linv"] = dict(max_abs_err=max(max_abs(L, Lp), max_abs(Li, Lip)),
                                ms=ms, plain_ms=pms)
    say(2, f"K1 (1,512,512) SPD: rel L {eL:.2e} Linv {eLi:.2e} "
           f"|LL^T-A|/|A| {res:.2e}; {ms:.3f} ms vs plain {pms:.3f} ms")

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
    results["chol_linv_batched"] = dict(
        max_abs_err=max(max_abs(L0, Lp), max_abs(Li0, Lip)))
    say(2, f"K1 (20,256,256) SPD: rel L {eL:.2e} Linv {eLi:.2e}; L exactly "
           f"lower-triangular")

    # --- K1, B = 20, b = 256: the flagship Toeplitz blocks + jitter
    T, eps0 = _toeplitz_batch(dev)
    eye = torch.eye(256, device=dev)
    for mult in grid_solve._LADDER:
        Tj = (T + (mult * eps0)[:, None, None] * eye).contiguous()
        L, Li, ok = cuda_chol.chol_linv_cuda(Tj, "chol_linv_batched")
        Lp, Lip, okp = cuda_chol.chol_linv_plain(Tj)
        torch.cuda.synchronize()
        say(2, f"K1 Toeplitz (20,256,256) jitter x{mult:g}: ok kernel "
               f"{int(ok.sum())}/20, plain {int(okp.sum())}/20, same blocks "
               f"{torch.equal(ok, okp)}")
        if bool((okp == 1).all()) and bool((ok == 1).all()):
            break
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
    ms = cuda_ms(lambda: cuda_chol.chol_linv_cuda(Tj, "chol_linv_batched"))
    pms = cuda_ms(lambda: cuda_chol.chol_linv_plain(Tj))
    results["chol_linv_batched"].update(ms=ms, plain_ms=pms)
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
    say(2, "K1 indefinite block 3: ok=0, others bit-identical, all finite")

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
    for t in (1, 8):
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
        V2 = V.clone()
        V2[-1000:] = 1e6
        U2 = cuda_interp.interp_transpose_cuda(tf, V2, m)
        check(torch.equal(U2, U), "K2 padding contributes")
        U3 = cuda_interp.interp_transpose_cuda(tf, V, m)
        check(torch.equal(U3, U), "K2 not deterministic")
        ms_t = cuda_ms(lambda: cuda_interp.interp_transpose_cuda(tf, V, m))
        pms_t = cuda_ms(lambda: cuda_interp.interp_transpose_plain(tf, V, m),
                        iters=2)
        ms_a = cuda_ms(lambda: cuda_interp.interp_apply_sum_cuda(tf, G))
        pms_a = cuda_ms(lambda: cuda_interp.interp_apply_sum_plain(tf, G),
                        iters=2)
        say(2, f"K2 t={t}: rel {eU:.2e}, {ms_t:.3f} ms vs plain {pms_t:.3f} ms;"
               f" K3 t={t}: rel {eO:.2e}, {ms_a:.3f} ms vs plain "
               f"{pms_a:.3f} ms; adjoint {adj:.1e}; padding exact; "
               f"K2 repeatable")
        if t == 1:  # the main path's width
            results["interp_transpose"] = dict(max_abs_err=max_abs(U, Up),
                                               ms=ms_t, plain_ms=pms_t)
            results["interp_apply_sum"] = dict(max_abs_err=max_abs(O, Op),
                                               ms=ms_a, plain_ms=pms_a)


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
    the two devices must make the same choices there."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import grid_solve
    from rpagp_torch.utils.config import load_spec

    spec = load_spec(SPEC).model
    n, D = 32768, 11
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(n, D, generator=gen)
    Wd = torch.randn(D, 11, generator=gen) / math.sqrt(D)
    y = torch.sin(x @ Wd).sum(1) / math.sqrt(11) + 0.1 * torch.randn(
        n, generator=gen)
    params0, buf0 = exact_gp.init_model(spec, D, generator=gen)

    def to(tree, d):  # fresh leaf copies on device d
        return {k: to(v, d) if isinstance(v, dict) else v.to(d, copy=True)
                for k, v in tree.items()}

    prepared = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        b = exact_gp.prepare_buffers(spec, to(params0, d), to(buf0, d),
                                     x.to(d), y_train=y.to(d))
        prepared[d] = (b, x.to(d), y.to(d), time.perf_counter() - t0)

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
            v = grid_solve.grid_mll(sp, p, b, xd, yd)
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


def phase4_main_path(results):
    import torch

    from rpagp_torch import runner
    from rpagp_torch.mll import mll
    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_chol, cuda_interp, grid_solve
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    dev = torch.device("cuda")
    exp = load_spec(SPEC)
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                             max_iters=10))
    t0 = time.perf_counter()
    ds = datasets.load_dataset("houseelectric")
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
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
    m = runner.run_split(exp, split, seed=0, device=dev, timings=timings)
    torch.cuda.synchronize()
    launches = {**cuda_chol.launches, **cuda_interp.launches}
    stats = dict(grid_solve.stats)
    peak = torch.cuda.max_memory_allocated()
    # factors in the run: one per training step + one in the posterior
    n_factor = m["iterations"] + 1
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
    leaves = [params["raw_noise"], params["mean_const"],
              *params["kernel"].values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=exp.train.lr)
    grid_solve.reset_stats()
    events = []
    for _ in range(6):  # the first is a warm-up
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        opt.zero_grad(set_to_none=True)
        loss = -mll(exp.model, params, buffers, x, y) / n
        loss.backward()
        opt.step()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events[1:]]
    say(4, f"5 extra steps: median {statistics.median(step_ms):.2f} ms/step "
           f"(all {', '.join(f'{v:.2f}' for v in step_ms)}); host reads "
           f"{grid_solve.stats['host_reads'] / 6:.2f}/step; loss "
           f"{float(loss.detach()):.5f}")


def main():
    os.environ.setdefault("RPAGP_NO_NATIVE", "1")  # numpy k-fold permutation
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase0_env()
    phase1_build()
    results = {}
    phase2_kernels(results)
    phase3_slice()
    phase4_main_path(results)
    source = {"chol_linv": "rpagp_torch/csrc/chol_linv.cu",
              "chol_linv_batched": "rpagp_torch/csrc/chol_linv.cu",
              "interp_transpose": "rpagp_torch/csrc/interp.cu",
              "interp_apply_sum": "rpagp_torch/csrc/interp.cu"}
    replaces = {"chol_linv": "rpagp/ops/pallas_chol.py:190",
                "chol_linv_batched": "rpagp/ops/pallas_chol.py:381",
                "interp_transpose": "rpagp/ops/pallas_interp.py:108",
                "interp_apply_sum": "rpagp/ops/pallas_interp.py:182"}
    kernels = [{"name": k, "route": "cuda", "source": source[k],
                "replaces": replaces[k], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]} for k, r in results.items()]
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
