"""K6 / K7 (the dense projected Gram and its backward, csrc/gram_mvm.cu)
timed on one card against the path a projection Gram took before them,
and against their plain twins.

    python scripts/torch_ab_dense_gram.py [--reps 20] [--other DIR]

At the exact cell's K(x, x) (J 20, n = m = 3,723), its predictor's
cross Gram (J 20, n 414, m 3,723) and a pivoted Cholesky row of the
BBMM elevators spec (J 10, n 1, m 14,939), RBF:
- K6 and K7 through their C entries (rpagp_dense_gram,
  rpagp_dense_gram_bwd), the scratch allocated outside the timed launches;
- the (J, n, m) path (kernels._materialized_projection_gram), its value
  and the backward of sum(K * G) by autograd, wrt the coordinates and the
  weights;
- the plain twins (cuda_gram.dense_gram_plain, dense_gram_bwd_plain).
Each time is CUDA events around `--reps` calls after two warm-up calls,
over the count, in turns (kernel, plain, kernel). Beside each: the least
time by counts (gpbench/counts/gram.py against the float32 and HBM
peaks) and by the exp unit (16 exps a clock an SM, 132 SMs, at the clock
nvidia-smi reads). Prints the card's name and power limit first, one
JSON line a shape, and the kernels' K and gradients against the float64
twins (rel, norm-wise).

With --other, K6 of another checkout (built by its own build module in a
subprocess, called through the same C entry) against this tree's, in
turns other, this, this, other, on the thin calls: pivoted Cholesky rows
(1 row against elevators' 14,939 points and sml's 3,723), 8 rows, and
one row against the flagship's 1,844,352 points; one JSON line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _time(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _other_lib(path: str):
    """The other checkout's kernel library, built by its own build module."""
    so = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from rpagp_torch.ops import _build; print(_build.build())", path],
        capture_output=True, text=True, check=True).stdout.split()[-1]
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rpagp_dense_gram.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.rpagp_dense_gram.restype = ctypes.c_int
    return lib


def _thin(other_path: str, reps: int) -> None:
    """K6 of the other checkout and of this tree on the thin calls."""
    import torch

    from rpagp_torch.ops import _build

    dev = torch.device("cuda")
    libs = {"this": _build.lib(), "other": _other_lib(other_path)}
    stream = _build.stream_ptr(dev)
    for J, n, m in ((10, 1, 14939), (20, 1, 3723), (20, 8, 3723),
                    (20, 1, 1_844_352)):
        g = torch.Generator(device="cpu").manual_seed(m)
        u1 = (1.5 * torch.randn(J, n, generator=g)).to(dev)
        u2 = (1.5 * torch.randn(J, m, generator=g)).to(dev)
        w = (0.2 + torch.rand(J, generator=g)).to(dev)
        outs = {k: torch.empty(n, m, device=dev) for k in libs}

        def k6(side):
            _build.check(libs[side].rpagp_dense_gram(
                u1.data_ptr(), u2.data_ptr(), w.data_ptr(),
                outs[side].data_ptr(), n, m, J, 0, 0, stream), "dense_gram")

        res = {"J": J, "n": n, "m": m, "reps": reps}
        for i, side in enumerate(("other", "this", "this", "other")):
            res[f"{side}_ms" + ("_again" if i > 1 else "")] = _time(
                lambda: k6(side), reps)
        res["this_vs_other_rel"] = _rel(outs["this"], outs["other"])
        res["bit_equal"] = bool(torch.equal(outs["this"], outs["other"]))
        print(json.dumps(res), flush=True)


def _rel(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main(argv=None) -> int:
    import torch

    from gpbench.counts import gram, peaks
    from rpagp_torch.ops import _build, cuda_gram, kernels
    from rpagp_torch.ops.kernels import KernelSpec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--other", help="root of a checkout whose K6 to time "
                                    "beside this tree's on thin calls")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(_smi("name,power.limit"), flush=True)
    if args.other:
        _thin(os.path.abspath(args.other), args.reps)
        return 0
    dev = torch.device("cuda")
    lib = _build.lib()
    sm_mhz = float(_smi("clocks.max.sm").split()[0])
    stream = _build.stream_ptr(dev)
    base = "rbf"
    for J, n, m in ((20, 3723, 3723), (20, 414, 3723), (10, 1, 14939)):
        same = n == m
        spec = KernelSpec.polynomial(J=J)
        g = torch.Generator(device="cpu").manual_seed(n)
        u1 = (1.5 * torch.randn(J, n, generator=g)).to(dev)
        u2 = u1 if same else (1.5 * torch.randn(J, m, generator=g)).to(dev)
        w = (0.2 + torch.rand(J, generator=g)).to(dev)
        G = torch.randn(n, m, generator=g).to(dev)
        K = torch.empty(n, m, device=dev)
        du1, dw = torch.empty_like(u1), torch.empty_like(w)
        du2 = du1 if same else torch.empty_like(u2)
        scratch = torch.empty(cuda_gram._dense_bwd_scratch(n, m, J),
                              device=dev)

        def k6():
            _build.check(lib.rpagp_dense_gram(
                u1.data_ptr(), u2.data_ptr(), w.data_ptr(), K.data_ptr(), n,
                m, J, 0, 0, stream), "dense_gram")

        def k7():
            _build.check(lib.rpagp_dense_gram_bwd(
                u1.data_ptr(), u2.data_ptr(), w.data_ptr(), G.data_ptr(),
                du1.data_ptr(), du2.data_ptr(), dw.data_ptr(),
                scratch.data_ptr(), n, m, J, 0, int(same), stream),
                "dense_gram_bwd")

        v1 = u1.clone().requires_grad_(True)
        v2 = v1 if same else u2.clone().requires_grad_(True)
        vw = w.clone().requires_grad_(True)

        def old_fwd():
            with torch.no_grad():
                kernels._materialized_projection_gram(spec, u1, u2, w)

        def old_bwd():
            Ko = kernels._materialized_projection_gram(spec, v1, v2, vw)
            torch.autograd.grad(Ko, (v1, vw) if same else (v1, v2, vw), G)

        res = {"J": J, "n": n, "m": m, "reps": args.reps}
        for name, fn in (("k6_ms", k6), ("old_fwd_ms", old_fwd),
                         ("k6_ms_again", k6), ("k7_ms", k7),
                         ("old_fwd_bwd_ms", old_bwd), ("k7_ms_again", k7),
                         ("twin_fwd_ms", lambda: cuda_gram.dense_gram_plain(
                             u1, u2, w, base)),
                         ("twin_bwd_ms", lambda: cuda_gram.dense_gram_bwd_plain(
                             u1, u2, w, G, base))):
            torch.cuda.empty_cache()
            res[name] = _time(fn, args.reps)
        exp_s = J * n * m / (16 * 132 * sm_mhz * 1e6)
        for d in ("fwd", "bwd"):
            nbytes, flops = gram.work(J, n, m, d)
            res[f"bound_{d}_ms"] = peaks.bound_s(nbytes, flops) * 1e3
            res[f"bound_{d}_term"] = ("f32 ops" if flops / peaks.F32_FLOPS_S
                                      > nbytes / peaks.HBM_BYTES_S
                                      else "bytes")
        res["exp_bound_ms"] = exp_s * 1e3
        res["sm_max_mhz"] = sm_mhz
        k6()
        k7()
        a1, aw, aG = u1.double(), w.double(), G.double()
        a2 = a1 if same else u2.double()
        p1, p2, pw = cuda_gram.dense_gram_bwd_plain(a1, a2, aw, aG, base)
        res["rel_K"] = _rel(K, cuda_gram.dense_gram_plain(a1, a2, aw, base))
        res["rel_du1"] = _rel(du1, p1 + p2 if same else p1)
        if not same:
            res["rel_du2"] = _rel(du2, p2)
        res["rel_dw"] = _rel(dw, pw)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
