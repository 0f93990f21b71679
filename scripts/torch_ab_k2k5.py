"""K5 (gram_mvm_bwd) and K2 (interp_transpose): this tree's kernels against
another checkout's, timed in turns on one card.

    git archive <commit> | tar -x -C _checkout/parent
    python scripts/torch_ab_k2k5.py --other _checkout/parent

Builds the other checkout's kernel library with its own build module (in a
subprocess, into its own `rpagp_torch/_build/`), loads it beside this
tree's, and at the paths' shapes times other, this, this, other by CUDA
events: K5 at the BBMM training shape (n = m = 14,939, J = 10, t = 11,
rbf) and K2 at the flagship's (J = 20, n = 1,844,352, m = 256, uniform
points) at t = 1 and t = 2. The other library is called through the C
interface it had before this tree changed it (K5's first design took a
(ceil(n / 64), J) dw scratch and no plan; K2's is unchanged). The two
results are compared as well. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _other_lib(path):
    so = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from rpagp_torch.ops import _build; print(_build.build())", path],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
    lib = ctypes.CDLL(so)
    lib.rpagp_gram_mvm_bwd.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.rpagp_interp_transpose.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    for fn in (lib.rpagp_gram_mvm_bwd, lib.rpagp_interp_transpose):
        fn.restype = ctypes.c_int
    return lib


def _ms(fn, iters=20):
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _rel(a, b):
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    args = ap.parse_args()
    import torch

    from rpagp_torch.ops import _build, cuda_gram, cuda_interp

    if not torch.cuda.is_available():
        print("torch_ab_k2k5: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other = _other_lib(os.path.abspath(args.other))
    _build.lib()
    dev = torch.device("cuda")
    stream = _build.stream_ptr(dev)
    gen = torch.Generator().manual_seed(0)

    # K5 at the BBMM training shape
    n, J, t = 14939, 10, 11
    z1, z2, V, G = (torch.randn(r, c, generator=gen).to(dev)
                    for r, c in ((n, J), (n, J), (n, t), (n, t)))
    w = torch.full((J,), 0.0693, device=dev)
    dz_o = torch.empty(n, J, device=dev)
    dw_o = torch.empty(J, device=dev)
    dw_part = torch.empty(-(-n // 64), J, device=dev)

    def k5_other():
        err = other.rpagp_gram_mvm_bwd(
            z1.data_ptr(), z2.data_ptr(), w.data_ptr(), V.data_ptr(),
            G.data_ptr(), dz_o.data_ptr(), dw_part.data_ptr(), dw_o.data_ptr(),
            n, n, J, t, 0, stream)
        assert err == 0, err

    def k5_this():
        return cuda_gram.gram_mvm_bwd_cuda(z1, z2, w, V, G, "rbf")

    k5_other()
    dz, dw = k5_this()
    torch.cuda.synchronize()
    turns = [(name, _ms(fn)) for name, fn in (("other", k5_other),
                                              ("this", k5_this),
                                              ("this", k5_this),
                                              ("other", k5_other))]
    print(f"K5 (n = m = {n}, J = {J}, t = {t}, rbf) in turns: "
          + ", ".join(f"{a} {b:.4f} ms" for a, b in turns)
          + f"; this vs other rel dz {_rel(dz, dz_o):.2e} dw "
          f"{_rel(dw, dw_o):.2e}", flush=True)

    # K2 at the flagship shape, uniform points
    J, n, m = 20, 1_844_352, 256
    tf = (1.0 + (m - 4.0) * torch.rand(J, n, generator=gen)).to(dev)
    for t in (1, 2):
        Vt = torch.randn(n, t, generator=gen).to(dev)
        VT = Vt.t().contiguous()
        U_o = torch.empty(J, t, m, device=dev)
        chunk = 16384
        part = torch.empty(-(-n // chunk) * J * t * m, device=dev)

        def k2_other():
            err = other.rpagp_interp_transpose(
                tf.data_ptr(), VT.data_ptr(), part.data_ptr(), U_o.data_ptr(),
                J, n, t, m, chunk, stream)
            assert err == 0, err

        def k2_this():
            return cuda_interp.interp_transpose_cuda(tf, Vt, m)

        k2_other()
        U = k2_this()
        torch.cuda.synchronize()
        turns = [(name, _ms(fn, iters=5 if name == "other" else 20))
                 for name, fn in (("other", k2_other), ("this", k2_this),
                                  ("this", k2_this), ("other", k2_other))]
        print(f"K2 (J = {J}, n = {n}, m = {m}, t = {t}, uniform) in turns: "
              + ", ".join(f"{a} {b:.4f} ms" for a, b in turns)
              + f"; this vs other rel {_rel(U, U_o):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
