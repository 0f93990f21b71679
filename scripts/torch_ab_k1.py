"""K1 (chol_linv, both kernels): this tree's against another checkout's, on
inputs where every matrix factors (ok = 1), bit for bit, and timed in
turns on one card.

    git archive <commit> | tar -x -C _checkout/parent
    python scripts/torch_ab_k1.py --other _checkout/parent

Builds the other checkout's kernel library with its own build module (in a
subprocess, into its own `rpagp_torch/_build/`) and loads it beside this
tree's. Both libraries' cooperative kernel (rpagp_chol_linv_coop) and
one-block kernel (rpagp_chol_linv) run on the same inputs:
- random SPD blocks: (1, 512, 512), (20, 256, 256), (3, 96, 96) and
  (200, 64, 64);
- the flagship's ladder blocks: rp_ski_houseelectric_j20's (20, 256, 256)
  RBF Toeplitz blocks (a grid over 32,768 random 11-d points, projection
  seed 1) at every level of grid_solve's jitter ladder, the matrices with
  ok = 1 held (a matrix's arithmetic never reads another's);
- the C-factor leaves: every (512, 512) diagonal leaf that
  block_chol hands K1 while that model's grid buffers are prepared (the
  anchor's factor of S) and in one grid_mll (p = 5120: ten leaves each),
  captured from this tree's wrapper.
A matrix is held when both libraries give it ok = 1; every (L, Linv, ok) of
it must agree bit for bit, across the libraries and across the two kernels.
The other library is called through the C interface it has: before the
failure repair its cooperative entry took no `fail` scratch.

--variants also builds patched copies of this tree's
`csrc/chol_linv_coop.cu` (PATCHES below, into `rpagp_torch/_build/ab_k1/`,
never on the path) and times them beside both libraries at the leaf's and
the ladder's shapes, with each build's registers (`-Xptxas -v`): they
take the failure rule's pieces out one at a time (the zeros after the
panel rows' substitution, the diagonal chain's mask), to say what each
costs on ok = 1 inputs (without the mask, ok flags are wrong on failing
inputs: the variants are timed on SPD blocks only).

Prints the card's name and power limit first, then one line per case
(matrices held, bit for bit or not, the cooperative kernel's ms other /
this / this / other at the leaf's and the ladder's shapes). Exits 1 if any
held matrix differs.
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
OUT = os.path.join(ROOT, "rpagp_torch", "_build", "ab_k1")

# scratch copies of csrc/chol_linv_coop.cu: (anchor, replacement) pairs
_NO_ZERO = ("""    for (unsigned f = *sFail; f != 0u; f &= f - 1u) {
      const int c = __ffs(f) - 1;
      reinterpret_cast<float*>(row)[c] = 0.0f;
      if (out != nullptr) out[tid][c] = 0.0f;
    }
""", "")
_NO_MASK = ("      fail |= okj ? 0u : 1u << j;\n", "")
PATCHES = {"no_zero": [_NO_ZERO], "no_mask": [_NO_MASK],
           "neither": [_NO_ZERO, _NO_MASK]}

_P, _I = ctypes.c_void_p, ctypes.c_int


def _other_lib(path):
    """The other checkout's library and the arity of its cooperative K1."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "from rpagp_torch.ops import _build; "
            "print(json.dumps([_build.build(), "
            "len(_build._SIGNATURES['rpagp_chol_linv_coop'])]))")
    line = subprocess.run([sys.executable, "-c", code, path],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    so, arity = json.loads(line)
    lib = ctypes.CDLL(so)
    lib.rpagp_chol_linv_coop.argtypes = [_P] * (arity - 5) + [_I] * 4 + [_P]
    lib.rpagp_chol_linv.argtypes = [_P] * 4 + [_I] * 2 + [_P]
    lib.rpagp_chol_linv_coop_grid.argtypes = [_I, _I, _P, _P]
    for fn in (lib.rpagp_chol_linv_coop, lib.rpagp_chol_linv,
               lib.rpagp_chol_linv_coop_grid):
        fn.restype = ctypes.c_int
    return lib, arity


def _runner(lib, arity):
    """(coop(A), one_block(A)) of one library: (L, Linv, ok) each, on a
    contiguous (B, b, b) CUDA batch, b a multiple of 32."""
    import torch

    from rpagp_torch.ops import _build

    grids = {}

    def outs(A):
        return (torch.empty_like(A), torch.empty_like(A),
                torch.empty(A.shape[0], device=A.device))

    def coop(A):
        B, b = A.shape[0], A.shape[-1]
        if (B, b) not in grids:
            G, C = ctypes.c_int(0), ctypes.c_int(0)
            _build.check(lib.rpagp_chol_linv_coop_grid(
                B, b, ctypes.addressof(G), ctypes.addressof(C)), "grid")
            grids[B, b] = (G.value, C.value)
        L, Linv, ok = outs(A)
        ptrs = [A.data_ptr(), L.data_ptr(), Linv.data_ptr(), ok.data_ptr()]
        if arity == 10:  # with the failed pivots' scratch
            fail = torch.empty(B * (b // 32), dtype=torch.int32,
                               device=A.device)
            ptrs.append(fail.data_ptr())
        _build.check(lib.rpagp_chol_linv_coop(
            *ptrs, B, b, *grids[B, b], _build.stream_ptr(A.device)), "coop")
        return L, Linv, ok

    def one_block(A):
        L, Linv, ok = outs(A)
        _build.check(lib.rpagp_chol_linv(
            A.data_ptr(), L.data_ptr(), Linv.data_ptr(), ok.data_ptr(),
            A.shape[0], A.shape[-1], _build.stream_ptr(A.device)),
            "one-block")
        return L, Linv, ok

    return coop, one_block


def _variant_libs():
    """{name: (library, registers of the cooperative kernels)} of this
    tree's chol_linv_coop.cu with PATCHES[name], one nvcc each, all
    started together."""
    import re

    from rpagp_torch.ops import _build

    csrc = os.path.join(ROOT, "rpagp_torch", "csrc")
    with open(os.path.join(csrc, "chol_linv_coop.cu")) as f:
        base = f.read()
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name, patch in PATCHES.items():
        src = base
        for anchor, new in patch:
            if src.count(anchor) != 1:
                raise RuntimeError(f"patch {name}: anchor not found once:\n"
                                   f"{anchor}")
            src = src.replace(anchor, new)
        cu, so = (os.path.join(OUT, f"{name}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(src)
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", csrc, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, job) in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        lib = ctypes.CDLL(so)
        lib.rpagp_chol_linv_coop.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        lib.rpagp_chol_linv_coop_grid.argtypes = [_I, _I, _P, _P]
        for fn in (lib.rpagp_chol_linv_coop, lib.rpagp_chol_linv_coop_grid):
            fn.restype = ctypes.c_int
        out[name] = (lib, "/".join(regs))
    return out


def _spd(B, b, seed, dev):
    import torch

    X = torch.randn(B, b, b, generator=torch.Generator().manual_seed(seed))
    return (X @ X.mT / b + 0.5 * torch.eye(b)).to(dev).contiguous()


def _ladder_blocks(dev):
    """The flagship model's Toeplitz blocks and base jitters, and the
    (512, 512) leaves K1 factors in prepare_buffers and one grid_mll,
    captured from this tree's K1 wrapper."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import cuda_chol, grid_solve, ski
    from rpagp_torch.utils.config import load_spec

    spec = load_spec(os.path.join(ROOT, "specs",
                                  "rp_ski_houseelectric_j20.json")).model
    gen = torch.Generator().manual_seed(1)
    params, buffers = exact_gp.init_model(spec, 11, generator=gen, device=dev)
    x = torch.randn(32768, 11, generator=gen).to(dev)
    y = torch.sin(x.sum(1))
    state = ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"], x,
                          spec.kernel.grid_size)
    T = grid_solve._toeplitz_blocks(spec.kernel, params["kernel"], state)
    eps0 = spec.grid_jitter * T[:, 0, 0]
    leaves = []
    wrapped = cuda_chol.chol_linv_cuda

    def capture(A, name):
        if name == "chol_linv":
            leaves.append(A.clone())
        return wrapped(A, name)

    cuda_chol.chol_linv_cuda = capture
    try:
        bufs = exact_gp.prepare_buffers(spec, params, buffers, x, y_train=y)
        with torch.no_grad():
            grid_solve.grid_mll(spec, params, bufs, x, y)
    finally:
        cuda_chol.chol_linv_cuda = wrapped
    torch.cuda.synchronize()
    return T, eps0, leaves


def _ms(fn, iters=20):
    import torch

    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--variants", action="store_true",
                    help="also time patched copies of this tree's kernel")
    args = ap.parse_args()
    import torch

    from rpagp_torch.ops import _build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    other, arity = _other_lib(os.path.abspath(args.other))
    mine = _runner(_build.lib(), len(_build._SIGNATURES["rpagp_chol_linv_coop"]))
    theirs = _runner(other, arity)
    print(f"this tree's cooperative entry takes "
          f"{len(_build._SIGNATURES['rpagp_chol_linv_coop'])} arguments, "
          f"the other's {arity}", flush=True)
    bad = 0

    def hold(label, A, timed=False):
        nonlocal bad
        runs = {}
        for who, (coop, one) in (("this", mine), ("other", theirs)):
            runs[who, "coop"] = coop(A)
            runs[who, "one"] = one(A)
        torch.cuda.synchronize()
        ok = runs["this", "coop"][2]
        held = [int(i) for i in torch.nonzero(
            (ok == 1) & (runs["other", "coop"][2] == 1)).flatten()]
        same = all(torch.equal(r[k][i], runs["this", "coop"][k][i])
                   for r in runs.values() for k in range(3) for i in held)
        flags = all(torch.equal(r[2], ok) for r in runs.values())
        bad += not (same and flags)
        line = (f"{label} {tuple(A.shape)}: {len(held)} of {A.shape[0]} "
                f"matrices with ok = 1 held, bit for bit across libraries and "
                f"kernels {same}; ok flags equal {flags}")
        if timed:
            co, ct = theirs[0], mine[0]
            t = [_ms(lambda: co(A)), _ms(lambda: ct(A)), _ms(lambda: ct(A)),
                 _ms(lambda: co(A))]
            line += (f"; cooperative kernel ms other/this/this/other "
                     f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {t[3]:.4f}")
        print(line, flush=True)

    hold("random SPD", _spd(1, 512, 0, dev), timed=True)
    hold("random SPD", _spd(20, 256, 1, dev), timed=True)
    hold("random SPD", _spd(3, 96, 2, dev))
    hold("random SPD", _spd(200, 64, 3, dev))
    T, eps0, leaves = _ladder_blocks(dev)
    eye = torch.eye(T.shape[-1], device=dev)
    from rpagp_torch.ops import grid_solve

    for mult in grid_solve._LADDER:
        hold(f"flagship ladder blocks at jitter x{mult:g}",
             (T + (mult * eps0)[:, None, None] * eye).contiguous(),
             timed=mult == grid_solve._LADDER[-1])
    for i, A in enumerate(leaves):
        hold(f"C-factor leaf {i}", A.contiguous(), timed=i == 0)
    if args.variants:
        variants = {k: (_runner(lib, 10)[0], regs)
                    for k, (lib, regs) in _variant_libs().items()}
        for A in (_spd(1, 512, 0, dev), _spd(20, 256, 1, dev)):
            ms = {"other": _ms(lambda: theirs[0](A)),
                  "this": _ms(lambda: mine[0](A))}
            for k, (coop, _) in variants.items():
                ms[k] = _ms(lambda: coop(A))
            ms["this again"] = _ms(lambda: mine[0](A))
            ms["other again"] = _ms(lambda: theirs[0](A))
            print(f"variants at {tuple(A.shape)}, cooperative kernel ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + "; registers (coop kernel instantiations): "
                  + ", ".join(f"{k} {r}" for k, (_, r) in variants.items()),
                  flush=True)
    print(f"{'all held matrices bit for bit' if not bad else f'{bad} cases differ'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
