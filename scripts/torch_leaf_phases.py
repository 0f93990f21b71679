"""Where the time of K1's cooperative kernel goes, phase by phase, on a
CUDA card: the 512 leaf (B = 1) by default, the ladder batch with
--B 20 --b 256.

Builds an instrumented copy of rpagp_torch/csrc/chol_linv_coop.cu under
rpagp_torch/_build/phases/ (which git ignores): block 0 stamps
%globaltimer as each phase starts, every block as its work in the phase
ends (the latest kept), and block 0's thread 0 reads clock64 between the
steps of its diagonal chain (matrix 0's). Runs it on B random SPD (b, b)
matrices, holds its outputs bit for bit against the uninstrumented
kernel, and prints the phases' work and barrier times and the chain's
cycles per step.

    python scripts/torch_leaf_phases.py [--B 1] [--b 512] [--seed 0]

The stamps cost a block barrier and an atomic per phase: the kernel time
it prints beside the uninstrumented one shows how much.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "rpagp_torch", "csrc")
OUT = os.path.join(ROOT, "rpagp_torch", "_build", "phases")

STAMPS = r'''
__device__ unsigned long long g_start[64], g_end[64];
__device__ long long g_clk[64][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_START(ph) if (g == 0 && tid == 0) g_start[ph] = gtime();
#define STAMP_END(ph) __syncthreads(); \
  if (tid == 0) atomicMax(&g_end[ph], gtime());
#define CLK(k, s) if (threadIdx.x == 0 && blockIdx.x == 0) \
  g_clk[k][s] = clock64();
extern "C" int leaf_stamps(unsigned long long* s, unsigned long long* e,
                           long long* c) {
  cudaMemcpyFromSymbol(s, g_start, sizeof(g_start));
  cudaMemcpyFromSymbol(e, g_end, sizeof(g_end));
  cudaMemcpyFromSymbol(c, g_clk, sizeof(g_clk));
  static unsigned long long z[64] = {0};
  cudaMemcpyToSymbol(g_end, z, sizeof(z));
  return (int)cudaGetLastError();
}
namespace {
'''

# (anchor, replacement): each anchor must occur once in the source.
# Phases: 0 the set-up, 1 + 2 kp phase A of panel kp, 2 + 2 kp its phase B.
# Clock slots of panel k's chain: 5 look start, 7 rows solved, 0 tile
# updated, 1 factor start, 2 factor done (warp), 4 factor written, 6 inverse
# start, 3 inverse done (warp).
PATCH = [
    ("namespace {\n", STAMPS),
    ("                                            float* L, int b, int o) {\n"
     "  const int tid = threadIdx.x;\n",
     "                                            float* L, int b, int o) {\n"
     "  const int tid = threadIdx.x;\n  CLK(o / NB, 1)\n"),
    ("#pragma unroll\n    for (int k = 0; k < NB; ++k) sDT[k][i] = a[k];\n",
     "    CLK(o / NB, 2)\n#pragma unroll\n"
     "    for (int k = 0; k < NB; ++k) sDT[k][i] = a[k];\n"),
    ("      *failp = fail;\n    }\n  }\n  __syncthreads();\n"
     "  return fail == 0u;\n}",
     "      *failp = fail;\n    }\n  }\n  __syncthreads();\n"
     "  CLK(o / NB, 4)\n  return fail == 0u;\n}"),
    ("      Linv[(size_t)(o + r) * b + o + c] = y[r];\n    }\n  }\n",
     "      Linv[(size_t)(o + r) * b + o + c] = y[r];\n    }\n  }\n"
     "  CLK(o / NB, 3)\n"),
    ("  const size_t bb = (size_t)b * b;\n",
     "  const size_t bb = (size_t)b * b;\n  STAMP_START(0)\n"),
    ("    dt_at = dinv_at = mt * npan;\n  }\n  grid.sync();\n",
     "    dt_at = dinv_at = mt * npan;\n  }\n  STAMP_END(0)\n"
     "  grid.sync();\n"),
    ("    const int o = kp * NB, T = npan - 1 - kp;\n",
     "    const int o = kp * NB, T = npan - 1 - kp;\n"
     "    STAMP_START(1 + 2 * kp)\n"),
    ("    if (T == 0) break;\n",
     "    if (T == 0) {\n      STAMP_END(1 + 2 * kp)\n      break;\n    }\n"),
    ("      const int t1 = (kp + 1) * NB;\n",
     "      const int t1 = (kp + 1) * NB;\n      CLK(kp + 1, 5)\n"),
    ("      solve_rows(L, b, kp + 1, o, sDT, &sFail, sA);\n"
     "      __syncthreads();\n",
     "      solve_rows(L, b, kp + 1, o, sDT, &sFail, sA);\n"
     "      __syncthreads();\n"
     "      CLK(kp + 1, 7)\n"),
    ("      for (int u = 0; u < 4; ++u) sB[r][c0 + 8 * u] -= acc[u];\n"
     "      __syncthreads();\n",
     "      for (int u = 0; u < 4; ++u) sB[r][c0 + 8 * u] -= acc[u];\n"
     "      __syncthreads();\n      CLK(kp + 1, 0)\n"),
    ("      dt_at = mt * npan + kp + 1;\n    }\n    grid.sync();\n",
     "      dt_at = mt * npan + kp + 1;\n    }\n"
     "    STAMP_END(1 + 2 * kp)\n    grid.sync();\n"
     "    STAMP_START(2 + 2 * kp)\n"),
    ("      invert_tile(sDT, sDinv, Linv_all + mt * bb, b, (kp + 1) * NB);\n"
     "      dinv_at = at;\n    }\n    grid.sync();\n",
     "      CLK(kp + 1, 6)\n"
     "      invert_tile(sDT, sDinv, Linv_all + mt * bb, b, (kp + 1) * NB);\n"
     "      dinv_at = at;\n    }\n"
     "    STAMP_END(2 + 2 * kp)\n    grid.sync();\n"),
]


def build():
    from rpagp_torch.ops import _build

    with open(os.path.join(CSRC, "chol_linv_coop.cu")) as f:
        src = f.read()
    for anchor, new in PATCH:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in chol_linv_coop.cu:"
                               f"\n{anchor}")
        src = src.replace(anchor, new)
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "chol_linv_coop_phases.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(OUT, "libcoop_phases.so")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", CSRC, "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rpagp_chol_linv_coop.argtypes = [P, P, P, P, P, I, I, I, I, P]
    lib.rpagp_chol_linv_coop_grid.argtypes = [I, I, P, P]
    lib.leaf_stamps.argtypes = [P, P, P]
    return lib


def main():
    import numpy as np
    import torch

    from rpagp_torch.ops import _build, cuda_chol

    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=1)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    B, b = args.B, args.b
    if not torch.cuda.is_available() or b % 32:
        sys.exit("needs a CUDA device and b a multiple of 32")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    X = torch.randn(B, b, b, generator=gen)
    A = (X @ X.mT / b + 0.5 * torch.eye(b)).to(dev).contiguous()
    L, Linv, ok = (torch.empty_like(A), torch.empty_like(A),
                   torch.empty(B, device=dev))
    fail = torch.empty(B * (b // 32), dtype=torch.int32, device=dev)
    G, C = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib.rpagp_chol_linv_coop_grid(B, b, ctypes.addressof(G),
                                               ctypes.addressof(C)),
                 "occupancy query")
    s = (ctypes.c_ulonglong * 64)()
    e = (ctypes.c_ulonglong * 64)()
    c = (ctypes.c_longlong * 512)()

    def launch():
        _build.check(lib.rpagp_chol_linv_coop(
            A.data_ptr(), L.data_ptr(), Linv.data_ptr(), ok.data_ptr(),
            fail.data_ptr(), B, b, G.value, C.value, _build.stream_ptr(dev)),
            "instrumented K1 kernel")

    for _ in range(5):  # the last run's stamps are read
        launch()
        torch.cuda.synchronize()
        lib.leaf_stamps(ctypes.addressof(s), ctypes.addressof(e),
                        ctypes.addressof(c))
    name = "chol_linv" if B == 1 else "chol_linv_batched"
    ref = cuda_chol.chol_linv_cuda(A, name)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip((L, Linv, ok), ref))

    def ms(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for _ in range(3):
            fn()
        ev[0].record()
        for _ in range(20):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / 20

    t_inst = ms(launch)
    t_ref = ms(lambda: cuda_chol.chol_linv_cuda(A, name))
    print(f"B = {B}, b = {b}, G = {G.value} blocks, C = {C.value} chain "
          f"blocks; instrumented {t_inst:.4f} ms, uninstrumented "
          f"{t_ref:.4f} ms; outputs bit for bit equal: {same}")

    S, E = np.array(s[:], np.int64), np.array(e[:], np.int64)
    C = np.array(c[:], np.int64).reshape(64, 8)
    npan = b // 32
    last = 2 * npan - 1  # phase A of the last panel ends the kernel
    work = {"set-up": E[0] - S[0]}
    sync = {"set-up": S[1] - E[0]}
    for name, phases in (("A", range(1, last + 1, 2)),
                         ("B", range(2, last, 2))):
        work[name] = sum(E[p] - S[p] for p in phases)
        sync[name] = sum(S[p + 1] - E[p] for p in phases if p < last)
    span = E[last] - S[0]
    print(f"span {span / 1e3:.2f} us over {npan} panels: "
          + "; ".join(f"{k} work {work[k] / 1e3:.2f} us, barriers "
                      f"{sync[k] / 1e3:.2f} us" for k in work))
    steps = {"rows solved (with loads)": (5, 7), "tile updated": (7, 0),
             "factor (warp)": (1, 2), "factor written": (2, 4),
             "inverse (warp, phase B)": (6, 3)}
    panels = range(2, npan - 1)  # past the first panels' cold caches
    print("block 0's chain (matrix 0), median cycles per panel: " + "; ".join(
        f"{k} {statistics.median(C[p, j] - C[p, i] for p in panels):.0f}"
        for k, (i, j) in steps.items()))
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
