"""K5 (gram_mvm_bwd) and K2 (interp_transpose): this tree's kernels against
another checkout's, timed in turns on one card.

    git archive <commit> | tar -x -C _checkout/parent
    python scripts/torch_ab_k2k5.py --other _checkout/parent [--smem]

Builds the other checkout's kernel library with its own build module (in a
subprocess, into its own `rpagp_torch/_build/`), loads it beside this
tree's, and at the paths' shapes times other, this, this, other by CUDA
events: K5 at the BBMM training shape (n = m = 14,939, J = 10, t = 11,
rbf), and K2 at the flagship's (J = 20, n = 1,844,352, m = 256) at t = 1,
2 (grid prepare), 9 (every SKI + BBMM CG iteration; uniform points and
Gaussian ones, the flagship's projections of Gaussian data over their
range), 512 and 513 (the posteriors' cross MVMs), and at sml's (J = 20,
n = 3,723, m = 512) at t = 11. The other library is called through the C
interface both trees have (tfrac, V (n, t), its scratch and its own
wrapper's chunk, from its `cuda_interp.transpose_chunk`), this tree's
through its wrapper (the routes it took are printed); the two results are
compared, bit for bit at t <= 2. --smem (alone, or before the A/B) builds
and runs a micro-benchmark of the one-column route's shared-memory access
pattern instead: each lane its own bank, rounds of 4 read-modify-writes (or
4 stores, or 4 loads) at random rows, 6 one-warp blocks an SM (and blocks
of 2 and 4 warps), and prints the SM clocks a round costs. Prints the
card's name and power limit first.
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

_P, _I = ctypes.c_void_p, ctypes.c_int


# K2's shapes: (J, n, m, t, points)
_K2_SHAPES = [(20, 1_844_352, 256, 1, "uniform"), (20, 1_844_352, 256, 2, "uniform"),
              (20, 1_844_352, 256, 9, "uniform"), (20, 1_844_352, 256, 9, "gaussian"),
              (20, 1_844_352, 256, 512, "uniform"), (20, 1_844_352, 256, 513, "uniform"),
              (20, 3723, 512, 11, "uniform")]


def _other_lib(path):
    """The other checkout's library and its wrapper's K2 chunk at each of
    _K2_SHAPES."""
    shapes = [(J, n, t, m) for J, n, m, t, _ in _K2_SHAPES]
    out = subprocess.run(
        [sys.executable, "-c", "import sys, json; sys.path.insert(0, sys.argv[1]); "
         "from rpagp_torch.ops import _build, cuda_interp; print(_build.build()); "
         "print(json.dumps([cuda_interp.transpose_chunk(*s) for s in "
         "json.loads(sys.argv[2])]))", path, json.dumps(shapes)],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    lib = ctypes.CDLL(out[-2])
    lib.rpagp_gram_mvm_bwd.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.rpagp_interp_transpose.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    for fn in (lib.rpagp_gram_mvm_bwd, lib.rpagp_interp_transpose):
        fn.restype = ctypes.c_int
    return lib, json.loads(out[-1])


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


_SMEM_BENCH = r"""
#include <cuda_runtime.h>
#include <cstdio>
// MODE 0: 4 read-modify-writes a round; 1: 4 stores; 2: 4 loads
template <int MODE>
__global__ void rounds_kernel(float* out, int rounds, int rows) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* base = sm + warp * rows * 32;
  for (int e = lane; e < rows * 32; e += 32) base[e] = 0.f;
  __syncwarp();
  float* a = base + lane;
  unsigned x = (blockIdx.x * 131 + threadIdx.x) * 2654435761u;
  float acc = 0.f;
  for (int i = 0; i < rounds; ++i) {
    x = x * 1664525u + 1013904223u;
    float* q = a + (int)((x >> 10) % (unsigned)(rows - 4)) * 32;
    const float v = (float)(x & 255);
    if (MODE == 0) {
      const float a0 = q[0], a1 = q[32], a2 = q[64], a3 = q[96];
      q[0] = a0 + v; q[32] = a1 + 2 * v; q[64] = a2 + 3 * v; q[96] = a3 + v;
    } else if (MODE == 1) {
      q[0] = v; q[32] = 2 * v; q[64] = 3 * v; q[96] = v;
    } else {
      acc += q[0] + q[32] + q[64] + q[96] + v;
    }
  }
  __syncwarp();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc + a[lane * 32];
}
int main() {
  const int rows = 264, rounds = 4096, sms = 132;  // m = 256 copies
  float* out;
  cudaMalloc(&out, 1 << 26);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto run = [&](auto kern, const char* name, int w) {
    const size_t bytes = (size_t)w * rows * 32 * 4;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    int occ = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, 32 * w, bytes);
    const int blocks = sms * occ * 8;
    kern<<<blocks, 32 * w, bytes>>>(out, rounds, rows);
    cudaEventRecord(e0);
    kern<<<blocks, 32 * w, bytes>>>(out, rounds, rows);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    const double warp_rounds = (double)blocks * w * rounds;
    printf("%-16s blocks of %d warp(s), %2d warps an SM: %.3f ms, %.2f SM "
           "clocks a warp's round at 1.98 GHz (%s)\n", name, w, occ * w, ms,
           ms * 1e-3 * 1.98e9 * sms / warp_rounds,
           cudaGetErrorString(cudaGetLastError()));
  };
  run(rounds_kernel<0>, "4 RMW a round", 1);
  run(rounds_kernel<0>, "4 RMW a round", 2);
  run(rounds_kernel<0>, "4 RMW a round", 4);
  run(rounds_kernel<1>, "4 stores", 1);
  run(rounds_kernel<2>, "4 loads", 1);
  return 0;
}
"""


def _smem_bench():
    """Builds and runs _SMEM_BENCH under rpagp_torch/_build/ (git-ignored)."""
    from rpagp_torch.ops import _build

    work = os.path.join(_build.BUILD_DIR, "smem_bench")
    os.makedirs(work, exist_ok=True)
    src, exe = os.path.join(work, "bench.cu"), os.path.join(work, "bench")
    with open(src, "w") as f:
        f.write(_SMEM_BENCH)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-o", exe, src], check=True)
    print(subprocess.run([exe], capture_output=True, text=True,
                         check=True).stdout, end="", flush=True)


def _rel(a, b):
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--smem", action="store_true",
                    help="run the shared-memory micro-benchmark")
    args = ap.parse_args()
    import torch

    from rpagp_torch.ops import _build, cuda_gram, cuda_interp

    if not torch.cuda.is_available():
        print("torch_ab_k2k5: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.smem:
        _smem_bench()
    if not args.other:
        return 0
    other, chunks_o = _other_lib(os.path.abspath(args.other))
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
    Gb, S = cuda_gram.gram_mvm_bwd_plan(n, n, J, t, "rbf", dev)
    scratch = torch.empty(cuda_gram._bwd_scratch(n, n, J, t, S), device=dev)

    def k5_other():
        err = other.rpagp_gram_mvm_bwd(
            z1.data_ptr(), z2.data_ptr(), w.data_ptr(), V.data_ptr(),
            G.data_ptr(), dz_o.data_ptr(), dw_o.data_ptr(), scratch.data_ptr(),
            n, n, J, t, 0, S, Gb, stream)
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

    # K2 at the flagship's and sml's shapes
    for (J, n, m, t, kind), chunk_o in zip(_K2_SHAPES, chunks_o):
        if kind == "uniform":
            tf = 1.0 + (m - 4.0) * torch.rand(J, n, generator=gen)
        else:  # Gaussian projections over their range and 2 cells each side
            z = torch.randn(J, n, generator=gen)
            lo, hi = z.min(1, keepdim=True).values, z.max(1, keepdim=True).values
            tf = 2.0 + (z - lo) / (hi - lo) * (m - 5.0)
        tf = tf.to(dev)
        Vt = torch.randn(n, t, generator=gen).to(dev)
        part_o = torch.empty(-(-n // chunk_o) * J * t * m, device=dev)
        U_o = torch.empty(J, t, m, device=dev)

        def k2_other():
            err = other.rpagp_interp_transpose(
                tf.data_ptr(), Vt.data_ptr(), part_o.data_ptr(), U_o.data_ptr(),
                J, n, t, m, chunk_o, stream)
            assert err == 0, err
            return U_o

        def k2_this():
            return cuda_interp.interp_transpose_cuda(tf, Vt, m)

        k2_other()
        before = dict(cuda_interp.launches)
        U = k2_this()
        torch.cuda.synchronize()
        routes = [k.split(".")[1] for k in before
                  if "." in k and cuda_interp.launches[k] > before[k]]
        iters = 3 if t >= 512 else 20
        turns = [(name, _ms(fn, iters=iters))
                 for name, fn in (("other", k2_other), ("this", k2_this),
                                  ("this", k2_this), ("other", k2_other))]
        same = (f"; bit for bit {torch.equal(U, U_o)}" if t <= 2 else "")
        print(f"K2 (J = {J}, n = {n}, m = {m}, t = {t}, {kind}) in turns: "
              + ", ".join(f"{a} {b:.4f} ms" for a, b in turns)
              + f"; this vs other rel {_rel(U, U_o):.2e}{same}; routes "
              f"{'+'.join(routes)}", flush=True)
        del U_o, part_o, tf, Vt, U
    return 0


if __name__ == "__main__":
    sys.exit(main())
