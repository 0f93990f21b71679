"""K3 (interp_apply_sum): this tree's kernel against another checkout's,
timed in turns on one card, beside variants that are never on the path.

    git archive <commit> | tar -x -C _checkout/parent
    python scripts/torch_ab_k3.py --other _checkout/parent [--variants]

Builds the other checkout's kernel library with its own build module (in a
subprocess, into its own `rpagp_torch/_build/`), loads it beside this
tree's, and times other, this, this, other by CUDA events at:
- the flagship shape (J = 20, n = 1,844,352, m = 256) at t = 1 on uniform
  points, and on the synthetic HouseElectric split 0's own tfrac (train);
- the split's test tfrac (n_test = 204,928), four copies taken in turn
  so that each call reads its tfrac from HBM and not from the 50 MB L2;
- t = 8 and t = 11 on uniform points.
Each kernel is timed through its library's C entry with its output
allocated once: a timing loop through this tree's Python wrapper is set
at n_test by the wrapper's host time, not by the kernel. The other
library is called through the C interface it has: before the redesign
of K3 that is (tfrac, G, out, J, n, t, m, ld, stream) with at most 8
columns a launch, which its wrapper fed slices of G copied to be
contiguous (the copies are timed with it, as its wrapper made them).

--variants adds scratch kernels that this script compiles itself into
`rpagp_torch/_build/ab_k3/`, at t = 1 on uniform points and on the
split's tfrac (and the rows_ patches at t = 8):
- `today`: the one-thread-a-point kernel of K3 before its redesign,
  verbatim; `weights`: the same with the gathers of G dropped (the taps'
  weights summed instead); `hoist`: the same with all J tfrac loads of a
  point issued before its first gather; `hoist_weights`: both changes.
  Together they say whether the loads of tfrac (HBM latency) or the
  gathers set that kernel's pace.
- patched copies of this tree's `csrc/interp.cu` (PATCHES below): the
  redesigned kernel at t = 1 with its table reads replaced by a constant,
  with nothing but its loads of tfrac, and with other load and block
  settings.
Prints the card's name and power limit first, then one line per case with
each kernel's times, the byte bound and the results' agreement.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "rpagp_torch", "_build", "ab_k3")
HBM_BYTES_S = 3.35e12  # the card's published HBM rate (chip_smoke.py)

_P, _I = ctypes.c_void_p, ctypes.c_int

# K3 as it was before its redesign (csrc/interp.cu `apply_sum_kernel`, one
# thread a point), and three variants of it
VARIANTS_CU = r'''
#include <cuda_runtime.h>
namespace {
constexpr int T_MAX = 8;
constexpr int NT = 256;
constexpr int JH = 32;  // hoist: components whose loads go out first
constexpr int NO_CELL = -1000000;
__device__ __forceinline__ float inner_w(float s) {
  return ((1.5f * s - 2.5f) * s) * s + 1.0f;
}
__device__ __forceinline__ float outer_w(float s) {
  return ((-0.5f * s + 2.5f) * s - 4.0f) * s + 2.0f;
}
__device__ __forceinline__ int taps(float tf, int m, float w[4]) {
  if (!(tf > -8.0f && tf < (float)(m + 8))) {
    w[0] = w[1] = w[2] = w[3] = 0.0f;
    return NO_CELL;
  }
  float fl = floorf(tf);
  float f = tf - fl, g = 1.0f - f;
  w[0] = outer_w(1.0f + f);
  w[1] = inner_w(f);
  w[2] = inner_w(g);
  w[3] = outer_w(1.0f + g);
  return (int)fl;
}
// the taps of point i, component j, added into acc (GATHER: w G; else w)
template <bool GATHER>
__device__ __forceinline__ void add_point(float acc[T_MAX], float tf,
                                          const float* __restrict__ G, int j,
                                          int t, int m) {
  float w[4];
  const int i0 = taps(tf, m, w);
  if (i0 == NO_CELL) return;
  const float* Gj = G + (size_t)j * t * m;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int c = i0 - 1 + d;
    if (c >= 0 && c < m) {
#pragma unroll
      for (int k = 0; k < T_MAX; ++k)
        if (k < t) acc[k] += GATHER ? w[d] * __ldg(Gj + (size_t)k * m + c)
                                    : w[d];
    }
  }
}
template <bool GATHER, bool HOIST>
__global__ void __launch_bounds__(NT)
k3_kernel(const float* __restrict__ tfrac, const float* __restrict__ G,
          float* __restrict__ out, int J, int n, int t, int m, int ld) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[T_MAX];
#pragma unroll
  for (int k = 0; k < T_MAX; ++k) acc[k] = 0.0f;
  if (HOIST) {
    float tv[JH];
#pragma unroll
    for (int j = 0; j < JH; ++j)
      tv[j] = j < J ? tfrac[(size_t)j * n + i] : -100.0f;
#pragma unroll
    for (int j = 0; j < JH; ++j)
      if (j < J) add_point<GATHER>(acc, tv[j], G, j, t, m);
  } else {
    for (int j = 0; j < J; ++j)
      add_point<GATHER>(acc, tfrac[(size_t)j * n + i], G, j, t, m);
  }
#pragma unroll
  for (int k = 0; k < T_MAX; ++k)
    if (k < t) out[(size_t)i * ld + k] = acc[k];
}
}  // namespace
// which: 0 today, 1 weights, 2 hoist, 3 hoist_weights; t <= 8, J <= 32
extern "C" int k3_variant(int which, const float* tfrac, const float* G,
                          float* out, int J, int n, int t, int m, int ld,
                          void* stream) {
  if (t < 1 || t > T_MAX || J < 1 || J > JH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (n + NT - 1) / NT;
  if (which == 0)
    k3_kernel<true, false><<<nb, NT, 0, s>>>(tfrac, G, out, J, n, t, m, ld);
  else if (which == 1)
    k3_kernel<false, false><<<nb, NT, 0, s>>>(tfrac, G, out, J, n, t, m, ld);
  else if (which == 2)
    k3_kernel<true, true><<<nb, NT, 0, s>>>(tfrac, G, out, J, n, t, m, ld);
  else
    k3_kernel<false, true><<<nb, NT, 0, s>>>(tfrac, G, out, J, n, t, m, ld);
  return (int)cudaGetLastError();
}
'''
VARIANTS = ("today", "weights", "hoist", "hoist_weights")

# name -> [(anchor, replacement)] on this tree's csrc/interp.cu (t = 1, the
# shifted kernel, unless the name starts with rows_); each anchor must
# occur once. no_table: the table load replaced by a constant; stream:
# nothing computed, the tfrac loads summed (what the stream alone takes);
# ldg: tfrac loaded through the read-only path, not evict-first; jc2 /
# jc8: 2 or 8 components' loads out together (4 on the path);
# two_blocks: two blocks of 512 threads an SM, each with half the table
# bytes; rows_no_table, rows_jc8: the rows kernel without its table
# loads, and with 8 components' loads out together (4 on the path);
# rows_lane_clamp: each lane clamps the point's tfrac, not the loading
# lane.
_BODY = """          acc[p] = fmaf(outer_w(1.0f + f), v.x, acc[p]);
          acc[p] = fmaf(inner_w(f), v.y, acc[p]);
          acc[p] = fmaf(inner_w(g), v.z, acc[p]);
          acc[p] = fmaf(outer_w(1.0f + g), v.w, acc[p]);"""
_JC8 = ("constexpr int K3_JC = 4;", "constexpr int K3_JC = 8;")
_TWO_BLOCKS = [("constexpr int K3_BLOCKS_PER_SM = 1;",
                "constexpr int K3_BLOCKS_PER_SM = 2;"),
               ("constexpr int K3_SMEM = 220 * 1024;",
                "constexpr int K3_SMEM = 110 * 1024;")]
_STREAM = (_BODY, "          acc[p] += lane_of(cur[u], p);")
_ROWS_JC8 = ("constexpr int K3_JC_ROWS = 4;", "constexpr int K3_JC_ROWS = 8;")
_ROWS_LANE_CLAMP = [
    ("for (int u = 0; u < K3_JC_ROWS; ++u) cur[u] = k3_clamp(nxt[u], hi);",
     "for (int u = 0; u < K3_JC_ROWS; ++u) cur[u] = nxt[u];"),
    ("for (int u = 0; u < K3_JC_ROWS; ++u) cur[u] = k3_clamp(cur[u], hi);",
     "for (int u = 0; u < K3_JC_ROWS; ++u) cur[u] = cur[u];"),
    ("const float tf = __shfl_sync(0xffffffffu, cur[u], r * GW + g);",
     "const float tf = k3_clamp(__shfl_sync(0xffffffffu, cur[u], r * GW + g),"
     " hi);")]
PATCHES = {
    "no_table": [("const float4 v = tj[k3_entry(fl)];",
                  "const float4 v = make_float4(1.0f, fl, 1.0f, 1.0f);")],
    "stream": [_STREAM],
    "stream_jc8": [_STREAM, _JC8],
    "stream_two_blocks": [_STREAM] + _TWO_BLOCKS,
    "ldg": [("return in ? __ldcs(reinterpret_cast<const float4*>(row) + q)",
             "return in ? __ldg(reinterpret_cast<const float4*>(row) + q)")],
    "jc2": [("constexpr int K3_JC = 4;", "constexpr int K3_JC = 2;")],
    "jc8": [_JC8],
    "two_blocks": _TWO_BLOCKS,
    # t >= 2 (the rows kernel), timed at t = 8
    "rows_no_table": [("const float4 v = *reinterpret_cast<const float4*>"
                       "(tj + e * TP);",
                       "const float4 v = make_float4(1.0f, (float)e, x, w);")],
    "rows_jc8": [_ROWS_JC8],
    "rows_lane_clamp": _ROWS_LANE_CLAMP,
}


def _nvcc_all(named_srcs):
    """{name: shared library} of {name: CUDA source}, one nvcc each, all
    started together."""
    from rpagp_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    out, jobs = {}, []
    for name, src in named_srcs.items():
        tag = hashlib.sha256(src.encode()).hexdigest()[:12]
        so = os.path.join(OUT, f"lib{name}_{tag}.so")
        out[name] = so
        if os.path.exists(so):
            continue
        cu = os.path.join(OUT, f"{name}_{tag}.cu")
        with open(cu, "w") as f:
            f.write(src)
        jobs.append(subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
             cu]))
    for job in jobs:
        if job.wait() != 0:
            raise RuntimeError(f"nvcc failed: {job.args}")
    return out


def _scratch_libs():
    """The variants' library and {name: library of this tree's interp.cu
    with PATCHES[name]}."""
    with open(os.path.join(ROOT, "rpagp_torch", "csrc", "interp.cu")) as f:
        base = f.read()
    srcs = {"k3_variants": VARIANTS_CU}
    for name, patch in PATCHES.items():
        src = base
        for anchor, new in patch:
            if src.count(anchor) != 1:
                raise RuntimeError(f"patch {name}: anchor not found once:\n"
                                   f"{anchor}")
            src = src.replace(anchor, new)
        srcs["k3_" + name] = src
    sos = _nvcc_all(srcs)
    var = ctypes.CDLL(sos.pop("k3_variants"))
    var.k3_variant.argtypes = [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    var.k3_variant.restype = ctypes.c_int
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        lib.rpagp_interp_apply_sum.argtypes = [_P] * 3 + [_I] * 4 + [_P]
        lib.rpagp_interp_apply_sum.restype = ctypes.c_int
        libs[name[3:]] = lib
    return var, libs


def _other_lib(path):
    """The other checkout's library and the arity of its K3 entry point."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "from rpagp_torch.ops import _build; "
            "print(json.dumps([_build.build(), "
            "len(_build._SIGNATURES['rpagp_interp_apply_sum'])]))")
    line = subprocess.run([sys.executable, "-c", code, path],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    so, arity = json.loads(line)
    lib = ctypes.CDLL(so)
    lib.rpagp_interp_apply_sum.argtypes = [_P] * 3 + [_I] * (arity - 4) + [_P]
    lib.rpagp_interp_apply_sum.restype = ctypes.c_int
    return lib, arity


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


def _rel(a, b):
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _split_tfrac(dev):
    """The synthetic HouseElectric split 0's train and test tfrac, as the
    flagship spec's prepare and posterior build them (projection seed 0)."""
    import torch

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import ski
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    spec = load_spec(os.path.join(ROOT, "specs",
                                  "rp_ski_houseelectric_j20.json")).model
    ds = datasets.load_dataset("houseelectric")
    split = next(datasets.kfold_splits(ds, k=10, seed=0, equal_train=True))
    x = torch.as_tensor(split.train_x, device=dev)
    xt = torch.as_tensor(split.test_x, device=dev)
    params, buffers = exact_gp.init_model(
        spec, x.shape[1], generator=torch.Generator().manual_seed(0),
        device=dev)
    kp, kb = params["kernel"], buffers["kernel"]
    z, zt = (ski.project(spec.kernel, kp, kb, a) for a in (x, xt))
    lo = torch.minimum(z.amin(1), zt.amin(1))
    hi = torch.maximum(z.amax(1), zt.amax(1))
    m = spec.kernel.grid_size
    train = ski.build_ski(spec.kernel, kp, kb, x, m).tfrac
    test = ski.build_ski(spec.kernel, kp, kb, xt, m, z_bounds=(lo, hi)).tfrac
    return train, test


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--variants", action="store_true",
                    help="also time the scratch variants (never on the path)")
    args = ap.parse_args()
    import torch

    from rpagp_torch.ops import _build, cuda_interp

    if not torch.cuda.is_available():
        print("torch_ab_k3: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other, arity = _other_lib(os.path.abspath(args.other))
    mine_lib = _build.lib()
    var, patched = _scratch_libs() if args.variants else (None, {})
    dev = torch.device("cuda")
    stream = _build.stream_ptr(dev)
    gen = torch.Generator().manual_seed(0)
    J, n, m = 20, 1_844_352, 256
    uniform = (1.0 + (m - 4.0) * torch.rand(J, n, generator=gen)).to(dev)
    split, test = _split_tfrac(dev)

    def k3_other(tf, G, out):
        Jn, nn = tf.shape
        t = G.shape[1]
        if arity == 8:  # one launch, any t
            err = other.rpagp_interp_apply_sum(
                tf.data_ptr(), G.data_ptr(), out.data_ptr(), Jn, nn, t, m,
                stream)
            assert err == 0, err
            return out
        for s in range(0, t, 8):  # its wrapper: launches of <= 8 columns
            tc = min(8, t - s)
            Gc = G[:, s:s + tc].contiguous()
            err = other.rpagp_interp_apply_sum(
                tf.data_ptr(), Gc.data_ptr(), out.data_ptr() + 4 * s, Jn, nn,
                tc, m, t, stream)
            assert err == 0, err
        return out

    def case(label, tfs, t, variants=False, iters=20):
        """tfs: tfrac copies taken in turn (one call each)."""
        Jn, nn = tfs[0].shape
        G = torch.randn(Jn, t, m, generator=gen).to(dev)
        out_o = torch.empty(nn, t, device=dev)
        out_v = torch.empty(nn, t, device=dev)
        turn = [0]

        def next_tf():
            turn[0] = (turn[0] + 1) % len(tfs)
            return tfs[turn[0]]

        out_t = torch.empty(nn, t, device=dev)

        def k3_this():  # the library's entry, as every kernel here
            err = mine_lib.rpagp_interp_apply_sum(
                next_tf().data_ptr(), G.data_ptr(), out_t.data_ptr(), Jn, nn,
                t, m, stream)
            assert err == 0, err

        fns = {"other": lambda: k3_other(next_tf(), G, out_o),
               "this": k3_this}
        if variants and t == 1:
            for w, name in enumerate(VARIANTS):
                def run(w=w):
                    err = var.k3_variant(w, next_tf().data_ptr(), G.data_ptr(),
                                         out_v.data_ptr(), Jn, nn, t, m, t,
                                         stream)
                    assert err == 0, err
                fns[name] = run
        if variants:
            for name, lib in patched.items():
                if name.startswith("rows_") != (t > 1):
                    continue

                def run(lib=lib):
                    err = lib.rpagp_interp_apply_sum(
                        next_tf().data_ptr(), G.data_ptr(), out_v.data_ptr(),
                        Jn, nn, t, m, stream)
                    assert err == 0, err
                fns["new_" + name] = run
        tf0 = tfs[0]
        mine = cuda_interp.interp_apply_sum_cuda(tf0, G)
        theirs = k3_other(tf0, G, out_o).clone()
        plain = cuda_interp.interp_apply_sum_plain(tf0, G)
        torch.cuda.synchronize()
        order = list(fns) + list(reversed(fns))
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(_ms(fns[k], iters))
        nbytes = 4 * (Jn * nn + nn * t + Jn * t * m)
        print(f"K3 {label} (J = {Jn}, n = {nn}, m = {m}, t = {t}) in turns, "
              f"ms: " + "; ".join(f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                                  for k, vs in times.items())
              + f"; byte bound {1e3 * nbytes / HBM_BYTES_S:.4f} ms; this vs "
              f"other rel {_rel(mine, theirs):.2e} (bit for bit "
              f"{torch.equal(mine, theirs)}), this vs plain rel "
              f"{_rel(mine, plain):.2e}", flush=True)

    case("uniform points", [uniform], 1, variants=args.variants)
    case("the split's tfrac", [split], 1, variants=args.variants)
    copies = [test.clone() for _ in range(4)]
    case("the split's test tfrac, 4 copies in turn", copies, 1,
         variants=args.variants)
    del copies
    case("uniform points", [uniform], 8, variants=args.variants, iters=10)
    case("uniform points", [uniform], 11, iters=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
