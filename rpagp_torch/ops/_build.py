"""Builds and loads the hand-written CUDA kernels (rpagp_torch/csrc/*.cu).

At first use, `nvcc` compiles every source into one shared library with a
plain C interface, under rpagp_torch/_build/, named by a hash of the
sources (a changed source builds a new library; an unchanged one is
reused). The library is loaded with ctypes: pointers and the stream go as
`c_void_p`, sizes as `c_int`, and every entry point returns
`cudaGetLastError()`, which `check` turns into an exception.

Nothing here runs at import, so every module imports without nvcc or a
card; nvcc runs only when a wrapper is first handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (all return int cudaError_t)
_SIGNATURES = {
    "rpagp_chol_linv": [_P, _P, _P, _P, _I, _I, _P],
    "rpagp_interp_transpose": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rpagp_interp_apply_sum": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None  # wall time of the nvcc run of this process, if any


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of rpagp_torch "
                           "need the CUDA toolkit to build")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librpagp_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. Output of nvcc (with -Xptxas -v register and
    shared-memory counts) goes to a .log beside the library."""
    global build_seconds
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp] + _sources()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    with open(so[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
