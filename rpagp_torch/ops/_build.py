"""Builds and loads the hand-written CUDA kernels (rpagp_torch/csrc/*.cu).

At first use, `nvcc` compiles every source into one shared library with a
plain C interface, under rpagp_torch/_build/, named by a hash of the
sources and their headers (a changed file builds a new library; an
unchanged set is reused). Each source compiles in its own `nvcc`, all started together,
and one more `nvcc` links the objects. The library is loaded with ctypes: pointers and the stream go as
`c_void_p`, sizes as `c_int`, and every entry point returns
`cudaGetLastError()` (or the error of a refused launch), which `check`
turns into an exception that names the error.

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
    "rpagp_chol_linv_coop": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rpagp_chol_linv_coop_grid": [_I, _I, _P, _P],
    "rpagp_interp_transpose": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rpagp_interp_apply_sum": [_P, _P, _P, _I, _I, _I, _I, _P],
    "rpagp_gram_mvm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _P],
    "rpagp_gram_mvm_grid": [_I, _I, _I, _P, _P],
    "rpagp_gram_mvm_bwd_grid": [_I, _I, _I, _P],
    "rpagp_gram_mvm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P],
    "rpagp_dense_gram": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rpagp_dense_gram_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _P],
}

_lib = None
_build_error = None  # a failed build, raised again without rerunning nvcc
build_seconds = None  # wall time of the nvcc run of this process, if any


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _hashed():
    """The sources and the headers they include (*.cuh)."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu*")))


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of rpagp_torch "
                           "need the CUDA toolkit to build")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for src in _hashed():
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
    nvcc = _nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in _sources():
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *arch, "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        if not failed:
            tmp = os.path.join(work, "lib.so")
            cmd = [nvcc, *arch, "-shared", "-o", tmp] + [o for _, o, _ in jobs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        build_seconds = time.perf_counter() - t0
        with open(so[:-3] + ".log", "w") as f:
            f.write("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, _build_error
    if _lib is None:
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            path = build()
        except RuntimeError as exc:
            _build_error = str(exc)
            raise
        handle = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.rpagp_cuda_error_name.argtypes = [_I]
        handle.rpagp_cuda_error_name.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        name = lib().rpagp_cuda_error_name(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
