"""rpagp_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The module imports no JAX, so it also runs on a
machine without it; there, skip tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rpagp_torch.ops import cuda_chol, cuda_interp


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _spd(b, seed, jitter=0.5):
    B = np.random.default_rng(seed).standard_normal((b, b)).astype(np.float32)
    A = B @ B.T / b + jitter * np.eye(b, dtype=np.float32)
    return (0.5 * (A + A.T)).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,b", [(1, 512), (20, 256), (3, 100)])
def test_chol_linv_matches_plain(cuda_device, B, b):
    """b=100 goes through the identity-tail pad to the kernel's 32-multiple."""
    T = torch.from_numpy(np.stack([_spd(b, seed=s) for s in range(B)]))
    T = T.to(cuda_device)
    L, Linv, ok = cuda_chol.chol_linv_cuda(T, "chol_linv_batched")
    Lp, Linvp, okp = cuda_chol.chol_linv_plain(T)
    torch.cuda.synchronize()
    assert torch.equal(ok, okp) and bool((ok == 1).all())
    assert _rel(L, Lp) <= 1e-5
    assert _rel(Linv, Linvp) <= 1e-5
    assert float(torch.max(torch.abs(torch.triu(L, 1)))) == 0.0


@pytest.mark.cuda
def test_chol_linv_indefinite_block(cuda_device):
    T = torch.from_numpy(np.stack([_spd(64, seed=s) for s in range(4)]))
    T[1] -= 10.0 * torch.eye(64)
    L, Linv, ok = cuda_chol.chol_linv_cuda(T.to(cuda_device),
                                           "chol_linv_batched")
    assert ok.tolist() == [1.0, 0.0, 1.0, 1.0]
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 11])
def test_interp_matches_plain(cuda_device, t):
    """Interior and edge points, -100 padding, t chunked by 8."""
    J, n, m = 4, 40000, 256
    rng = np.random.default_rng(t)
    tf = rng.uniform(1.0, m - 3.0, (J, n)).astype(np.float32)
    tf[:, :6] = [-2.5, -1.5, -0.25, 0.0, m - 1.0, m + 0.5]
    tf[:, 6:9] = -100.0
    tf = torch.from_numpy(tf).to(cuda_device)
    V = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((J, t, m)).astype(np.float32))
    V, G = V.to(cuda_device), G.to(cuda_device)
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    O = cuda_interp.interp_apply_sum_cuda(tf, G)
    assert _rel(U, cuda_interp.interp_transpose_plain(tf, V, m)) <= 1e-5
    assert _rel(O, cuda_interp.interp_apply_sum_plain(tf, G)) <= 1e-5
    assert bool((O[6:9] == 0).all())
