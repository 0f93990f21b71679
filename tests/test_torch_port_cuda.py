"""rpagp_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The module imports no JAX, so it also runs on a
machine without it; there, skip tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from rpagp_torch.ops import cuda_chol, cuda_gram, cuda_interp
from rpagp_torch.ops.kernels import KernelSpec


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


def _coop_and_one_block(T, name="chol_linv_batched"):
    """The cooperative kernel (through entry point `name`) and the
    one-block kernel on the same (B, b, b) batch."""
    T = T.contiguous()
    before = dict(cuda_chol.launches)
    coop = cuda_chol.chol_linv_cuda(T, name)
    one = cuda_chol.chol_linv_cuda(T, cuda_chol.ONE_BLOCK)
    torch.cuda.synchronize()
    assert cuda_chol.launches[name] == before[name] + 1  # the oracle: uncounted
    assert sum(cuda_chol.launches.values()) == sum(before.values()) + 1
    return coop, one


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _leaf(A):
    """The cooperative kernel through the leaf's entry point on one (b, b)
    matrix, and the one-block kernel on the same input."""
    return _coop_and_one_block(A[None], "chol_linv")


@pytest.mark.cuda
@pytest.mark.parametrize("B,b", [(20, 256), (3, 100), (65, 64), (200, 64)])
def test_chol_linv_batch_equals_one_block_kernel(cuda_device, B, b):
    """The cooperative kernel on a batch against the one-block kernel, bit
    for bit on every matrix: the ladder's (20, 256, 256); b = 100 through
    the identity-tail pad to 128; J = 65 at b = 64 (65 chain blocks); and
    200 matrices, more than half the blocks the card holds, so that a
    chain block carries several matrices in turn. A repeat is bit for bit
    the same."""
    T = torch.from_numpy(np.stack([_spd(b, seed=B + s) for s in range(B)]))
    T = T.to(cuda_device)
    (L, Linv, ok), one = _coop_and_one_block(T)
    assert bool((ok == 1).all())
    assert _bit_equal((L, Linv, ok), one)
    assert _bit_equal((L, Linv, ok),
                      cuda_chol.chol_linv_cuda(T, "chol_linv_batched"))
    G, C = cuda_chol.coop_grid(B, -(-b // 32) * 32, cuda_device)
    assert 1 <= C <= min(B, G)


@pytest.mark.cuda
def test_chol_linv_batch_on_the_ladder_blocks(cuda_device):
    """The flagship's (20, 256, 256) RBF Toeplitz blocks at the initial
    lengthscale (a grid built from 32,768 random 11-d points), at every
    jitter level of grid_solve's ladder: the cooperative kernel equals the
    one-block kernel bit for bit, ok flags included, even where the base
    levels fail some blocks."""
    import os

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import grid_solve, ski
    from rpagp_torch.utils.config import load_spec

    spec = load_spec(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "specs",
        "rp_ski_houseelectric_j20.json")).model
    gen = torch.Generator().manual_seed(1)
    params, buffers = exact_gp.init_model(spec, 11, generator=gen,
                                          device=cuda_device)
    x = torch.randn(32768, 11, generator=gen).to(cuda_device)
    state = ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"], x,
                          spec.kernel.grid_size)
    T = grid_solve._toeplitz_blocks(spec.kernel, params["kernel"], state)
    eps0 = spec.grid_jitter * T[:, 0, 0]
    eye = torch.eye(T.shape[-1], device=cuda_device)
    assert T.shape == (20, 256, 256)
    for mult in grid_solve._LADDER:
        coop, one = _coop_and_one_block(T + (mult * eps0)[:, None, None] * eye)
        assert _bit_equal(coop, one), f"jitter x{mult}"


def _sml_ski_ladder_blocks(device):
    """The (20, 512, 512) Toeplitz blocks that the exact grid solver's
    ladder factors for rp_poly_j20_ski (J = 20 degree-1 RBF, m = 512) on
    synthetic sml split 0 at the initial params (projection seed 0), at
    the base jitter, where every block fails a pivot."""
    import dataclasses
    import os

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import grid_solve, ski
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = load_spec(os.path.join(root, "specs", "rp_poly_j20_ski.json")).model
    spec = dataclasses.replace(spec, solver="grid")
    split = next(datasets.kfold_splits(datasets.load_dataset("sml"), k=10,
                                       seed=0, equal_train=True))
    x = torch.as_tensor(split.train_x, device=device)
    params, buffers = exact_gp.init_model(
        spec, x.shape[1], generator=torch.Generator().manual_seed(0),
        device=device)
    state = ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"], x,
                          spec.kernel.grid_size)
    T = grid_solve._toeplitz_blocks(spec.kernel, params["kernel"], state)
    eye = torch.eye(T.shape[-1], device=device)
    return (T + (spec.grid_jitter * T[:, 0, 0])[:, None, None] * eye)


@pytest.mark.cuda
def test_chol_linv_batch_failing_blocks_stay_finite(cuda_device):
    """The sml SKI model's (20, 512, 512) ladder blocks at the base jitter:
    every block fails (ok = 0, as cuSOLVER's cholesky_ex says), and both
    kernels keep every output finite (a failed pivot's column is decoupled
    from the panel rows too), bit for bit alike; L Linv = I to the
    backward-error bar b * eps."""
    T = _sml_ski_ladder_blocks(cuda_device).contiguous()
    assert T.shape == (20, 512, 512)
    (L, Linv, ok), one = _coop_and_one_block(T)
    okp = cuda_chol.chol_linv_plain(T)[2]
    assert ok.tolist() == [0.0] * 20 and torch.equal(ok, okp)
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())
    assert _bit_equal((L, Linv, ok), one)
    Ld, Linvd = L.double(), Linv.double()
    eye = torch.eye(512, dtype=torch.float64, device=cuda_device)
    res = torch.linalg.norm(Ld @ Linvd - eye, dim=(1, 2))
    scale = torch.linalg.norm(Ld, dim=(1, 2)) * torch.linalg.norm(
        Linvd, dim=(1, 2))
    assert float(torch.max(res / scale)) <= 512 * 2.0**-24


@pytest.mark.cuda
def test_chol_linv_leaf_failing_block_stays_finite(cuda_device):
    """One of those blocks through the leaf's entry point: finite, ok = 0,
    bit for bit the one-block kernel's and the batch launch's."""
    T = _sml_ski_ladder_blocks(cuda_device)[7:8].contiguous()
    (L, Linv, ok), one = _leaf(T[0])
    assert ok.tolist() == [0.0]
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())
    assert _bit_equal((L, Linv, ok), one)
    assert _bit_equal((L, Linv, ok),
                      cuda_chol.chol_linv_cuda(T, "chol_linv_batched"))


@pytest.mark.cuda
def test_chol_linv_batch_indefinite_block_leaves_the_others(cuda_device):
    """Block 3 of the ladder-shaped batch indefinite: ok = 0 for it alone,
    every output finite, the other 19 matrices bit for bit what they are
    in the SPD batch, and all 20 bit for bit the one-block kernel's."""
    T = torch.from_numpy(np.stack([_spd(256, seed=s) for s in range(20)]))
    T = T.to(cuda_device)
    Tb = T.clone()
    Tb[3] -= 10.0 * torch.eye(256, device=cuda_device)
    (L0, Linv0, _), _ = _coop_and_one_block(T)
    (L, Linv, ok), one = _coop_and_one_block(Tb)
    keep = torch.arange(20, device=cuda_device) != 3
    assert float(ok[3]) == 0.0 and bool((ok[keep] == 1).all())
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())
    assert torch.equal(L[keep], L0[keep]) and torch.equal(Linv[keep],
                                                          Linv0[keep])
    assert _bit_equal((L, Linv, ok), one)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [512, 256, 100, 32])
def test_chol_linv_leaf_matches_plain(cuda_device, b):
    """The cooperative kernel on one matrix against cuSOLVER; b=100 goes
    through the identity-tail pad to 128, b=32 is one panel (one block)."""
    A = torch.from_numpy(_spd(b, seed=b)).to(cuda_device)
    before = cuda_chol.launches["chol_linv"]
    L, Linv, ok = cuda_chol.chol_linv_cuda(A[None].contiguous(), "chol_linv")
    assert cuda_chol.launches["chol_linv"] == before + 1
    Lp, Linvp, okp = cuda_chol.chol_linv_plain(A[None])
    torch.cuda.synchronize()
    assert torch.equal(ok, okp) and bool((ok == 1).all())
    assert _rel(L, Lp) <= 1e-5
    assert _rel(Linv, Linvp) <= 1e-5
    assert float(torch.max(torch.abs(torch.triu(L, 1)))) == 0.0
    assert cuda_chol.coop_grid(1, -(-b // 32) * 32, cuda_device)[1] == 1


@pytest.mark.cuda
def test_chol_linv_leaf_equals_one_block_kernel(cuda_device):
    """The cooperative kernel through the leaf's entry point and the
    one-block kernel run the same per-element arithmetic in the same
    order: at (1, 512, 512) they agree bit for bit, and a second launch
    repeats the first bit for bit."""
    A = torch.from_numpy(_spd(512, seed=3)).to(cuda_device)
    (L, Linv, ok), (L1, Linv1, ok1) = _leaf(A)
    assert torch.equal(L, L1) and torch.equal(Linv, Linv1)
    assert torch.equal(ok, ok1)
    L2, Linv2, ok2 = cuda_chol.chol_linv_cuda(A[None].contiguous(),
                                              "chol_linv")
    assert torch.equal(L, L2) and torch.equal(Linv, Linv2)
    assert torch.equal(ok, ok2)


@pytest.mark.cuda
@pytest.mark.parametrize("panel", [0, 7, 15])
def test_chol_linv_leaf_indefinite(cuda_device, panel):
    """A pivot fails in the given 32-wide panel of a 512 matrix: ok = 0,
    every output finite, and the one-block kernel's outputs bit for bit
    (through the leaf's entry point)."""
    A = _spd(512, seed=panel)
    s = 32 * panel + 5
    A[s:, s:] -= 10.0 * np.eye(512 - s, dtype=np.float32)
    (L, Linv, ok), (L1, Linv1, ok1) = _leaf(torch.from_numpy(A).to(
        cuda_device))
    assert ok.tolist() == [0.0] and ok1.tolist() == [0.0]
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())
    assert torch.equal(L, L1) and torch.equal(Linv, Linv1)


@pytest.mark.cuda
def test_chol_linv_leaf_gradient_matches_cpu(cuda_device):
    """The closed-form VJP through cuda_chol.chol_linv: the cooperative
    kernel on the card against cuSOLVER's replacement, LAPACK, on the
    CPU."""
    A0 = torch.from_numpy(_spd(512, seed=4))
    rng = np.random.default_rng(5)
    R1, R2 = (torch.from_numpy(rng.standard_normal((512, 512)).astype(
        np.float32)) for _ in range(2))
    grads = []
    for d in (cuda_device, "cpu"):
        Ad = A0.to(d).requires_grad_(True)
        L, Linv, _ = cuda_chol.chol_linv(0.5 * (Ad + Ad.mT))
        (torch.sum(L * R1.to(d)) + torch.sum(Linv * R2.to(d))).backward()
        grads.append(Ad.grad)
    assert _rel(grads[0], grads[1]) <= 1e-4


@pytest.mark.cuda
def test_chol_linv_leaf_refused_launch_raises(cuda_device):
    """More blocks than the card holds at once: the cooperative launch is
    refused, and the wrapper's check names the CUDA error."""
    from rpagp_torch.ops import _build

    A = torch.eye(64, device=cuda_device)
    L, Linv, ok = (torch.empty_like(A) for _ in range(3))
    fail = torch.empty(2, dtype=torch.int32, device=cuda_device)
    err = _build.lib().rpagp_chol_linv_coop(
        A.data_ptr(), L.data_ptr(), Linv.data_ptr(), ok.data_ptr(),
        fail.data_ptr(), 1, 64, 1 << 20, 1, _build.stream_ptr(A.device))
    with pytest.raises(RuntimeError,
                       match="cudaErrorCooperativeLaunchTooLarge"):
        _build.check(err, "chol_linv kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 11])
def test_interp_matches_plain(cuda_device, t):
    """Interior and edge points, -100 padding; one K2 launch at any t."""
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


def _gram_case(n, m, t, J, seed, dev):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((n, J)).astype(np.float32)
    z2 = rng.standard_normal((m, J)).astype(np.float32)
    z2[:5] = z1[:5]  # coincident points: d = 0
    w = (0.2 + rng.random(J)).astype(np.float32)
    V = rng.standard_normal((m, t)).astype(np.float32)
    G = rng.standard_normal((n, t)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (z1, z2, w, V, G)]


@pytest.mark.cuda
@pytest.mark.parametrize("base", cuda_gram.BASES)
@pytest.mark.parametrize("t", [1, 11, 40, 256])
def test_gram_mvm_matches_plain(cuda_device, base, t):
    """K4 and K5 against their plain versions on the card; ragged n, m
    (not multiples of the 64-row tiles); t = 1 and 11 on K4's narrow form,
    40 and 256 on its wide form (one 64- and one 256-column slab); each
    call repeats bit for bit."""
    z1, z2, w, V, G = _gram_case(1000, 777, t, 10, seed=t, dev=cuda_device)
    out = cuda_gram.gram_mvm_cuda(z1, z2, w, V, base)
    dz, dw = cuda_gram.gram_mvm_bwd_cuda(z1, z2, w, V, G, base)
    torch.cuda.synchronize()
    assert _rel(out, cuda_gram.gram_mvm_plain(z1, z2, w, V, base)) <= 1e-5
    dzp, dwp = cuda_gram.gram_mvm_bwd_plain(z1, z2, w, V, G, base)
    assert _rel(dz, dzp) <= 1e-4 and _rel(dw, dwp) <= 1e-4
    assert torch.equal(out, cuda_gram.gram_mvm_cuda(z1, z2, w, V, base))
    dz2, dw2 = cuda_gram.gram_mvm_bwd_cuda(z1, z2, w, V, G, base)
    assert torch.equal(dz, dz2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("same", [False, True], ids=["cross", "self"])
def test_gram_mvm_gradients_match_cpu(cuda_device, same):
    """dz1, dz2, dw, dV through the autograd.Function: K4/K5 on the card
    (float32) against the plain versions on the CPU in float64. The loss
    sum(sin(out)), with |out| up to ~42, carries the forward's rounding
    into the gradient twenty-fold: a float32 CPU oracle sits 5-8e-6 from
    the exact gradient and moves with its own rounding, so the oracle is
    computed in float64 and the card's gradients are held to it."""
    z1, z2, w, V, _ = _gram_case(300, 300 if same else 250, 3, 7, seed=1,
                                 dev="cpu")
    grads = []
    for d, dt in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        ts = [a.to(d, dt).requires_grad_(True) for a in (z1, z2, w, V)]
        zb = ts[0] if same else ts[1]
        torch.sum(torch.sin(cuda_gram.projected_gram_mvm(
            ts[0], zb, ts[2], ts[3], "matern32"))).backward()
        grads.append([a.grad for a in ts if a.grad is not None])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


@pytest.mark.cuda
def test_mvm_launches_kernels_past_one_launchs_components(cuda_device):
    """J = 65 > J_MAX: kernels.mvm on the card still goes through K4 and
    K5 (one launch per group of components, never the blocked path), and
    value and gradients agree with the blocked path on the CPU."""
    from rpagp_torch.ops import kernels
    from rpagp_torch.ops.kernels import KernelSpec, init_kernel_params

    spec = KernelSpec.polynomial(J=65, d=1)
    assert cuda_gram.supports(spec)
    gen = torch.Generator().manual_seed(0)
    kp, kb = init_kernel_params(spec, 5, generator=gen, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((300, 5)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((300, 3)).astype(np.float32))
    res = []
    for d in (cuda_device, "cpu"):
        p = {k: v.to(d).requires_grad_(True) for k, v in kp.items()}
        b = {k: v.to(d) for k, v in kb.items()}
        xd = x.to(d)
        before = dict(cuda_gram.launches)
        out = kernels.mvm(spec, p, b, xd, xd, V.to(d), allow_pallas=True)
        torch.sum(torch.sin(out)).backward()
        if d != "cpu":
            assert cuda_gram.launches["gram_mvm"] - before["gram_mvm"] == 2
            assert (cuda_gram.launches["gram_mvm_bwd"]
                    - before["gram_mvm_bwd"]) == 4
        res.append([out.detach()] + [p[k].grad for k in sorted(p)])
    for a, c in zip(*res):
        assert _rel(a, c) <= 1e-4


@pytest.mark.cuda
def test_gram_mvm_rejects_bad_inputs(cuda_device):
    z1, z2, w, V, _ = _gram_case(64, 64, 2, 4, seed=2, dev=cuda_device)
    with pytest.raises(ValueError):
        cuda_gram.gram_mvm_cuda(z1, z2, w, V.t())  # not contiguous
    with pytest.raises(ValueError):
        cuda_gram.gram_mvm_cuda(z1, z2[:, :3].contiguous(), w, V)
    with pytest.raises(TypeError):
        cuda_gram.gram_mvm_cuda(z1, z2, w, V.double())


def _bwd_case(n, m, t, J, seed, dev):
    """K5's inputs, with coincident points (d = 0) and float64 copies for
    the plain version."""
    z1, z2, w, V, G = _gram_case(n, m, t, J, seed, "cpu")
    return ([a.to(dev) for a in (z1, z2, w, V, G)],
            [a.to(dev, torch.float64) for a in (z1, z2, w, V, G)])


@pytest.mark.cuda
@pytest.mark.parametrize("base", cuda_gram.BASES)
@pytest.mark.parametrize("t", [1, 3, 11, 16, 17, 40])
@pytest.mark.parametrize("J", [1, 10, 64, 65])
def test_gram_mvm_bwd_matches_plain(cuda_device, base, t, J):
    """K5 against its plain version (float64) on ragged n, m: one column
    pass at t <= 16, passes of 16 beyond; J = 65 in two launches. dz and
    dw rel <= 1e-5, and a repeat is bit for bit the same."""
    args, args64 = _bwd_case(700, 900, t, J, seed=J * 100 + t,
                             dev=cuda_device)
    before = cuda_gram.launches["gram_mvm_bwd"]
    dz, dw = cuda_gram.gram_mvm_bwd_cuda(*args, base)
    assert cuda_gram.launches["gram_mvm_bwd"] - before == -(-J // 64)
    dzp, dwp = cuda_gram.gram_mvm_bwd_plain(*args64, base)
    torch.cuda.synchronize()
    assert _rel(dz, dzp) <= 1e-5 and _rel(dw, dwp) <= 1e-5
    dz2, dw2 = cuda_gram.gram_mvm_bwd_cuda(*args, base)
    assert torch.equal(dz, dz2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_gram_mvm_bwd_training_shape_repeats(cuda_device):
    """The BBMM training shape (14,939 rows and columns, J = 10, t = 11,
    several z2 chunks): rel <= 1e-5 against the plain version (float64),
    and 20 repeats bit for bit the same."""
    args, args64 = _bwd_case(14939, 14939, 11, 10, seed=7, dev=cuda_device)
    Gb, S = cuda_gram.gram_mvm_bwd_plan(14939, 14939, 10, 11, "rbf",
                                        cuda_device)
    assert Gb >= 132 and 1 <= S <= cuda_gram.MAX_CHUNKS
    dz, dw = cuda_gram.gram_mvm_bwd_cuda(*args, "rbf")
    dzp, dwp = cuda_gram.gram_mvm_bwd_plain(*args64, "rbf")
    assert _rel(dz, dzp) <= 1e-5 and _rel(dw, dwp) <= 1e-5
    for _ in range(20):
        dz2, dw2 = cuda_gram.gram_mvm_bwd_cuda(*args, "rbf")
        assert torch.equal(dz, dz2) and torch.equal(dw, dw2)


def _dense_case(J, n, m, seed, dev, same=False):
    """K6 / K7's inputs: coordinates as the projection gives them, (J, n)
    and (J, m), with coincident points (d = 0); weights; a cotangent G (n,
    m) that is not symmetric; and float64 copies for the twins."""
    rng = np.random.default_rng(seed)
    u1 = (1.5 * rng.standard_normal((J, n))).astype(np.float32)
    u2 = u1 if same else (1.5 * rng.standard_normal((J, m))).astype(np.float32)
    if not same and min(n, m) > 1:
        k = min(5, n, m)
        u2[:, :k] = u1[:, :k]
    w = (0.2 + rng.random(J)).astype(np.float32)
    G = rng.standard_normal((n, m)).astype(np.float32)
    ts = [torch.from_numpy(a).to(dev) for a in (u1, u2, w, G)]
    if same:
        ts[1] = ts[0]
    t64 = [a.double() for a in ts]
    if same:
        t64[1] = t64[0]
    return ts, t64


# (J, n, m, same): the exact cell's K(x, x); its predictor's cross Gram;
# pivoted Cholesky's one-row Gram and a few rows (mostly padding); ragged
# tiles; J above K7's 32 components a launch and K6's 64
DENSE_SHAPES = [(20, 3723, 3723, True), (20, 414, 3723, False),
                (20, 1, 3723, False), (7, 5, 700, False), (20, 9, 130, False),
                (10, 100, 77, False), (3, 1, 1, False), (10, 65, 65, True),
                (33, 200, 150, False), (65, 130, 130, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("base", cuda_gram.BASES)
@pytest.mark.parametrize("J,n,m,same", DENSE_SHAPES)
def test_dense_gram_matches_twin(cuda_device, base, J, n, m, same):
    """K6 and K7 against their plain twins in float64: K rel <= 1e-5, du1,
    du2, dw rel <= 1e-5; one K6 launch a group of 64 components, one K7
    launch a group of 32; K(x, x) exactly symmetric."""
    (u1, u2, w, G), (a1, a2, aw, aG) = _dense_case(J, n, m, seed=J + n,
                                                   dev=cuda_device, same=same)
    before = dict(cuda_gram.launches)
    K = cuda_gram.dense_gram_cuda(u1, u2, w, base)
    du1, du2, dw = cuda_gram.dense_gram_bwd_cuda(u1, u2, w, G, base)
    torch.cuda.synchronize()
    assert cuda_gram.launches["dense_gram"] - before["dense_gram"] == -(-J // 64)
    assert (cuda_gram.launches["dense_gram_bwd"]
            - before["dense_gram_bwd"]) == -(-J // 32)
    assert _rel(K, cuda_gram.dense_gram_plain(a1, a2, aw, base)) <= 1e-5
    p1, p2, pw = cuda_gram.dense_gram_bwd_plain(a1, a2, aw, aG, base)
    if same:
        assert du2 is None and torch.equal(K, K.T)
        p1 = p1 + p2
    else:
        assert _rel(du2, p2) <= 1e-5
    assert _rel(du1, p1) <= 1e-5 and _rel(dw, pw) <= 1e-5


@pytest.mark.cuda
def test_dense_gram_bwd_repeats_bit_for_bit(cuda_device):
    """The exact cell's shape: two K7 calls (and two K6 calls) give the
    same bits."""
    (u1, u2, w, G), _ = _dense_case(20, 3723, 3723, seed=3, dev=cuda_device,
                                    same=True)
    K = cuda_gram.dense_gram_cuda(u1, u2, w, "rbf")
    assert torch.equal(K, cuda_gram.dense_gram_cuda(u1, u2, w, "rbf"))
    du, _, dw = cuda_gram.dense_gram_bwd_cuda(u1, u2, w, G, "rbf")
    du2, _, dw2 = cuda_gram.dense_gram_bwd_cuda(u1, u2, w, G, "rbf")
    assert torch.equal(du, du2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_dense_gram_rejects_bad_inputs(cuda_device):
    (u1, u2, w, G), _ = _dense_case(4, 70, 50, seed=1, dev=cuda_device)
    with pytest.raises(ValueError):
        cuda_gram.dense_gram_cuda(u1.t(), u2, w)  # not contiguous
    with pytest.raises(ValueError):
        cuda_gram.dense_gram_cuda(u1, u2[:3].contiguous(), w)
    with pytest.raises(TypeError):
        cuda_gram.dense_gram_cuda(u1, u2.double(), w)
    with pytest.raises(ValueError):
        cuda_gram.dense_gram_bwd_cuda(u1, u2, w, G.t().contiguous())


@pytest.mark.cuda
def test_exact_mll_through_k6_k7_at_the_cell_size(cuda_device):
    """exact_gp.exact_mll of J = 20 degree-1 RBF projections at n = 3,723,
    D = 26 (the exact cell's step): one K6 and one K7 launch, the device
    peak of the value and gradient under 1.5 GiB above what was allocated
    before, and value rel <= 1e-5, gradient relerr <= 1e-4 against the
    same MLL in float64 on the CPU (the float64 Gram takes the (J, n, m)
    path)."""
    from rpagp_torch.models import exact_gp
    from rpagp_torch.models.exact_gp import ModelSpec

    spec = ModelSpec(kernel=KernelSpec.polynomial(J=20))
    rng = np.random.default_rng(11)
    n, D = 3723, 26
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.sin(x @ rng.standard_normal(D) / 3.0)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    p0, b0 = exact_gp.init_model(spec, D,
                                 generator=torch.Generator().manual_seed(3),
                                 device="cpu")
    out = {}
    for d, dtype in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        def to(tree):
            return {k: to(v) if isinstance(v, dict)
                    else v.to(d, dtype, copy=True) for k, v in tree.items()}

        p, b = to(p0), to(b0)
        leaves = [p["raw_noise"], p["mean_const"], *p["kernel"].values()]
        for t in leaves:
            t.requires_grad_(True)
        xd = torch.from_numpy(x).to(d, dtype)
        yd = torch.from_numpy(y).to(d, dtype)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = dict(cuda_gram.launches)
        v = exact_gp.exact_mll(spec, p, b, xd, yd)
        v.backward()
        torch.cuda.synchronize()
        if dtype == torch.float32:
            peak = torch.cuda.max_memory_allocated() - base
            print(f"exact_mll n = {n}: peak {peak / 2 ** 30:.4f} GiB")
            assert peak < 1.5 * 2 ** 30
            assert {k: cuda_gram.launches[k] - before[k]
                    for k in ("dense_gram", "dense_gram_bwd")} == {
                        "dense_gram": 1, "dense_gram_bwd": 1}
        out[dtype] = (float(v.detach()),
                      [t.grad.double().cpu() for t in leaves])
    (vg, gg), (vc, gc) = out[torch.float32], out[torch.float64]
    assert abs(vg - vc) <= 1e-5 * abs(vc)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(gg, gc))
    den = sum(float((b ** 2).sum()) for b in gc)
    assert math.sqrt(num / den) <= 1e-4


@pytest.mark.cuda
def test_ski_spec_gram_takes_no_dense_kernel(cuda_device):
    """A SKI spec's Gram (the SKI + BBMM preconditioner's pivot rows)
    stays on the plain path: the dispatch keeps SKI specs off K6 / K7
    (though dense_supports() takes the kernel), and neither launches."""
    from rpagp_torch.ops import kernels

    spec = KernelSpec.polynomial(J=20, ski=True, grid_size=256)
    assert cuda_gram.dense_supports(spec) and not cuda_gram.supports(spec)
    kp, kb = kernels.init_kernel_params(
        spec, 11, generator=torch.Generator().manual_seed(0),
        device=cuda_device)
    kp["raw_lengthscale"].requires_grad_(True)
    x = torch.randn(500, 11, device=cuda_device)
    before = dict(cuda_gram.launches)
    kernels.gram(spec, kp, kb, x[:1], x).sum().backward()
    kernels.gram(spec, kp, kb, x, x).sum().backward()
    torch.cuda.synchronize()
    assert cuda_gram.launches == before


def _interp_case(J, n, m, t, kind, seed, dev):
    rng = np.random.default_rng(seed)
    if kind == "crowded":  # every point in three cells near the middle
        tf = rng.choice([m / 2 - 0.7, m / 2 + 0.2, m / 2 + 1.45], (J, n))
        tf = tf + 0.01 * rng.random((J, n))
    elif kind == "gaussian":  # the flagship's: Gaussian projections over
        z = rng.standard_normal((J, n))  # their range, 2 cells each side
        lo, hi = z.min(1, keepdims=True), z.max(1, keepdims=True)
        tf = 2.0 + (z - lo) / (hi - lo) * (m - 5.0)
    else:
        tf = rng.uniform(-2.0, m + 1.0, (J, n))
    tf = tf.astype(np.float32)
    tf[:, :8] = [-2.5, -1.5, -0.25, 0.0, m - 2.0, m - 1.0, m - 0.5, m + 0.5]
    tf[:, -500:] = -100.0  # padding
    V = rng.standard_normal((n, t)).astype(np.float32)
    G = rng.standard_normal((J, t, m)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (tf, V, G)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "crowded"])
@pytest.mark.parametrize("t", [1, 2, 3, 8, 9, 11, 16, 31, 32, 33, 512, 513])
@pytest.mark.parametrize("m", [17, 256, 512, 1000, cuda_interp.M_MAX])
def test_interp_transpose_matches_plain(cuda_device, kind, t, m):
    """K2 against its plain version (float64): uniform points and points
    crowded into three cells, the grid's edges, -100 padding; every slot
    layout (t = 1: a slot a lane; 2-31: slots of t column lanes, idle
    lanes at t = 3, 9, 11, 31; 32: one slot; 33, 513: a one-column tile
    after the 32-column ones), one launch at any t; rel <= 1e-5, padding
    contributes exactly zero, a repeat is bit for bit the same, and K2 and
    K3 are adjoints to 1e-5."""
    tf, V, G = _interp_case(5, 60000, m, t, kind, seed=m + t, dev=cuda_device)
    before = cuda_interp.launches["interp_transpose"]
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    assert cuda_interp.launches["interp_transpose"] - before == 1
    Up = cuda_interp.interp_transpose_plain(tf.double(), V.double(), m)
    torch.cuda.synchronize()
    assert _rel(U, Up) <= 1e-5
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V, m), U)
    V2 = V.clone()
    V2[-500:] = 1e6
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V2, m), U)
    O = cuda_interp.interp_apply_sum_cuda(tf, G)
    lhs = float(torch.sum(U.double() * G.double()))
    rhs = float(torch.sum(V.double() * O.double()))
    assert abs(lhs - rhs) <= 1e-5 * float(torch.linalg.norm(U.double())
                                          * torch.linalg.norm(G.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 11])
def test_interp_transpose_small_n_spreads(cuda_device, t):
    """sml's shape (J = 20, n = 3,723, m = 512): the wrapper's chunk spreads
    K2 over at least one block an SM of the H100 (132), with several
    chunks a component; rel <= 1e-5 against float64, a repeat bit for
    bit, padding exactly zero, and the K2/K3 adjoint to 1e-5."""
    J, n, m = 20, 3723, 512
    chunk = cuda_interp.transpose_chunk(J, n, t, m)
    assert J * -(-t // cuda_interp.K2_TILE) * -(-n // chunk) >= 132
    tf, V, G = _interp_case(J, n, m, t, "uniform", seed=t, dev=cuda_device)
    before = cuda_interp.launches["interp_transpose"]
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    assert cuda_interp.launches["interp_transpose"] - before == 1
    Up = cuda_interp.interp_transpose_plain(tf.double(), V.double(), m)
    torch.cuda.synchronize()
    assert _rel(U, Up) <= 1e-5
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V, m), U)
    V2 = V.clone()
    V2[-500:] = 1e6
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V2, m), U)
    O = cuda_interp.interp_apply_sum_cuda(tf, G)
    lhs = float(torch.sum(U.double() * G.double()))
    rhs = float(torch.sum(V.double() * O.double()))
    assert abs(lhs - rhs) <= 1e-5 * float(torch.linalg.norm(U.double())
                                          * torch.linalg.norm(G.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "gaussian"])
@pytest.mark.parametrize("t", [3, 9, 11, 33, 512])
def test_interp_transpose_routes(cuda_device, kind, t):
    """K2 on 20 components of 20,000 points (m = 256), where the runs
    route's blocks fill the card: uniform and flagship-like Gaussian
    tfrac, the grid's edges and padding; against the plain version in
    float64 (rel <= 1e-5), padding exactly zero, two launches equal bit for
    bit, and the route counter: runs at t = 3, 9, 11, slots (and own for
    the rest of one column) at t = 33 and 512."""
    J, n, m = 20, 20000, 256
    tf, V, _ = _interp_case(J, n, m, t, kind, seed=t, dev=cuda_device)
    before = dict(cuda_interp.launches)
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    moved = {k for k in before if cuda_interp.launches[k] != before[k]}
    want = ({"runs"} if t <= 16 else {"slots", "own"} if t == 33
            else {"slots"})
    assert moved == {"interp_transpose"} | {f"interp_transpose.{r}"
                                            for r in want}
    Up = cuda_interp.interp_transpose_plain(tf.double(), V.double(), m)
    torch.cuda.synchronize()
    assert _rel(U, Up) <= 1e-5
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V, m), U)
    V2 = V.clone()
    V2[-500:] = 1e6
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V2, m), U)


@pytest.mark.cuda
def test_interp_transpose_route_counts(cuda_device):
    """At the flagship's shape the route counter shows own at t = 1 and 2
    and runs at t = 9, once a call; a t = 2 call equals two t = 1 calls
    bit for bit."""
    J, n, m = 20, 1_844_352, 256
    tf, V, _ = _interp_case(J, n, m, 9, "gaussian", seed=5, dev=cuda_device)
    for t, route in ((1, "own"), (2, "own"), (9, "runs")):
        before = dict(cuda_interp.launches)
        U = cuda_interp.interp_transpose_cuda(tf, V[:, :t].contiguous(), m)
        assert cuda_interp.launches[f"interp_transpose.{route}"] \
            - before[f"interp_transpose.{route}"] == 1
        assert sum(cuda_interp.launches[k] - before[k] for k in before
                   if k.startswith("interp_transpose.")) == 1
        if t == 2:
            for k in range(2):
                one = cuda_interp.interp_transpose_cuda(
                    tf, V[:, k:k + 1].contiguous(), m)
                assert torch.equal(U[:, k:k + 1], one)


@pytest.mark.cuda
def test_interp_transpose_takes_a_strided_v(cuda_device):
    """V handed over as a transposed view or a column slice (as autograd
    may): the same bits as V made contiguous first, one launch."""
    tf, V, _ = _interp_case(5, 30000, 256, 9, "uniform", seed=1,
                            dev=cuda_device)
    want = cuda_interp.interp_transpose_cuda(tf, V, 256)
    wide = torch.cat([V, V], dim=1)
    for view in (V.t().contiguous().t(), wide[:, :9]):
        assert not view.is_contiguous()
        before = cuda_interp.launches["interp_transpose"]
        assert torch.equal(cuda_interp.interp_transpose_cuda(tf, view, 256),
                           want)
        assert cuda_interp.launches["interp_transpose"] - before == 1


@pytest.mark.cuda
def test_interp_transpose_rejects_m_past_limit(cuda_device):
    tf, V, _ = _interp_case(2, 1000, cuda_interp.M_MAX + 1, 3, "uniform",
                            seed=0, dev=cuda_device)
    before = cuda_interp.launches["interp_transpose"]
    with pytest.raises(ValueError, match="m <="):
        cuda_interp.interp_transpose_cuda(tf, V, cuda_interp.M_MAX + 1)
    assert cuda_interp.launches["interp_transpose"] == before
    # the C entry refuses it too, and the wrapper's check raises on that
    from rpagp_torch.ops import _build

    U = torch.empty(2, 3, cuda_interp.M_MAX + 1, device=cuda_device)
    err = _build.lib().rpagp_interp_transpose(
        tf.data_ptr(), V.data_ptr(), U.data_ptr(), U.data_ptr(), 2, 1000, 3,
        cuda_interp.M_MAX + 1, 32, _build.stream_ptr(cuda_device))
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        _build.check(err, "interp_transpose kernel")


@pytest.mark.cuda
def test_build_interp_y_is_one_launch(cuda_device):
    """Grid prepare's U^T y and U^T 1 come from one K2 launch at t = 2,
    bit for bit what two launches at t = 1 give."""
    from rpagp_torch.ops import grid_solve, ski
    from rpagp_torch.ops.kernels import KernelSpec

    tf, V, _ = _interp_case(20, 50000, 256, 1, "uniform", seed=3,
                            dev=cuda_device)
    y = V[:, 0].contiguous()
    state = ski.SKIState(grid_lo=None, h=None,
                         cells=torch.arange(256.0, device=cuda_device),
                         tfrac=tf)
    kspec = KernelSpec.polynomial(J=20, d=1, ski=True, grid_size=256)
    before = cuda_interp.launches["interp_transpose"]
    uy, u1 = grid_solve.build_interp_y(kspec, state, y)
    assert cuda_interp.launches["interp_transpose"] - before == 1
    one_y = cuda_interp.interp_transpose_cuda(tf, y[:, None], 256)[:, 0]
    one_1 = cuda_interp.interp_transpose_cuda(
        tf, torch.ones_like(y)[:, None], 256)[:, 0]
    assert torch.equal(uy, one_y) and torch.equal(u1, one_1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "crowded"])
@pytest.mark.parametrize("t", [1, 3, 8, 11, 17])
@pytest.mark.parametrize("m", [17, 256, cuda_interp.M_MAX])
def test_interp_apply_sum_matches_plain(cuda_device, kind, t, m):
    """K3 against its plain version (float64): uniform points and points
    crowded into three cells, the grid's edges, -100 padding; one launch
    for any t; rel <= 1e-5, padding rows exactly zero, a repeat bit for
    bit the same, and K3 the adjoint of K2 to 1e-5."""
    tf, V, G = _interp_case(5, 60000, m, t, kind, seed=m + 7 * t,
                            dev=cuda_device)
    before = cuda_interp.launches["interp_apply_sum"]
    O = cuda_interp.interp_apply_sum_cuda(tf, G)
    assert cuda_interp.launches["interp_apply_sum"] - before == 1
    Op = cuda_interp.interp_apply_sum_plain(tf.double(), G.double())
    torch.cuda.synchronize()
    assert _rel(O, Op) <= 1e-5
    assert bool((O[-500:] == 0).all())
    assert torch.equal(cuda_interp.interp_apply_sum_cuda(tf, G), O)
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    lhs = float(torch.sum(U.double() * G.double()))
    rhs = float(torch.sum(V.double() * O.double()))
    assert abs(lhs - rhs) <= 1e-5 * float(torch.linalg.norm(U.double())
                                          * torch.linalg.norm(G.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 11])
def test_interp_apply_sum_sweeps_and_unaligned_rows(cuda_device, t):
    """More components than K3's shared-memory table holds at m = M_MAX
    (several sweeps over the points, each adding to out), on rows of 16-byte
    quads (n = 20000) and on rows that are not (n odd, or the storage
    offset by one float): rel <= 1e-5 against the plain version, padding
    rows exactly zero."""
    m, J = cuda_interp.M_MAX, 40
    for n in (20000, 20001):
        tf, _, G = _interp_case(J, n, m, t, "uniform", seed=t, dev=cuda_device)
        shifted = torch.empty(J * n + 1, device=cuda_device)[1:].view(J, n)
        shifted.copy_(tf)
        for x in (tf, shifted):
            O = cuda_interp.interp_apply_sum_cuda(x, G)
            Op = cuda_interp.interp_apply_sum_plain(x.double(), G.double())
            torch.cuda.synchronize()
            assert _rel(O, Op) <= 1e-5
            assert bool((O[-500:] == 0).all())


@pytest.mark.cuda
def test_interp_apply_sum_rejects_m_past_limit(cuda_device):
    tf, _, G = _interp_case(2, 1000, cuda_interp.M_MAX + 1, 1, "uniform",
                            seed=0, dev=cuda_device)
    before = cuda_interp.launches["interp_apply_sum"]
    with pytest.raises(ValueError, match="m <="):
        cuda_interp.interp_apply_sum_cuda(tf, G)
    assert cuda_interp.launches["interp_apply_sum"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["projection", "rbf", "matern52",
                                    "rp_limit_rbf"])
def test_dense_mll_matches_float64_cpu(cuda_device, family):
    """The dense Cholesky MLL (exact_gp.exact_mll) at n = 1000 on the card,
    its factor padded to 1024 and run as two K1 leaves, against the same
    computation in float64 on the CPU: value rel <= 1e-5, gradient relerr
    <= 1e-4. The MLL's closed-form gradient assumes a symmetric input and
    the factor reads only the lower triangle; the Gram of the sqdist identity comes from a GEMM
    that need not return an exactly symmetric cross term, so the test
    records whether it did and holds the gradient to the bar either way
    (the gradient wrt the params sums K's entries in symmetric pairs)."""
    from rpagp_torch.models import exact_gp
    from rpagp_torch.models.exact_gp import ModelSpec
    from rpagp_torch.ops import kernels
    from rpagp_torch.ops.kernels import KernelSpec

    kspec = (KernelSpec.polynomial(J=20) if family == "projection"
             else KernelSpec(family=family, ard=family == "rbf"))
    spec = ModelSpec(kernel=kspec)
    rng = np.random.default_rng(8)
    n, D = 1000, 12
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.sin(x @ rng.standard_normal(D) / 3.0)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    p0, b0 = exact_gp.init_model(spec, D,
                                 generator=torch.Generator().manual_seed(3),
                                 device="cpu")
    p0["kernel"]["raw_lengthscale"] += torch.from_numpy(
        0.3 * rng.standard_normal(p0["kernel"]["raw_lengthscale"].shape)
        .astype(np.float32))
    out = {}
    for d, dtype in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        def to(tree):
            return {k: to(v) if isinstance(v, dict)
                    else v.to(d, dtype, copy=True) for k, v in tree.items()}

        p, b = to(p0), to(b0)
        leaves = [p["raw_noise"], p["mean_const"], *p["kernel"].values()]
        for t in leaves:
            t.requires_grad_(True)
        xd = torch.from_numpy(x).to(d, dtype)
        before = cuda_chol.launches["chol_linv"]
        v = exact_gp.exact_mll(spec, p, b, xd, torch.from_numpy(y).to(d, dtype))
        v.backward()
        if d == cuda_device:
            assert cuda_chol.launches["chol_linv"] == before + 2
            K = kernels.gram(kspec, p["kernel"], b["kernel"], xd, xd).detach()
            print(f"{family}: K exactly symmetric on the card "
                  f"{torch.equal(K, K.T)}, max |K - K^T| "
                  f"{float(torch.max(torch.abs(K - K.T))):.1e}")
        out[d == "cpu"] = (float(v.detach()), [t.grad for t in leaves])
    (vg, gg), (vc, gc) = out[False], out[True]
    assert abs(vg - vc) <= 1e-5 * abs(vc)
    num = sum(float(((a.double().cpu() - b) ** 2).sum()) for a, b in zip(gg, gc))
    den = sum(float((b ** 2).sum()) for b in gc)
    assert math.sqrt(num / den) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("J,m,t", [(20, 512, 11), (20, 256, 9), (20, 256, 257),
                                   (20, 256, 512), (20, 256, 513)],
                         ids=["sml-train", "houseelectric-train",
                              "posterior-cross", "love-rank",
                              "love-rank-plus-one"])
def test_interp_at_ski_bbmm_shapes(cuda_device, J, m, t):
    """K2 and K3 at the SKI + BBMM path's shapes (every CG iteration at
    t = num_probes + 1; a posterior cross MVM at t = love_rank and
    love_rank + 1) against their plain versions in float64: rel <= 1e-5,
    one K2 launch at any t, and a repeat bit for bit the same."""
    tf, V, G = _interp_case(J, 20000, m, t, "uniform", seed=t,
                            dev=cuda_device)
    before = cuda_interp.launches["interp_transpose"]
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    assert cuda_interp.launches["interp_transpose"] - before == 1
    O = cuda_interp.interp_apply_sum_cuda(tf, G)
    Up = cuda_interp.interp_transpose_plain(tf.double(), V.double(), m)
    Op = cuda_interp.interp_apply_sum_plain(tf.double(), G.double())
    torch.cuda.synchronize()
    assert _rel(U, Up) <= 1e-5
    assert _rel(O, Op) <= 1e-5
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V, m), U)
    assert torch.equal(cuda_interp.interp_apply_sum_cuda(tf, G), O)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 512])
def test_interp_points_beyond_the_grid(cuda_device, m):
    """Points past every tap's support (tfrac < -2 or > m + 1: a predictor's
    test points beyond its margin, a variance chunk's padding rows) give
    exactly zero: K3 returns zero rows, K2 ignores their values, as the
    plain versions do."""
    J, n, t = 20, 30000, 11
    tf, V, G = _interp_case(J, n, m, t, "uniform", seed=m, dev=cuda_device)
    far = torch.tensor([-1e6, -1e4, -50.0, -3.0, -2.001, m + 1.001, m + 1.5,
                        m + 7.0, m + 1e4, 1e6], device=cuda_device)
    tf[:, 100:100 + far.numel()] = far
    O = cuda_interp.interp_apply_sum_cuda(tf, G)
    Op = cuda_interp.interp_apply_sum_plain(tf.double(), G.double())
    assert bool((O[100:110] == 0).all()) and bool((Op[100:110] == 0).all())
    assert _rel(O, Op) <= 1e-5
    U = cuda_interp.interp_transpose_cuda(tf, V, m)
    V2 = V.clone()
    V2[100:110] = 1e6
    assert torch.equal(cuda_interp.interp_transpose_cuda(tf, V2, m), U)
    assert _rel(U, cuda_interp.interp_transpose_plain(tf.double(), V.double(),
                                                      m)) <= 1e-5


def _ski_case(J, m, n, seed):
    from rpagp_torch.ops.kernels import KernelSpec

    rng = np.random.default_rng(seed)
    kspec = KernelSpec.generalized([1] * J, ["rbf", "matern32"] * (J // 2),
                                   ski=True, grid_size=m)
    D = 8
    kp = {"raw_lengthscale": torch.from_numpy(
              (0.3 * rng.standard_normal(J)).astype(np.float32)),
          "raw_outputscale": torch.tensor(0.2)}
    kb = {"proj": torch.from_numpy(
        rng.standard_normal((D, J)).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    return kspec, kp, kb, x


@pytest.mark.cuda
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_ski_mvm_matches_cpu(cuda_device, cross):
    """ski_mvm (K2, the Toeplitz FFT product, K3) at J = 20, m = 512,
    t = 11 on the card against the same computation in float64 on the
    CPU: value rel <= 1e-5 in norm, gradient relerr <= 1e-4 to the kernel
    params and to V (the backward runs K3's adjoint, K2)."""
    from rpagp_torch.ops import ski

    kspec, kp, kb, x = _ski_case(20, 512, 20000, seed=5)
    xo = x[:3000] * 1.3 if cross else x
    rng = np.random.default_rng(6)
    V = torch.from_numpy(rng.standard_normal((x.shape[0], 11))
                         .astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((xo.shape[0], 11))
                         .astype(np.float32))
    z = (torch.cat([x, xo]) @ kb["proj"]).T
    bounds = (z.amin(1), z.amax(1))
    out = {}
    for d, dtype in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        k = {key: v.to(d, dtype).requires_grad_(True) for key, v in kp.items()}
        b = {"proj": kb["proj"].to(d, dtype)}
        bd = tuple(v.to(d, dtype) for v in bounds)
        st_rhs = ski.build_ski(kspec, k, b, x.to(d, dtype), 512, z_bounds=bd)
        st = ski.build_ski(kspec, k, b, xo.to(d, dtype), 512, z_bounds=bd)
        if d == "cpu":  # the card's geometry, so both see the same taps
            st = st._replace(tfrac=out[False][3].cpu().double())
            st_rhs = st_rhs._replace(tfrac=out[False][4].cpu().double())
        v = V.to(d, dtype).requires_grad_(True)
        before = dict(cuda_interp.launches)
        o = ski.ski_mvm(kspec, k, st, v, state_rhs=st_rhs)
        torch.sum(o * W.to(d, dtype)).backward()
        if d == cuda_device:
            # forward K2 and K3; backward K2 (K3's adjoint) and K3 (K2's
            # adjoint), one launch each at t = 11
            assert cuda_interp.launches["interp_transpose"] \
                - before["interp_transpose"] == 2
            assert cuda_interp.launches["interp_apply_sum"] \
                - before["interp_apply_sum"] == 2
        out[d == "cpu"] = (o.detach(), [k[key].grad for key in sorted(k)],
                           v.grad, st.tfrac, st_rhs.tfrac)
    (og, gg, vg, _, _), (oc, gc, vc, _, _) = out[False], out[True]
    assert _rel(og, oc) <= 1e-5
    num = sum(float(((a.double().cpu() - b) ** 2).sum()) for a, b in zip(gg, gc))
    den = sum(float((b ** 2).sum()) for b in gc)
    assert math.sqrt(num / den) <= 1e-4
    assert _rel(vg, vc) <= 1e-4


@pytest.mark.cuda
def test_refresh_preconditioner_on_the_card(cuda_device):
    """precond_refresh > 1: prepare_buffers caches the rank-15 pivoted
    Cholesky on the card; refresh_preconditioner rebuilds it there without
    a host read; the MLL with the cached M agrees with the CPU's on the
    same probe normals (value rel <= 1e-4, gradient relerr <= 1e-3, the
    BBMM bar)."""
    from rpagp_torch.models import exact_gp
    from rpagp_torch.models.exact_gp import ModelSpec
    from rpagp_torch.ops import iterative
    from rpagp_torch.ops.kernels import KernelSpec

    spec = ModelSpec(kernel=KernelSpec.polynomial(J=10), cg_max_iters=30,
                     precond_rank=15, num_probes=10, precond_refresh=10,
                     max_cholesky_size=64)
    rng = np.random.default_rng(11)
    n, D = 6000, 8
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    y = torch.sin(x[:, 0]) + 0.1 * torch.from_numpy(
        rng.standard_normal(n).astype(np.float32))
    p0, b0 = exact_gp.init_model(spec, D, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    es = torch.from_numpy(rng.standard_normal((15, 10)).astype(np.float32))
    eb = torch.from_numpy(rng.standard_normal((n, 10)).astype(np.float32))
    out = {}
    for d in (cuda_device, "cpu"):
        def to(tree):
            return {k: to(v) if isinstance(v, dict) else v.to(d, copy=True)
                    for k, v in tree.items()}

        p, b, xd = to(p0), to(b0), x.to(d)
        b = exact_gp.prepare_buffers(spec, p, b, xd)
        pre = b["precond_cache"]
        assert pre.L.device.type == torch.device(d).type
        if d == cuda_device:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                b2 = exact_gp.refresh_preconditioner(spec, p, b, xd)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert torch.equal(b2["precond_cache"].L, pre.L)
        # the hyperparameters move; the cache stays at the old ones
        p["kernel"]["raw_lengthscale"] = p["kernel"]["raw_lengthscale"] + 0.3
        leaves = [p["raw_noise"], p["mean_const"], *p["kernel"].values()]
        for t in leaves:
            t.requires_grad_(True)
        iq, ld = iterative.inv_quad_logdet_eps(spec, p, b, xd, y.to(d),
                                               es.to(d), eb.to(d))
        v = -0.5 * (iq + ld)
        v.backward()
        out[d == "cpu"] = (pre.L, float(v.detach()), [t.grad for t in leaves])
    (Lg, vg, gg), (Lc, vc, gc) = out[False], out[True]
    assert _rel(Lg, Lc) <= 1e-4
    assert abs(vg - vc) <= 1e-4 * abs(vc)
    num = sum(float(((a.double().cpu() - b.double()) ** 2).sum())
              for a, b in zip(gg, gc))
    den = sum(float((b.double() ** 2).sum()) for b in gc)
    assert math.sqrt(num / den) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 9])
def test_sorted_plan_against_k2_k3(cuda_device, t):
    """The sorted plan (plain torch on the card) against K2 and K3 on one
    state at J = 20, m = 256, n = 100,000: W^T V and sum_j W_j G_j agree at
    2e-4 (the JAX package's bar for its two plans), and the sorted plan on
    the card agrees with itself in float64 on the CPU at 1e-5."""
    from rpagp_torch.ops import ski

    kspec, kp, kb, x = _ski_case(20, 256, 100_000, seed=8)
    st = ski.build_ski(kspec, kp, {"proj": kb["proj"].to(cuda_device)},
                       x.to(cuda_device), 256, plan="sorted")
    rng = np.random.default_rng(9)
    V = torch.from_numpy(rng.standard_normal((x.shape[0], t)).astype(
        np.float32)).to(cuda_device)
    G = torch.from_numpy(rng.standard_normal((20, t, 256)).astype(
        np.float32)).to(cuda_device)
    U = ski.interp_transpose(st, V)
    O = ski.interp_apply(st, G).sum(0).T
    Uk = cuda_interp.interp_transpose_cuda(st.tfrac, V, 256)
    Ok = cuda_interp.interp_apply_sum_cuda(st.tfrac, G)
    torch.cuda.synchronize()
    assert _rel(U, Uk) <= 2e-4 and _rel(O, Ok) <= 2e-4
    st64 = ski.SKIState(*(None if f is None else
                          (f.cpu().double() if f.is_floating_point()
                           else f.cpu()) for f in st))
    assert _rel(U, ski.interp_transpose(st64, V.cpu().double())) <= 1e-5
    assert _rel(O, ski.interp_apply(st64, G.cpu().double()).sum(0).T) <= 1e-5


@pytest.mark.cuda
def test_resume_on_the_card(cuda_device, tmp_path):
    """train_with_checkpointing on CUDA params with a CUDA generator: 12
    steps in one call against 6 and a resume to 12 (the resumed call is
    handed a generator of another seed): the same losses and params bit
    for bit."""
    from rpagp_torch.train import train_with_checkpointing

    rng = np.random.default_rng(12)
    A = torch.from_numpy(rng.standard_normal((64, 8)).astype(
        np.float32)).to(cuda_device)
    p0 = {"w": torch.zeros(8, device=cuda_device),
          "s": {"b": torch.ones((), device=cuda_device)}}

    def loss(p, gen):
        e = torch.randn(64, generator=gen, device=cuda_device)
        return torch.mean((A @ p["w"] + p["s"]["b"] - e) ** 2)

    def gen(seed):
        return torch.Generator(device=cuda_device).manual_seed(seed)

    full = train_with_checkpointing(loss, p0, str(tmp_path / "a"),
                                    max_iters=12, checkpoint_every=3,
                                    generator=gen(1))
    d = str(tmp_path / "b")
    train_with_checkpointing(loss, p0, d, max_iters=6, checkpoint_every=3,
                             generator=gen(1))
    res = train_with_checkpointing(loss, p0, d, max_iters=12,
                                   checkpoint_every=3, generator=gen(2))
    assert res.iterations == 6 and res.losses == full.losses
    assert res.params["w"].device == p0["w"].device
    assert torch.equal(res.params["w"], full.params["w"])
    assert torch.equal(res.params["s"]["b"], full.params["s"]["b"])


@pytest.mark.cuda
def test_nccl_world_of_one_grid_mll_matches_single_card(cuda_device):
    """distributed_grid_mll over a NCCL process group of one rank (opened
    in this process) against grid_mll on the same card, at the initial
    params of a small grid spec: value rel <= 1e-5, gradient relerr <= 1e-4
    (the reference's tests/test_grid_sharding.py bars)."""
    import torch.distributed as dist

    from rpagp_torch.models import exact_gp
    from rpagp_torch.models.exact_gp import ModelSpec
    from rpagp_torch.ops import grid_solve
    from rpagp_torch.ops.kernels import KernelSpec
    from rpagp_torch.parallel import multihost, sharding
    from rpagp_torch.train import _leaves

    if dist.is_initialized():
        pytest.skip("a process group is already open in this process")
    spec = ModelSpec(kernel=KernelSpec.polynomial(J=4, ski=True,
                                                  grid_size=64))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4096, 6)).astype(np.float32))
    y = torch.sin(2.0 * x[:, 0]) + 0.3 * torch.from_numpy(
        rng.standard_normal(4096).astype(np.float32))
    x, y = x.to(cuda_device), y.to(cuda_device)
    params, kbuf = exact_gp.init_model(spec, 6, generator=torch.Generator()
                                       .manual_seed(0), device=cuda_device)
    multihost.initialize("cuda")
    try:
        mesh = sharding.make_mesh()
        assert dist.get_backend() == "nccl" and mesh.world == 1
        state, S4, uy, u1, vc = sharding.prepare_distributed_grid(
            spec, params, kbuf, x, mesh, y_local=y)
        buffers = exact_gp.prepare_buffers(spec, params, kbuf, x, y_train=y)
        out = []
        for dist_path in (True, False):
            p = {k: ({kk: vv.clone().requires_grad_(True)
                      for kk, vv in v.items()} if isinstance(v, dict)
                     else v.clone().requires_grad_(True))
                 for k, v in params.items()}
            if dist_path:
                v = sharding.distributed_grid_mll(spec, p, x, y, state, S4,
                                                  mesh, uy=uy, u1=u1, vc=vc)
            else:
                v = grid_solve.grid_mll(spec, p, buffers, x, y)
            v.backward()
            if dist_path:
                sharding.assemble_grads(_leaves(p), mesh)
            out.append((float(v.detach()), [t.grad for t in _leaves(p)]))
    finally:
        multihost.shutdown()
    (vd, gd), (vs, gs) = out
    assert abs(vd - vs) <= 1e-5 * abs(vs)
    num = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(gd, gs))
    den = sum(float((b.double() ** 2).sum()) for b in gs)
    assert math.sqrt(num / den) <= 1e-4
