"""rpagp_torch kernel modules against the JAX package, on the CPU.

The same seeded numpy inputs go through each JAX function and its port:
K1 (ops/cuda_chol.py) against the Pallas leaf and fused batched kernels
in interpret mode, K2/K3 (ops/cuda_interp.py) against the XLA dense plan
and the Pallas interp kernels in interpret mode, and the blocked
factor against block_chol with its XLA leaf. On the CPU the port runs
each kernel's plain version. Tolerances: values rel <= 1e-5 (norm-wise),
gradients rel <= 1e-4, as the reference's own parity bar.

tests/test_torch_port_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import block_chol as jbc
from rpagp.ops import pallas_chol, pallas_interp
from rpagp.ops import ski as jski
from rpagp_torch.ops import block_chol, cuda_chol, cuda_interp, ski

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _spd(b, seed, jitter=0.5):
    B = np.random.default_rng(seed).standard_normal((b, b)).astype(np.float32)
    A = B @ B.T / b + jitter * np.eye(b, dtype=np.float32)
    return (0.5 * (A + A.T)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------- K1 ----


def test_chol_linv_matches_pallas_panel_kernel():
    """b=256 reaches the 128-panel kernel of pallas_chol."""
    A = _spd(256, seed=0)
    Lj, Linvj, okj = pallas_chol.chol_linv(jnp.asarray(A), True)
    L, Linv, ok = cuda_chol.chol_linv(_t(A))
    assert float(ok) == float(okj) == 1.0
    assert _rel(L, Lj) <= 1e-5
    assert _rel(Linv, Linvj) <= 1e-5
    assert float(torch.max(torch.abs(torch.triu(L, 1)))) == 0.0


def test_chol_linv_batched_matches_fused_kernel():
    """(4, 128, 128) against the fused batched kernel; block 2 is
    indefinite: its ok is 0 on both sides, the others are unaffected,
    and every output is finite."""
    T = np.stack([_spd(128, seed=s) for s in range(4)])
    T[2] -= 10.0 * np.eye(128, dtype=np.float32)
    Lj, Linvj, okj = pallas_chol.chol_linv_batched_fused(jnp.asarray(T), True)
    L, Linv, ok = cuda_chol.chol_linv_batched(_t(T))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(ok.numpy(), [1.0, 1.0, 0.0, 1.0])
    assert bool(torch.isfinite(L).all()) and bool(torch.isfinite(Linv).all())
    assert np.all(np.isfinite(np.asarray(Lj)))
    for j in (0, 1, 3):
        assert _rel(L[j], Lj[j]) <= 1e-5
        assert _rel(Linv[j], Linvj[j]) <= 1e-5


@pytest.mark.parametrize("batched", [False, True])
def test_chol_linv_gradient_matches_jax(batched):
    """The closed-form VJP (autograd.Function) against jax.grad through
    the Pallas kernel's custom_vjp, on a loss reaching L and Linv,
    through a symmetrized input (the only way callers reach it)."""
    b = 128
    rng = np.random.default_rng(3)
    A = _spd(b, seed=3)[None].repeat(2, 0) if batched else _spd(b, seed=3)
    R1 = rng.standard_normal(A.shape).astype(np.float32)
    R2 = rng.standard_normal(A.shape).astype(np.float32)

    def loss_j(A):
        As = 0.5 * (A + jnp.swapaxes(A, -1, -2))
        if batched:
            L, Linv, _ = pallas_chol.chol_linv_batched_fused(As, True)
        else:
            L, Linv, _ = pallas_chol.chol_linv(As, True)
        return jnp.vdot(L, R1) + jnp.vdot(Linv, R2)

    gj = jax.grad(loss_j)(jnp.asarray(A))
    At = _t(A).requires_grad_(True)
    As = 0.5 * (At + At.mT)
    fn = cuda_chol.chol_linv_batched if batched else cuda_chol.chol_linv
    L, Linv, _ = fn(As)
    (torch.sum(L * _t(R1)) + torch.sum(Linv * _t(R2))).backward()
    assert _rel(At.grad, gj) <= 1e-4


def test_blocked_cholesky_matches_jax_xla_leaf():
    """p=200 with block=64: the identity-tail pad, the K1 leaf and the
    triangular trailing update, value and gradient, against block_chol
    with leaf="xla"; plus the triangular solve and the indefinite flag."""
    p, blk = 200, 64
    A = _spd(p, seed=5)
    rng = np.random.default_rng(6)
    R = rng.standard_normal((p, p)).astype(np.float32)
    B = rng.standard_normal((p, 7)).astype(np.float32)

    def loss_j(A):
        L, _ = jbc.blocked_cholesky_safe(0.5 * (A + A.T), block=blk,
                                         leaf="xla")
        return jnp.vdot(L, R) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))

    vj, gj = jax.value_and_grad(loss_j)(jnp.asarray(A))
    At = _t(A).requires_grad_(True)
    L, ok = block_chol.blocked_cholesky_safe(0.5 * (At + At.T), block=blk)
    assert bool(ok)
    v = torch.sum(L * _t(R)) + 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    v.backward()
    assert abs(float(v.detach()) - float(vj)) <= 1e-5 * abs(float(vj))
    assert _rel(At.grad, gj) <= 1e-4

    Lj, _ = jbc.blocked_cholesky_safe(jnp.asarray(A), block=blk, leaf="xla")
    assert _rel(L.detach(), Lj) <= 1e-5
    Xj = jbc.blocked_solve_triangular(Lj, jnp.asarray(B), block=blk)
    X = block_chol.blocked_solve_triangular(L.detach(), _t(B), block=blk)
    assert _rel(X, Xj) <= 1e-5

    Abad = A - 10.0 * np.eye(p, dtype=np.float32)
    Lb, okb = block_chol.blocked_cholesky_safe(_t(Abad), block=blk)
    _, okbj = jbc.blocked_cholesky_safe(jnp.asarray(Abad), block=blk,
                                        leaf="xla")
    assert not bool(okb) and not bool(okbj)
    assert bool(torch.isfinite(Lb).all())
    assert not bool(torch.isfinite(
        block_chol.blocked_cholesky(_t(Abad), block=blk)).all())


# ------------------------------------------------------------- K2 / K3 ----


def _interp_inputs(J=3, n=3000, m=64, t=5, seed=0, edges=True):
    """tfrac in the grid's interior, plus (edges=True) points on and past
    both ends of the grid and -100 padding."""
    rng = np.random.default_rng(seed)
    tf = rng.uniform(1.0, m - 3.0, (J, n)).astype(np.float32)
    if edges:
        tf[:, :6] = [-2.5, -1.5, -0.25, 0.0, m - 1.0, m + 0.5]
        tf[:, 6:9] = -100.0
    V = rng.standard_normal((n, t)).astype(np.float32)
    G = rng.standard_normal((J, t, m)).astype(np.float32)
    return tf, V, G


def _jax_state(tf, m):
    J = tf.shape[0]
    return jski.SKIState(grid_lo=jnp.zeros(J), h=jnp.ones(J),
                         cells=jnp.arange(m, dtype=jnp.float32),
                         tfrac=jnp.asarray(tf), i0=None, w4=None,
                         order=None, w4_sorted=None, bounds=None)


def test_interp_plain_matches_xla_dense_plan():
    """Both directions against the XLA dense plan, edge points and
    padding included (the tap semantics the port keeps)."""
    m = 64
    tf, V, G = _interp_inputs(m=m)
    st = _jax_state(tf, m)
    Uj = jski._dense_interp_transpose_impl(st, jnp.asarray(V))
    Oj = jski._dense_interp_apply_sum_impl(st, jnp.asarray(G))
    U = cuda_interp.interp_transpose(_t(tf), _t(V), m)
    O = cuda_interp.interp_apply_sum(_t(tf), _t(G))
    assert U.shape == (3, 5, m) and O.shape == (3000, 5)
    assert _rel(U, Uj) <= 1e-5
    assert _rel(O, Oj) <= 1e-5
    # padding rows contribute nothing and receive nothing
    np.testing.assert_array_equal(O[6:9].numpy(), 0.0)
    Vp = V.copy()
    Vp[6:9] = 1e6
    U2 = cuda_interp.interp_transpose(_t(tf), _t(Vp), m)
    np.testing.assert_array_equal(U2.numpy(), U.numpy())


def test_interp_plain_matches_pallas_kernels():
    """Against the Pallas kernels in interpret mode, on interior points
    (where the Pallas and XLA tap semantics agree) with -100 padding to
    the Pallas block size; the Pallas bf16 hi+lo split is ~1e-6."""
    m = 64
    tf, V, G = _interp_inputs(n=1500, m=m, edges=False)
    J, n = tf.shape
    n_pad = -(-n // pallas_interp.BN) * pallas_interp.BN
    tfp = np.full((J, n_pad), -100.0, np.float32)
    tfp[:, :n] = tf
    VTp = np.zeros((V.shape[1], n_pad), np.float32)
    VTp[:, :n] = V.T
    Uj = pallas_interp.transpose_call(jnp.asarray(tfp), jnp.asarray(VTp), m,
                                      interpret=True)
    Oj = pallas_interp.apply_sum_call(jnp.asarray(tfp), jnp.asarray(G),
                                      interpret=True)
    U = cuda_interp.interp_transpose(_t(tf), _t(V), m)
    O = cuda_interp.interp_apply_sum(_t(tf), _t(G))
    assert _rel(U, Uj) <= 1e-5
    assert _rel(O, np.asarray(Oj)[:, :n].T) <= 1e-5


def test_interp_adjoint_pair_and_gradients():
    """<W^T v, g> = <v, W g>, and each autograd.Function's backward is the
    other's forward: gradients match jax.grad through the custom_vjp pair."""
    m = 64
    tf, V, G = _interp_inputs(m=m)
    st_t = ski.SKIState(grid_lo=torch.zeros(3), h=torch.ones(3),
                        cells=torch.arange(m, dtype=torch.float32),
                        tfrac=_t(tf))
    U = ski.dense_interp_transpose(st_t, _t(V))
    O = ski.dense_interp_apply_sum(st_t, _t(G))
    lhs, rhs = float(torch.sum(U * _t(G))), float(torch.sum(_t(V) * O))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)

    st = _jax_state(tf, m)
    Ru = np.random.default_rng(9).standard_normal(U.shape).astype(np.float32)
    Ro = np.random.default_rng(10).standard_normal(O.shape).astype(np.float32)
    gVj = jax.grad(lambda v: jnp.vdot(jski.dense_interp_transpose(st, v),
                                      Ru))(jnp.asarray(V))
    gGj = jax.grad(lambda g: jnp.vdot(jski.dense_interp_apply_sum(st, g),
                                      Ro))(jnp.asarray(G))
    Vt = _t(V).requires_grad_(True)
    Gt = _t(G).requires_grad_(True)
    torch.sum(ski.dense_interp_transpose(st_t, Vt) * _t(Ru)).backward()
    torch.sum(ski.dense_interp_apply_sum(st_t, Gt) * _t(Ro)).backward()
    assert _rel(Vt.grad, gVj) <= 1e-5
    assert _rel(Gt.grad, gGj) <= 1e-5


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors."""
    A = torch.eye(32, device="meta")
    with pytest.raises(TypeError):
        cuda_chol.chol_linv_batched(A[None])
    with pytest.raises(TypeError):
        cuda_interp.interp_apply_sum(torch.zeros(2, 5, device="meta"),
                                     torch.zeros(2, 1, 8, device="meta"))
