"""rpagp_torch's BBMM solvers against the JAX package, on the CPU: batched
PCG (fixed-length and early-exit), the Lanczos tridiagonals from CG and
their SLQ logdet, the pivoted-Cholesky preconditioner, and the LOVE
Lanczos cache. The same seeded numpy inputs go to both packages (the
Lanczos restart table too: RNG streams do not port).

Tolerances: values rel <= 1e-5 where both sides run the same f32
recurrence on the same inputs over few steps; CG solutions and the
Lanczos basis after many f32 steps rel <= 1e-4, since summation order
differs and each step carries the last one's rounding forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import cg as jcg
from rpagp.ops import kernels as jkernels
from rpagp.ops import love as jlove
from rpagp.ops import precond as jprecond
from rpagp.ops import slq as jslq
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch.ops import cg, kernels, love, precond, slq
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils.convert import to_torch

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _spd(n, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.logspace(0, np.log10(cond), n)
    return ((Q * ev) @ Q.T).astype(np.float32)


def _kernel_problem(n=120, D=4, J=5, seed=0):
    jspec = JKernelSpec.polynomial(J=J, d=1, base="rbf")
    spec = KernelSpec.polynomial(J=J, d=1, base="rbf")
    kp, kb = jax.device_get(
        jkernels.init_kernel_params(jax.random.key(seed), jspec, D))
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    return jspec, spec, kp, kb, x


# ------------------------------------------------------------ CG ----


@pytest.mark.parametrize("precondition", [False, True])
def test_batched_pcg_and_slq_match(precondition):
    """Fixed-length PCG on a fixed SPD matrix: best iterates, (alpha, beta),
    the convergence mask (the same iterations frozen per column), the
    tridiagonals and their SLQ logdet."""
    n, t = 80, 4
    A = _spd(n, seed=1, cond=30.0)
    B = np.random.default_rng(2).standard_normal((n, t)).astype(np.float32)
    B[:, 0] = A @ np.ones(n, np.float32)  # a column that converges fast
    Dinv = (1.0 / np.diag(A)).astype(np.float32)
    Aj, At = jnp.asarray(A), _t(A)
    Mj = (lambda R: R * jnp.asarray(Dinv)[:, None]) if precondition else None
    Mt = (lambda R: R * _t(Dinv)[:, None]) if precondition else None
    rj = jcg.batched_pcg(lambda V: jnp.matmul(
        Aj, V, precision=jax.lax.Precision.HIGHEST), jnp.asarray(B), Mj,
        max_iters=25, tol=1e-2)
    rt = cg.batched_pcg(lambda V: At @ V, _t(B), Mt, max_iters=25, tol=1e-2)
    np.testing.assert_array_equal(rt.alphas.numpy() == 0,
                                  np.asarray(rj.alphas) == 0)
    assert (rt.alphas.numpy() == 0).any()  # the mask froze some iterations
    assert _rel(rt.solution.numpy(), rj.solution) <= 1e-4
    assert _rel(rt.alphas.numpy(), rj.alphas) <= 1e-4
    assert _rel(rt.betas.numpy(), rj.betas) <= 1e-4
    Tj = jcg.lanczos_tridiags_from_cg(rj.alphas, rj.betas)
    T = cg.lanczos_tridiags_from_cg(rt.alphas, rt.betas)
    assert T.shape == (t, 25, 25)
    assert _rel(T.numpy(), Tj) <= 1e-4
    sq = np.random.default_rng(3).random(t).astype(np.float32) + 1.0
    ldj = jslq.slq_logdet_from_tridiags(Tj, jnp.asarray(sq), 2.5)
    ld = slq.slq_logdet_from_tridiags(T, _t(sq), 2.5)
    assert _rel(float(ld), float(ldj)) <= 1e-5
    # the same tridiagonals on both sides: SLQ alone at the 1e-5 bar
    ld_same = slq.slq_logdet_from_tridiags(_t(Tj), _t(sq), 2.5)
    assert _rel(float(ld_same), float(ldj)) <= 1e-5


def test_batched_pcg_while_matches():
    """Early exit: the same iteration count and solution."""
    n = 80
    A = _spd(n, seed=4, cond=1e2)
    B = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    rj = jcg.batched_pcg_while(lambda V: jnp.matmul(
        jnp.asarray(A), V, precision=jax.lax.Precision.HIGHEST),
        jnp.asarray(B), None, max_iters=200, tol=1e-4)
    rt = cg.batched_pcg_while(lambda V: _t(A) @ V, _t(B), None, max_iters=200,
                              tol=1e-4)
    assert int(rt.iterations) == int(rj.iterations) < 200
    assert _rel(rt.solution.numpy(), rj.solution) <= 1e-4
    # the residuals themselves sit at f32 rounding here; both meet tol
    assert float(rt.residual_norm.max()) <= 1e-4


# ------------------------------------------------- preconditioner ----


def test_pivoted_cholesky_and_preconditioner_match():
    jspec, spec, kp, kb, x = _kernel_problem()
    Lj = jprecond.pivoted_cholesky(jspec, kp, kb, jnp.asarray(x), 12)
    L = precond.pivoted_cholesky(spec, to_torch(kp, device="cpu"),
                                 to_torch(kb, device="cpu"), _t(x), 12)
    # the same pivots: each column's pivot is the row where it peaks
    np.testing.assert_array_equal(np.argmax(np.abs(L.numpy()), axis=0),
                                  np.argmax(np.abs(np.asarray(Lj)), axis=0))
    assert _rel(L.numpy(), Lj) <= 1e-5
    noise = np.float32(0.05)
    pj = jprecond.build_preconditioner(jspec, kp, kb, jnp.asarray(x),
                                       jnp.asarray(noise), 12)
    pre = precond.build_preconditioner(spec, to_torch(kp, device="cpu"),
                                       to_torch(kb, device="cpu"),
                                       _t(x), torch.tensor(noise), 12)
    assert _rel(pre.chol_small.numpy(), pj.chol_small) <= 1e-5
    assert _rel(float(pre.logdet), float(pj.logdet)) <= 1e-5
    R = np.random.default_rng(6).standard_normal((120, 3)).astype(np.float32)
    assert _rel(precond.apply_inverse(pre, _t(R)).numpy(),
                jprecond.apply_inverse(pj, jnp.asarray(R))) <= 1e-5
    # and through the JAX NamedTuple carried into the port's
    pc = to_torch(jax.device_get(pj), device="cpu")
    assert isinstance(pc, precond.Preconditioner)
    assert _rel(precond.apply_inverse(pc, _t(R)).numpy(),
                jprecond.apply_inverse(pj, jnp.asarray(R))) <= 1e-5


# ------------------------------------------------------------ LOVE ----


def test_lanczos_and_love_cache_match():
    """Lanczos with full reorthogonalization and breakdown restarts (rank
    above the Krylov grade of a 12-eigenvalue operator) from the same
    restart table, then the LOVE cache and its variance/covariance."""
    n, rank = 60, 20
    rng = np.random.default_rng(7)
    # block-diagonal, so the first 12 coordinates are an invariant subspace
    # also in f32; a start vector inside it exhausts its Krylov space after
    # 12 steps (beta at rounding level, ||A|| = 0.5, far under the 1e-6
    # test), and Lanczos restarts from the table
    A = np.zeros((n, n), np.float32)
    for lo, hi in ((0, 12), (12, n)):
        Qb, _ = np.linalg.qr(rng.standard_normal((hi - lo, hi - lo)))
        ev = np.logspace(-1.3, -0.3, hi - lo)
        A[lo:hi, lo:hi] = (Qb * ev) @ Qb.T
    v0 = np.zeros(n, np.float32)
    v0[:12] = rng.standard_normal(12)
    fresh = rng.standard_normal((rank, n)).astype(np.float32)
    Aj = jnp.asarray(A)
    mv_j = lambda V: jnp.matmul(Aj, V, precision=jax.lax.Precision.HIGHEST)
    Qj, Tj = jlove.lanczos(mv_j, jnp.asarray(v0), rank,
                           fresh=jnp.asarray(fresh))
    Q, T = love.lanczos(lambda V: _t(A) @ V, _t(v0), rank, fresh=_t(fresh))
    assert (np.diag(np.asarray(Tj), 1) == 0).any()  # a restart happened
    np.testing.assert_array_equal(np.diag(T.numpy(), 1) == 0,
                                  np.diag(np.asarray(Tj), 1) == 0)
    assert _rel(T.numpy(), Tj) <= 1e-4
    assert _rel(Q.numpy(), Qj) <= 1e-4
    noise = np.float32(0.05)
    cj = jlove.build_love_cache(mv_j, jnp.asarray(v0), jnp.asarray(noise),
                                rank, fresh=jnp.asarray(fresh))
    c = love.build_love_cache(lambda V: _t(A) @ V, _t(v0), torch.tensor(noise),
                              rank, fresh=_t(fresh))
    assert _rel(c.T_chol.numpy(), cj.T_chol) <= 1e-4
    assert _rel(c.alpha.numpy(), cj.alpha) <= 1e-4
    KQ = rng.standard_normal((9, rank)).astype(np.float32)
    kd = np.full(9, 10.0, np.float32)
    assert _rel(love.love_variance(c, _t(KQ), _t(kd)).numpy(),
                jlove.love_variance(cj, jnp.asarray(KQ), jnp.asarray(kd))) <= 1e-4
    Kss = (np.eye(9) * 10.0).astype(np.float32)
    assert _rel(love.love_covariance(c, _t(KQ), _t(Kss)).numpy(),
                jlove.love_covariance(cj, jnp.asarray(KQ),
                                      jnp.asarray(Kss))) <= 1e-4
