"""rpagp_torch's sorted SKI interpolation plan against the JAX package's,
on the CPU: the sort plan (i0, order, bounds, the taps), the
interp_transpose / interp_apply pair and its backward through both apply
branches (t < 4 and t >= 4) and through the component-group loop, the
sorted branch of ski_mvm and ski_gram_diag, the SKI + BBMM MLL on a
sorted state, and to_torch of a sorted JAX state. The port's sorted plan
is also held against its own dense plan at the JAX package's bar for its
two plans (tests/test_ski.py).

Tolerances: i0, order and bounds equal exactly (the same z in both
packages); taps rel <= 1e-6; operator values rel <= 1e-5 in norm and
gradients relerr <= 1e-4; the MLL on a sorted state value rel <= 1e-4,
gradient relerr <= 1e-3 (the BBMM bar, PERF.md section 2); sorted against
dense rtol = atol = 2e-4, the MVM's gradient rtol 2e-3, atol 2e-4.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops import iterative as jiter
from rpagp.ops import kernels as jkernels
from rpagp.ops import ski as jski
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import iterative, ski
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)
LOG_2PI = 1.8378770664093453
J, D, N, M = 4, 3, 400, 48


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_relerr(ga, gb):
    la, lb = jax.tree.leaves(ga), jax.tree.leaves(gb)
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
              for a, b in zip(la, lb))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in lb)
    return math.sqrt(num / max(den, 1e-30))


def _specs(interp="sorted", bases=("rbf",) * J):
    kw = dict(ski=True, grid_size=M, interp=interp)
    return (JKernelSpec.generalized([1] * J, list(bases), **kw),
            KernelSpec.generalized([1] * J, list(bases), **kw))


def _data(seed=0, n=N):
    """Kernel params and buffers (numpy, the JAX package's init with a
    seeded lengthscale), and n points."""
    jk, _ = _specs()
    kp, kb = jax.device_get(jkernels.init_kernel_params(
        jax.random.key(seed), jk, D))
    rng = np.random.default_rng(seed)
    kp = dict(kp, raw_lengthscale=(0.3 * rng.standard_normal(J))
              .astype(np.float32), raw_outputscale=np.float32(0.2))
    x = rng.standard_normal((n, D)).astype(np.float32)
    return kp, kb, x


def _state_pair(x=None, z_bounds=None):
    """The JAX package's sorted state and the port's copy of it."""
    jk, _ = _specs()
    kp, kb, x0 = _data()
    x = x0 if x is None else x
    bj = None if z_bounds is None else tuple(map(jnp.asarray, z_bounds))
    stj = jski.build_ski(jk, kp, kb, jnp.asarray(x), M, z_bounds=bj)
    return stj, to_torch(jax.device_get(stj), device="cpu")


# ------------------------------------------------------ the sort plan ----


@pytest.mark.parametrize("narrow", [False, True], ids=["own", "narrow"])
def test_sort_plan_matches(narrow):
    """_geometry_from_z on one z: i0, order and bounds exactly, the taps
    and the sorted taps at rel 1e-6. A narrow grid puts points beyond it
    (clamped base cells, zero taps) and makes many ties in i0, which the
    stable argsort keeps in the JAX package's order."""
    rng = np.random.default_rng(1)
    z = rng.standard_normal((J, N)).astype(np.float32)
    zb = (np.full(J, -0.5, np.float32), np.full(J, 0.5, np.float32))
    stj = jski._geometry_from_z(
        jnp.asarray(z), M, tuple(map(jnp.asarray, zb)) if narrow else None,
        "sorted")
    st = ski._geometry_from_z(
        torch.tensor(z), M, tuple(map(torch.tensor, zb)) if narrow else None,
        "sorted")
    for f in ("i0", "order", "bounds"):
        a = getattr(st, f)
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(stj, f)),
                                      err_msg=f)
    for f in ("w4", "w4_sorted"):
        assert _rel(getattr(st, f), getattr(stj, f)) <= 1e-6, f
    assert int(st.bounds[:, -1].min()) == N  # every point below the last cell
    if narrow:
        assert bool((st.w4.sum(0) == 0).any())  # points beyond the grid


def test_build_ski_sorted_plan():
    """build_ski(plan="sorted") (or spec.interp = "sorted") keeps the dense
    plan's fields bit for bit and adds the sort plan of its own tfrac; the
    JAX package's state from the same x agrees in tfrac; an unknown plan
    raises."""
    jk, tk = _specs()
    kp, kb, x = _data()
    kpt, kbt = to_torch(kp, device="cpu"), to_torch(kb, device="cpu")
    xt = torch.tensor(x)
    st = ski.build_ski(tk, kpt, kbt, xt, M)
    dense = ski.build_ski(tk, kpt, kbt, xt, M, plan="dense")
    assert dense.order is None and dense.w4 is None
    for f in ("grid_lo", "h", "cells", "tfrac"):
        assert torch.equal(getattr(st, f), getattr(dense, f)), f
    i0, w4 = ski._tap_geometry(st.tfrac, M)
    assert torch.equal(st.i0, i0) and torch.equal(st.w4, w4)
    assert torch.equal(torch.gather(i0, 1, st.order.long()),
                       torch.sort(i0, dim=1).values)
    stj = jski.build_ski(jk, kp, kb, jnp.asarray(x), M)
    assert _rel(st.tfrac, stj.tfrac) <= 1e-5
    with pytest.raises(ValueError, match="plan"):
        ski.build_ski(tk, kpt, kbt, xt, M, plan="banded")


def test_to_torch_carries_a_sorted_state():
    """to_torch of a sorted JAX SKIState: every field, the int32 ones as
    int32; a dense JAX state's sorted fields stay None."""
    stj, st = _state_pair()
    for f in st._fields:
        a, b = getattr(st, f), np.asarray(getattr(stj, f))
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
        assert a.dtype == (torch.int32 if b.dtype == np.int32
                           else torch.float32), f
    jk, _ = _specs("dense")
    kp, kb, x = _data()
    dj = to_torch(jax.device_get(jski.build_ski(jk, kp, kb, jnp.asarray(x),
                                                M)), device="cpu")
    assert all(getattr(dj, f) is None
               for f in ("i0", "w4", "order", "w4_sorted", "bounds"))


# ---------------------------------------------------- the operator pair ----


@pytest.mark.parametrize("grouped", [False, True], ids=["one", "groups"])
@pytest.mark.parametrize("t", [1, 3, 5])
def test_interp_pair_values_and_gradients(t, grouped, monkeypatch):
    """interp_transpose and interp_apply, values and the gradient of each
    through the other (the custom_vjp pair): t = 1, 3 take the clipped
    per-tap gather, t = 5 the rolled (g, 4t, m) table; `groups` patches the
    budget in both packages so the components run in groups of 3 and 1."""
    if grouped:
        budget = 3 * N * 4 * t
        monkeypatch.setattr(jski, "_GROUP_BUDGET_ELEMS", budget)
        monkeypatch.setattr(ski, "_GROUP_BUDGET_ELEMS", budget)
        assert ski._component_group_size(J, N, t) == 3
    stj, st = _state_pair()
    rng = np.random.default_rng(t)
    V = rng.standard_normal((N, t)).astype(np.float32)
    G = rng.standard_normal((J, t, M)).astype(np.float32)
    Wu = rng.standard_normal((J, t, M)).astype(np.float32)
    Wa = rng.standard_normal((J, t, N)).astype(np.float32)

    uj, gvj = jax.jit(jax.value_and_grad(lambda v: jnp.sum(
        jski.interp_transpose(stj, v) * Wu)))(jnp.asarray(V))
    aj, ggj = jax.jit(jax.value_and_grad(lambda g: jnp.sum(
        jski.interp_apply(stj, g) * Wa)))(jnp.asarray(G))
    Vt, Gt = torch.tensor(V, requires_grad=True), torch.tensor(
        G, requires_grad=True)
    U, A = ski.interp_transpose(st, Vt), ski.interp_apply(st, Gt)
    assert U.shape == (J, t, M) and A.shape == (J, t, N)
    assert _rel(U.detach(), jski.interp_transpose(stj, jnp.asarray(V))) <= 1e-5
    assert _rel(A.detach(), jski.interp_apply(stj, jnp.asarray(G))) <= 1e-5
    (torch.sum(U * torch.tensor(Wu)) + torch.sum(A * torch.tensor(Wa))
     ).backward()
    assert _rel(Vt.grad, gvj) <= 1e-4
    assert _rel(Gt.grad, ggj) <= 1e-4
    assert _rel(float(torch.sum(U.detach() * torch.tensor(Wu))),
                float(uj)) <= 1e-5
    assert _rel(float(torch.sum(A.detach() * torch.tensor(Wa))),
                float(aj)) <= 1e-5


def test_interp_pair_is_adjoint():
    """<W^T V, G> == <V, sum_j W_j G_j> on the port's sorted plan."""
    _, st = _state_pair()
    rng = np.random.default_rng(4)
    V = torch.tensor(rng.standard_normal((N, 6)).astype(np.float32))
    G = torch.tensor(rng.standard_normal((J, 6, M)).astype(np.float32))
    lhs = float(torch.sum(ski.interp_transpose(st, V).double() * G))
    rhs = float(torch.sum(V.double() * ski.interp_apply(st, G).sum(0).T))
    assert abs(lhs - rhs) <= 1e-4 * abs(rhs)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("bases", ["rbf", "mixed"])
def test_ski_mvm_sorted_value_and_gradient(bases, cross):
    """ski_mvm on sorted states (W^T, the Toeplitz FFT product, the
    per-component apply contracted with the scales), value and gradient to
    the kernel params and to V; the cross MVM puts test and train points on
    one grid."""
    base_list = (("rbf",) * J if bases == "rbf"
                 else ("rbf", "matern32", "rbf", "matern12"))
    jk, tk = _specs(bases=base_list)
    kp, kb, x = _data()
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((150, D)).astype(np.float32)
    z = np.concatenate([x, xs]) @ kb["proj"]
    zb = (z.min(0), z.max(0))
    stj_r, st_r = _state_pair(x, zb)
    stj, st = _state_pair(xs, zb) if cross else (stj_r, st_r)
    n_out = stj.tfrac.shape[1]
    V = rng.standard_normal((N, 3)).astype(np.float32)
    W = rng.standard_normal((n_out, 3)).astype(np.float32)

    def jloss(kp_, v):
        return jnp.sum(jski.ski_mvm(jk, kp_, stj, v, state_rhs=stj_r) * W)

    vj, (gkj, gvj) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        kp, jnp.asarray(V))
    kpt = to_torch(kp, device="cpu")
    for t in kpt.values():
        t.requires_grad_(True)
    Vt = torch.tensor(V, requires_grad=True)
    out = ski.ski_mvm(tk, kpt, st, Vt, state_rhs=st_r)
    assert out.shape == (n_out, 3)
    assert _rel(out.detach(), jski.ski_mvm(jk, kp, stj, jnp.asarray(V),
                                           state_rhs=stj_r)) <= 1e-5
    loss = torch.sum(out * torch.tensor(W))
    loss.backward()
    assert _rel(float(loss.detach()), float(vj)) <= 1e-5
    assert _grad_relerr(to_numpy({k: t.grad for k, t in kpt.items()}),
                        jax.device_get(gkj)) <= 1e-4
    assert _rel(Vt.grad, gvj) <= 1e-4


def test_ski_gram_diag_reads_the_sorted_taps():
    """diag(K_ski) on a sorted state (its w4) matches the JAX package's and
    the port's dense-state diagonal (taps from tfrac)."""
    jk, tk = _specs()
    kp, kb, x = _data()
    stj, st = _state_pair()
    kpt = to_torch(kp, device="cpu")
    d = ski.ski_gram_diag(tk, kpt, st)
    assert _rel(d, jski.ski_gram_diag(jk, kp, stj, N)) <= 1e-5
    dense = st._replace(i0=None, w4=None, order=None, w4_sorted=None,
                        bounds=None)
    assert _rel(d, ski.ski_gram_diag(tk, kpt, dense)) <= 1e-6


# ------------------------------------------- sorted against dense ----


def test_sorted_plan_matches_dense_plan():
    """The port's two plans on one x (tests/test_ski.py's bar, 2e-4): both
    directions, the adjoint identity, and ski_mvm's value and kernel-param
    gradient."""
    _, tk = _specs()
    kp, kb, x = _data()
    kpt, kbt = to_torch(kp, device="cpu"), to_torch(kb, device="cpu")
    xt = torch.tensor(x)
    st_s = ski.build_ski(tk, kpt, kbt, xt, M, plan="sorted")
    st_d = ski.build_ski(tk, kpt, kbt, xt, M, plan="dense")
    rng = np.random.default_rng(20)
    V = torch.tensor(rng.standard_normal((N, 3)).astype(np.float32))
    G = torch.tensor(rng.standard_normal((J, 3, M)).astype(np.float32))
    np.testing.assert_allclose(ski.dense_interp_transpose(st_d, V).numpy(),
                               ski.interp_transpose(st_s, V).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ski.dense_interp_apply_sum(st_d, G).numpy(),
                               ski.interp_apply(st_s, G).sum(0).T.numpy(),
                               rtol=2e-4, atol=2e-4)

    def value_and_grad(st):
        p = {k: t.clone().requires_grad_(True) for k, t in kpt.items()}
        v = torch.sum(ski.ski_mvm(tk, p, st, V[:, :2]) * V[:, :2])
        v.backward()
        return float(v), {k: t.grad.numpy() for k, t in p.items()}

    (v_s, g_s), (v_d, g_d) = value_and_grad(st_s), value_and_grad(st_d)
    np.testing.assert_allclose(v_d, v_s, rtol=1e-4)
    for k in g_s:
        np.testing.assert_allclose(g_d[k], g_s[k], rtol=2e-3, atol=2e-4,
                                   err_msg=k)


# ----------------------------------------------- the slice as a whole ----


def test_ski_iterative_mll_on_a_sorted_state_matches():
    """The SKI + BBMM MLL with interp "sorted": prepare_buffers keeps the
    sorted geometry, and CG + SLQ on ski_mvm's sorted branch gives the JAX
    package's value and gradients on the same probe normals."""
    kw = dict(max_cholesky_size=64, cg_max_iters=30, cg_tol=1e-2,
              precond_rank=8, num_probes=5)
    jk, tk = _specs()
    jspec, spec = JModelSpec(kernel=jk, **kw), ModelSpec(kernel=tk, **kw)
    params, buffers = jax.device_get(jgp.init_model(jax.random.key(0), jspec,
                                                    D))
    rng = np.random.default_rng(6)
    params = dict(params, raw_noise=np.float32(0.0),
                  mean_const=np.float32(0.1),
                  kernel=dict(params["kernel"], raw_lengthscale=(
                      0.3 * rng.standard_normal(J)).astype(np.float32)))
    n = 400
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.sin(x @ rng.standard_normal(D) / 2.0)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    es = rng.standard_normal((8, 5)).astype(np.float32)
    eb = rng.standard_normal((n, 5)).astype(np.float32)
    jb = jgp.prepare_buffers(jspec, params, buffers, jnp.asarray(x))
    b = exact_gp.prepare_buffers(spec, to_torch(params, device="cpu"),
                                 to_torch(buffers, device="cpu"),
                                 torch.tensor(x), y_train=torch.tensor(y))
    assert b["ski_state"].order is not None
    iql = jiter._make_inv_quad_logdet(jspec)

    def jloss(p):
        iq, ld = iql(p, jb, jnp.asarray(x), jnp.asarray(y), jnp.asarray(es),
                     jnp.asarray(eb))
        return -0.5 * (iq + ld + n * LOG_2PI)

    vj, gj = jax.jit(jax.value_and_grad(jloss))(params)
    p = to_torch(params, device="cpu")
    leaves = {"raw_noise": p["raw_noise"], "mean_const": p["mean_const"],
              **{f"kernel.{k}": t for k, t in p["kernel"].items()}}
    for t in leaves.values():
        t.requires_grad_(True)
    iq, ld = iterative.inv_quad_logdet_eps(
        spec, p, b, torch.tensor(x), torch.tensor(y), torch.tensor(es),
        torch.tensor(eb))
    v = -0.5 * (iq + ld + n * LOG_2PI)
    v.backward()
    g = {"raw_noise": p["raw_noise"].grad, "mean_const": p["mean_const"].grad,
         "kernel": {k: t.grad for k, t in p["kernel"].items()}}
    assert _rel(float(v.detach()), float(vj)) <= 1e-4
    assert _grad_relerr(to_numpy(g), jax.device_get(gj)) <= 1e-3
    # the same model on the dense plan: the SKI approximation is the same
    spec_d = dataclasses.replace(spec, kernel=dataclasses.replace(
        tk, interp="dense"))
    bd = exact_gp.prepare_buffers(spec_d, to_torch(params, device="cpu"),
                                  to_torch(buffers, device="cpu"),
                                  torch.tensor(x), y_train=torch.tensor(y))
    with torch.no_grad():
        iq_d, ld_d = iterative.inv_quad_logdet_eps(
            spec_d, to_torch(params, device="cpu"), bd, torch.tensor(x),
            torch.tensor(y), torch.tensor(es), torch.tensor(eb))
    vd = float(-0.5 * (iq_d + ld_d + n * LOG_2PI))
    assert _rel(vd, float(v.detach())) <= 1e-4
