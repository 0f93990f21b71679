"""rpagp_torch's checkpoints (utils/checkpoint.py) and
train.train_with_checkpointing, on the CPU: the save / load round trip
and keep-last-k rotation, the structure-mismatch rejection
(tests/test_love_checkpoint.py), a resumed run against an uninterrupted
one for a deterministic loss and for one that draws from a
torch.Generator, patience carried across a resume (tests/test_resume.py),
and the losses of the JAX package's train_with_checkpointing on the same
exact-MLL problem.

Tolerances: a resume equals the uninterrupted run bit for bit (the same
float32 steps on the same restored state); against the JAX package the
losses and the returned params rel <= 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.models import exact_gp as jgp
from rpagp.models.exact_gp import ModelSpec as JModelSpec
from rpagp.ops.kernels import KernelSpec as JKernelSpec
from rpagp.train import train_with_checkpointing as jtrain_ckpt
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.train import train_with_checkpointing
from rpagp_torch.utils import checkpoint as ckpt
from rpagp_torch.utils.convert import to_numpy, to_torch

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _problem(n=40, D=3):
    """The exact-MLL problem of tests/test_resume.py: both packages'
    specs, the JAX package's initial params and buffers (numpy), data."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(
        np.float32)
    jspec = JModelSpec(kernel=JKernelSpec.polynomial(J=3, d=1))
    spec = ModelSpec(kernel=KernelSpec.polynomial(J=3, d=1))
    params, buffers = jax.device_get(jgp.init_model(jax.random.key(0), jspec,
                                                    D))
    return jspec, spec, params, buffers, x, y


def _port_loss(spec, n, scale=1.0):
    return lambda p, b, xx, yy: -exact_gp.exact_mll(spec, p, b, xx, yy) \
        * scale / n


def _port_args(params, buffers, x, y):
    return (to_torch(params, device="cpu"),
            (to_torch(buffers, device="cpu"), torch.tensor(x),
             torch.tensor(y)))


def _flat(params):
    return np.concatenate([np.ravel(v) for v in jax.tree.leaves(
        to_numpy(params))])


def _state(params, buffers):
    p = to_torch(params, device="cpu")
    opt = torch.optim.Adam(list(p["kernel"].values()), lr=0.1)
    for t in opt.param_groups[0]["params"]:
        t.grad = torch.ones_like(t)
    opt.step()  # Adam's moments and step are set
    st = opt.state[opt.param_groups[0]["params"][0]]
    return {"params": p, "buffers": to_torch(buffers, device="cpu"),
            "opt_state": {"exp_avg": st["exp_avg"],
                          "exp_avg_sq": st["exp_avg_sq"],
                          "step": st["step"]},
            "generator": torch.Generator().manual_seed(7).get_state(),
            "step": torch.tensor(123)}


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    """Every leaf round-trips exactly, dtype and device too, the
    projection among them; keep = 2 leaves the newest two of five."""
    *_, params, buffers, _, _ = _problem()
    state = _state(params, buffers)
    path = str(tmp_path / "ckpt_test")
    ckpt.save_checkpoint(path, state)
    loaded = ckpt.load_checkpoint(path, state)
    fa, fb = ckpt._flatten(state), ckpt._flatten(loaded)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, a), (_, b) in zip(fa, fb):
        assert a.dtype == b.dtype and a.device == b.device, p
        assert torch.equal(a, b), p
    assert torch.equal(loaded["buffers"]["kernel"]["proj"],
                       state["buffers"]["kernel"]["proj"])
    g = torch.Generator()
    g.set_state(loaded["generator"])
    assert torch.equal(torch.randn(4, generator=g),
                       torch.randn(4, generator=torch.Generator()
                                   .manual_seed(7)))

    cp = ckpt.Checkpointer(str(tmp_path), every=10, keep=2)
    for step in range(0, 50, 10):
        cp.maybe_save(step, state)
    assert cp.maybe_save(15, state) is None
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_00000030.npz", "ckpt_00000040.npz",
                     "ckpt_test.npz"]
    assert cp.latest() == str(tmp_path / "ckpt_00000040")
    # a fresh Checkpointer finds the newest on disk
    assert ckpt.Checkpointer(str(tmp_path)).latest() == str(
        tmp_path / "ckpt_test")


def test_checkpoint_rejects_structure_mismatch(tmp_path):
    state = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    path = str(tmp_path / "ckpt_mismatch")
    ckpt.save_checkpoint(path, state)
    # same leaf count, another structure: raise, never scramble
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_checkpoint(path, {"a": torch.ones(3),
                                    "x": {"y": torch.zeros(2)}})
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_checkpoint(path, {"a": torch.ones(4),
                                    "b": {"c": torch.zeros(2)}})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_checkpoint(path, {"a": torch.ones(3)})


def _noisy_loss(spec, n):
    """The exact MLL plus a term drawn from the generator every step."""
    def loss(p, b, xx, yy, gen):
        e = torch.randn(3, generator=gen)
        return (-exact_gp.exact_mll(spec, p, b, xx, yy) / n
                + 0.01 * torch.sum(e * p["kernel"]["raw_lengthscale"]))
    return loss


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["deterministic", "generator"])
def test_resume_matches_uninterrupted_run(tmp_path, stochastic):
    """30 steps in one call against 20 then a resume to 30 (checkpoints
    every 10): the same losses and params bit for bit; the resumed call
    counts 10 iterations and returns all 30 losses. With a generator the
    resumed call is handed a generator of another seed, and the
    checkpoint's state replaces it."""
    _, spec, params, buffers, x, y = _problem()
    p0, args = _port_args(params, buffers, x, y)
    loss = _noisy_loss(spec, 40) if stochastic else _port_loss(spec, 40)

    def gen(seed=3):
        return torch.Generator().manual_seed(seed) if stochastic else None

    full = train_with_checkpointing(loss, p0, str(tmp_path / "a"),
                                    max_iters=30, checkpoint_every=10,
                                    loss_args=args, generator=gen())
    ckdir = str(tmp_path / "b")
    part = train_with_checkpointing(loss, p0, ckdir, max_iters=20,
                                    checkpoint_every=10, loss_args=args,
                                    generator=gen())
    resumed = train_with_checkpointing(loss, p0, ckdir, max_iters=30,
                                       checkpoint_every=10, loss_args=args,
                                       generator=gen(99))
    assert part.iterations == 20 and resumed.iterations == 10
    assert len(resumed.losses) == 30
    assert resumed.losses[:20] == part.losses
    assert resumed.losses == full.losses
    assert np.array_equal(_flat(resumed.params), _flat(full.params))
    assert resumed.best_loss == full.best_loss


def test_resume_restores_adam_and_generator(tmp_path):
    """The checkpoint's Adam exp_avg / exp_avg_sq / step and generator
    state are the live ones of the step it was written at."""
    _, spec, params, buffers, x, y = _problem()
    p0, args = _port_args(params, buffers, x, y)
    g = torch.Generator().manual_seed(3)
    train_with_checkpointing(_noisy_loss(spec, 40), p0, str(tmp_path),
                             max_iters=10, checkpoint_every=10,
                             loss_args=args, generator=g)
    path = ckpt.Checkpointer(str(tmp_path)).latest()
    saved = ckpt.load_checkpoint(path, _like_for(p0, g))
    assert int(saved["step"]) == 10
    assert torch.equal(saved["generator"], g.get_state())
    assert all(float(s) == 10.0 for s in
               jax.tree.leaves(to_numpy(saved["opt_state"]["step"])))
    assert all(float(np.abs(v).max()) > 0 for v in
               jax.tree.leaves(to_numpy(saved["opt_state"]["exp_avg_sq"])))


def _like_for(params, g):
    """A `like` of train_with_checkpointing's checkpoint layout."""
    z = {k: (torch.zeros_like(v) if not isinstance(v, dict)
             else {kk: torch.zeros_like(vv) for kk, vv in v.items()})
         for k, v in params.items()}
    steps = {k: (torch.tensor(0.0) if not isinstance(v, dict)
                 else {kk: torch.tensor(0.0) for kk in v})
             for k, v in params.items()}
    return {"params": z, "best_params": z,
            "opt_state": {"exp_avg": z, "exp_avg_sq": z, "step": steps},
            "generator": g.get_state(), "step": torch.tensor(0),
            "best": torch.tensor(0.0, dtype=torch.float64),
            "bad": torch.tensor(0),
            "ema": torch.tensor(0.0, dtype=torch.float64)}


def test_patience_continues_across_resume(tmp_path):
    """Patience stopping as train_to_convergence's, and a resumed run keeps
    the bad-step count: 10 steps of a flat objective, then a resume with
    patience 12 stops 2-3 steps in, not 12."""
    _, spec, params, buffers, x, y = _problem()
    p0, args = _port_args(params, buffers, x, y)
    res = train_with_checkpointing(_port_loss(spec, 40), p0,
                                   str(tmp_path / "a"), max_iters=500,
                                   patience=5, rel_tol=1e-3,
                                   checkpoint_every=10, loss_args=args)
    assert res.converged and res.iterations < 500
    assert min(res.losses) <= res.losses[-1] + 1e-12
    ckdir = str(tmp_path / "b")
    flat = _port_loss(spec, 40, scale=0.0)
    train_with_checkpointing(flat, p0, ckdir, max_iters=10, patience=12,
                             rel_tol=1e-3, checkpoint_every=5,
                             loss_args=args)
    resumed = train_with_checkpointing(flat, p0, ckdir, max_iters=100,
                                       patience=12, rel_tol=1e-3,
                                       checkpoint_every=5, loss_args=args)
    assert resumed.converged
    assert resumed.iterations <= 6


def test_losses_match_the_jax_package(tmp_path):
    """train_with_checkpointing on the same exact-MLL problem in both
    packages, 20 steps then a resume to 30: losses and params rel <= 1e-5."""
    jspec, spec, params, buffers, x, y = _problem()
    jloss = lambda p, b, xx, yy: -jgp.exact_mll(jspec, p, b, xx, yy) / 40
    jargs = (buffers, jnp.asarray(x), jnp.asarray(y))
    p0, args = _port_args(params, buffers, x, y)
    outs = []
    for name, fn, loss, p, a in (
            ("jax", jtrain_ckpt, jloss, params, jargs),
            ("port", train_with_checkpointing, _port_loss(spec, 40), p0,
             args)):
        d = str(tmp_path / name)
        fn(loss, p, d, max_iters=20, checkpoint_every=10, loss_args=a)
        outs.append(fn(loss, p, d, max_iters=30, checkpoint_every=10,
                       loss_args=a))
    rj, rt = outs
    assert len(rt.losses) == len(rj.losses) == 30
    assert rt.iterations == rj.iterations == 10
    assert _rel(rt.losses, rj.losses) <= 1e-5
    assert _rel(_flat(rt.params), np.concatenate(
        [np.ravel(v) for v in jax.tree.leaves(jax.device_get(rj.params))])) \
        <= 1e-5
