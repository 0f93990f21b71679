"""The trainer's CUDA graph of the dense step (train._GraphedStep).

On the CPU: mll.observe_routes reports the branch each mll call took; the
trainer graphs only the dense Cholesky route on the card with no probe
generator and no args_refresh (train._graphable), so on the CPU it
replays nothing and its losses are those of the eager loop;
profiling.Captured sets aside what a capture records and emits it again
at each replay, the op records only while a profiler records.

The materialized Gram gathers its groups' coordinates by slices, with no
index list sent to the device (kernels._take), which a graph could not
hold.

On the card (marked `cuda`, skipped without one): a graphed dense call
against an eager call of the same seed, bit for bit, on K6 / K7 and on a
materialized Gram; its re-emitted K1, K6 and K7 records and launch counts
against the eager call's; and three calls in a row leave no memory
behind.
"""

import importlib
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rpagp_torch import train
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import cuda_chol, cuda_gram, cuda_interp, kernels
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import profiling
from rpagp_torch.utils.config import TrainConfig

# the module: the package's `mll` is the function
mll_mod = importlib.import_module("rpagp_torch.mll")
torch.set_num_threads(2)
D = 3


def _data(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, D, generator=g)
    return x, torch.sin(x.sum(1)) + 0.1 * torch.randn(n, generator=g)


def _dense_spec(J):
    return ModelSpec(kernel=KernelSpec.generalized(
        [1] * J, ["rbf"] * J, proj_dist="gaussian"))


# ------------------------------------------------------- on the CPU ----


def _route(spec, n, generator=None):
    """The routes mll.mll reports for one call at n points."""
    x, y = _data(n)
    params, buffers = exact_gp.init_model(
        spec, D, generator=torch.Generator().manual_seed(1), device="cpu")
    buffers = exact_gp.prepare_buffers(spec, params, buffers, x, y_train=y)
    with mll_mod.observe_routes() as seen:
        loss = mll_mod.mll(spec, params, buffers, x, y, generator)
    assert torch.isfinite(loss)
    return seen


def test_mll_reports_each_route():
    J = 2
    kspec = lambda **kw: KernelSpec.generalized([1] * J, ["rbf"] * J,
                                                proj_dist="gaussian", **kw)
    assert _route(_dense_spec(J), 80) == ["exact"]
    grid = ModelSpec(kernel=kspec(ski=True, grid_size=16), solver="grid")
    assert _route(grid, 200) == ["grid"]
    bbmm = ModelSpec(kernel=kspec(), max_cholesky_size=64, cg_max_iters=5,
                     precond_rank=3, num_probes=2)
    assert _route(bbmm, 100, torch.Generator().manual_seed(2)) == [
        "iterative"]


def test_observe_routes_nests_and_closes():
    spec = _dense_spec(2)
    x, y = _data(40)
    params, buffers = exact_gp.init_model(spec, D, device="cpu",
                                          generator=torch.Generator())
    with mll_mod.observe_routes() as outer:
        with mll_mod.observe_routes() as inner:
            mll_mod.mll(spec, params, buffers, x, y)
        mll_mod.mll(spec, params, buffers, x, y)
    assert inner == ["exact"] and outer == ["exact", "exact"]
    assert mll_mod._observers == []
    # a call outside every block reports to no one
    mll_mod.mll(spec, params, buffers, x, y)
    assert outer == ["exact", "exact"]


@pytest.mark.parametrize("routes, cuda, generator, refresh, want", [
    (["exact"], True, None, None, True),
    (["exact", "exact"], True, None, None, True),
    (["exact"], False, None, None, False),
    (["exact"], True, torch.Generator(), None, False),
    (["exact"], True, None, (10, lambda p, a: a), False),
    (["exact", "grid"], True, None, None, False),
    (["grid"], True, None, None, False),
    (["iterative"], True, None, None, False),
    ([], True, None, None, False),  # a loss that calls no mll
    (None, True, None, None, False),
])
def test_the_trainer_graphs_only_the_dense_route_on_the_card(
        routes, cuda, generator, refresh, want):
    leaves = [SimpleNamespace(is_cuda=cuda), SimpleNamespace(is_cuda=True)]
    assert train._graphable(routes, leaves, generator, refresh) is want


# a kernel whose Gram is materialized (degrees above 1, two bases): its
# groups are no runs of components, and degrees above 1 take products
MIXED = ModelSpec(kernel=KernelSpec.generalized(
    [1, 2, 1, 3], ["rbf", "matern52", "rbf", "matern32"],
    proj_dist="gaussian"))


def _dense_call(n, steps, via_mll=True, device="cpu", grad_hook=None,
                J=3, spec=None):
    """A train_to_convergence call on the dense route: its loss through
    mll.mll (which reports the route), or with via_mll=False through
    exact_gp.exact_mll directly (the same work, reported by no one)."""
    spec = spec or _dense_spec(J)
    x, y = _data(n, seed=5)
    params, buffers = exact_gp.init_model(
        spec, D, generator=torch.Generator().manual_seed(6), device=device)
    fn = mll_mod.mll if via_mll else exact_gp.exact_mll
    return train.train_to_convergence(
        lambda p, b, xx, yy: -fn(spec, p, b, xx, yy) / n, params,
        TrainConfig(lr=0.05, max_iters=steps, patience=steps),
        loss_args=(buffers, x.to(device), y.to(device)), sync_every=4,
        grad_hook=grad_hook)


def test_no_graph_on_the_cpu_and_the_same_losses():
    res = _dense_call(600, 5)
    ref = _dense_call(600, 5, via_mll=False)
    assert res.replays == 0 and ref.replays == 0
    assert res.iterations == 5 and res.losses == ref.losses
    for a, b in zip(train._leaves(res.params), train._leaves(ref.params)):
        assert torch.equal(a, b)


def test_bbmm_calls_replay_nothing():
    """A generator (and args_refresh) keeps the BBMM loop eager."""
    spec = ModelSpec(kernel=KernelSpec.generalized(
        [1] * 2, ["rbf"] * 2, proj_dist="gaussian"), max_cholesky_size=64,
        cg_max_iters=5, precond_rank=3, num_probes=2, precond_refresh=2)
    x, y = _data(100)
    params, buffers = exact_gp.init_model(
        spec, D, generator=torch.Generator().manual_seed(1), device="cpu")
    buffers = exact_gp.prepare_buffers(spec, params, buffers, x, y_train=y)
    refresh = (2, lambda p, a: (
        exact_gp.refresh_preconditioner(spec, p, a[0], a[1]),) + a[1:])
    res = train.train_to_convergence(
        lambda p, b, xx, yy, g: -mll_mod.mll(spec, p, b, xx, yy, g) / 100,
        params, TrainConfig(lr=0.05, max_iters=4, patience=4),
        loss_args=(buffers, x, y), generator=torch.Generator().manual_seed(3),
        args_refresh=refresh)
    assert res.replays == 0 and res.refreshes == 1 and res.iterations == 4


@pytest.mark.parametrize("idx", [(2, 3, 4), (0, 2, 3, 5), (5, 1), (4,)])
def test_take_gathers_by_slices(idx):
    t = torch.arange(24.0).reshape(6, 4)
    got = kernels._take(t, idx)
    assert torch.equal(got, t[list(idx)])
    if len(idx) == 1 or idx == (2, 3, 4):
        assert got.data_ptr() == t[idx[0]].data_ptr()  # one run: a view


def _captured_dense_gram():
    """A Captured block around one K6 call on the CPU (its plain twin):
    its record is set aside and its launch count, bumped by hand as the
    card's wrapper does, taken back."""
    counters = {"dense_gram": 3}
    u = torch.randn(2, 5)
    with profiling.Captured([counters]) as work:
        cuda_gram.dense_gram_fwd(u, u, torch.ones(2))
        counters["dense_gram"] += 1
    return counters, work


def test_captured_sets_aside_records_with_or_without_a_profiler():
    profiling.take_records()
    counters, work = _captured_dense_gram()
    assert counters == {"dense_gram": 3}
    assert work.records == [("rpagp.op.dense_gram", 2, 5, 5, "fwd")]
    assert work.launches == [{"dense_gram": 1}]
    assert profiling.take_records() == [] and not profiling._capturing
    with profile(activities=[ProfilerActivity.CPU]):
        counters, work2 = _captured_dense_gram()
        assert profiling._records == []
    assert work2.records == work.records and counters == {"dense_gram": 3}
    profiling.take_records()
    profiling.take_counts()


def test_replayed_emits_records_only_while_a_profiler_records():
    profiling.take_records()
    counters, work = _captured_dense_gram()
    work.replayed()
    work.replayed()
    assert counters == {"dense_gram": 5}
    assert profiling.take_records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        work.replayed()
    assert counters == {"dense_gram": 6}
    assert profiling.take_records() == work.records
    profiling.take_counts()


# ------------------------------------------------------ on the card ----

CARD_N, CARD_J, CARD_STEPS = 900, 4, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph replays on the card")
    return torch.device("cuda")


class _Step0Grad:
    """grad_hook that keeps step 0's gradients."""

    def __init__(self):
        self.grads = None

    def __call__(self, leaves):
        if self.grads is None:
            self.grads = [t.grad.detach().clone() for t in leaves]


def _card_call(via_mll, hook=None, spec=None):
    return _dense_call(CARD_N, CARD_STEPS, via_mll=via_mll, device="cuda",
                       grad_hook=hook, J=CARD_J, spec=spec)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [None, MIXED], ids=["k6k7", "mixed"])
def test_graphed_call_matches_the_eager_call_bit_for_bit(cuda_device, spec):
    hg, he = _Step0Grad(), _Step0Grad()
    graphed = _card_call(True, hg, spec)
    eager = _card_call(False, he, spec)
    assert graphed.replays == CARD_STEPS - 1 and eager.replays == 0
    assert graphed.losses == eager.losses
    for a, b in zip(hg.grads + train._leaves(graphed.params),
                    he.grads + train._leaves(eager.params)):
        assert torch.equal(a, b)


def _launches():
    return {**cuda_chol.launches, **cuda_gram.launches,
            **cuda_interp.launches}


def _profiled_card_call(via_mll):
    """(op records, launch counts) of one card call under the profiler."""
    profiling.take_records()
    profiling.take_counts()
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = _card_call(via_mll)
        torch.cuda.synchronize()
    counts = profiling.take_counts()
    after = _launches()
    return (res, profiling.take_records(), counts,
            {k: after[k] - before[k] for k in after})


@pytest.mark.cuda
def test_replays_emit_the_eager_steps_records_and_launches(cuda_device):
    res, recs, counts, launches = _profiled_card_call(True)
    _, eager_recs, eager_counts, eager_launches = _profiled_card_call(False)
    assert res.replays == CARD_STEPS - 1
    step = [("rpagp.op.dense_gram", CARD_J, CARD_N, CARD_N, "fwd"),
            ("rpagp.op.chol_linv", 1, 512), ("rpagp.op.chol_linv", 1, 512),
            ("rpagp.op.dense_gram", CARD_J, CARD_N, CARD_N, "bwd")]
    assert eager_recs == step * CARD_STEPS
    assert recs == eager_recs and launches == eager_launches
    assert launches["chol_linv"] == 2 * CARD_STEPS
    assert launches["dense_gram"] == launches["dense_gram_bwd"] == CARD_STEPS
    assert counts["rpagp.train.replay"] == CARD_STEPS - 1
    assert eager_counts["rpagp.train.replay"] == 0
    assert counts["rpagp.train.step"] == CARD_STEPS


@pytest.mark.cuda
def test_calls_in_a_row_leave_no_memory_behind(cuda_device):
    def replays():
        res = _card_call(True)
        torch.cuda.synchronize()
        return res.replays

    assert replays() == CARD_STEPS - 1
    held = torch.cuda.memory_allocated()
    for _ in range(3):
        assert replays() == CARD_STEPS - 1
        assert torch.cuda.memory_allocated() <= held
