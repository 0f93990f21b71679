"""rpagp_torch's spans and op records (utils/profiling.py), on the CPU: a
9-step SKI + BBMM training call under torch.profiler emits every span of
the training path, nested as the layers nest, with one `rpagp.sync` for
each device->host read; the K2 / K3 dispatchers record every call's
(J, n, t, m); with no profiler nothing is recorded and span() is one
shared no-op; the profiler changes no loss and no parameter. Also
gpbench/spans.py on a hand-built trace, and the K3 count."""

import json
import os
import sys

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from rpagp_torch import train
from rpagp_torch.mll import mll as mll_fn
from rpagp_torch.models import exact_gp
from rpagp_torch.models.exact_gp import ModelSpec
from rpagp_torch.ops import cuda_interp
from rpagp_torch.ops.kernels import KernelSpec
from rpagp_torch.utils import profiling
from rpagp_torch.utils.config import TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpbench import spans as gp_spans  # noqa: E402
from gpbench import trace as gp_trace  # noqa: E402

torch.set_num_threads(2)
N, D, J, M, STEPS, CG = 400, 3, 3, 32, 9, 6
TRAIN_SPANS = {"rpagp.train.step", "rpagp.train.refresh", "rpagp.train.loss",
               "rpagp.train.backward", "rpagp.train.update", "rpagp.sync",
               "rpagp.bbmm.cg", "rpagp.bbmm.operator", "rpagp.bbmm.slq",
               "rpagp.bbmm.backward", "rpagp.precond.apply",
               "rpagp.precond.build", "rpagp.op.interp_transpose",
               "rpagp.op.interp_apply_sum", "rpagp.op.toeplitz"}


def _train():
    """A 9-step SKI + BBMM train_to_convergence call (sync_every 8, the
    preconditioner refreshed every 3 steps); returns its TrainResult."""
    kspec = KernelSpec.generalized([1] * J, ["rbf"] * J,
                                   proj_dist="gaussian", ski=True,
                                   grid_size=M)
    spec = ModelSpec(kernel=kspec, max_cholesky_size=64, cg_max_iters=CG,
                     precond_rank=4, num_probes=3, precond_refresh=3,
                     solver="bbmm")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(N, D, generator=g)
    y = torch.sin(x.sum(1)) + 0.1 * torch.randn(N, generator=g)
    params, buffers = exact_gp.init_model(spec, D, generator=g, device="cpu")
    buffers = exact_gp.prepare_buffers(spec, params, buffers, x, y_train=y)
    refresh = (3, lambda p, a: (
        exact_gp.refresh_preconditioner(spec, p, a[0], a[1]),) + a[1:])
    return train.train_to_convergence(
        lambda p, b, xx, yy, gen: -mll_fn(spec, p, b, xx, yy, gen) / N,
        params, TrainConfig(lr=0.05, max_iters=STEPS, patience=STEPS),
        loss_args=(buffers, x, y), sync_every=8,
        generator=torch.Generator().manual_seed(4), args_refresh=refresh)


def _profiled(tmp_path):
    """(TrainResult, the rpagp span events, the op records, the span
    counts) of one profiled call."""
    profiling.take_records()
    profiling.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _train()
    recs, counts = profiling.take_records(), profiling.take_counts()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ev = [e for e in events if e.get("cat") == "user_annotation"
          and e.get("name", "").startswith("rpagp.")]
    return res, ev, recs, counts


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    return _profiled(tmp_path_factory.mktemp("tr"))


def _inside(ev, outer_name, events):
    """Is ev inside an event named outer_name on its own thread?"""
    s, e = ev["ts"], ev["ts"] + ev["dur"]
    return any(o["name"] == outer_name and o["tid"] == ev["tid"]
               and o["ts"] <= s and e <= o["ts"] + o["dur"]
               for o in events if o is not ev)


def test_the_profiler_flag_is_where_span_reads_it():
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(profiling.span("rpagp.sync"),
                          torch.profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False
    profiling.take_records()
    profiling.take_counts()


def test_training_emits_every_span_nested(profiled):
    _, ev, _, _ = profiled
    names = {e["name"] for e in ev}
    assert names == TRAIN_SPANS
    assert names <= {name for name, _ in profiling.SPANS}
    count = lambda n: sum(e["name"] == n for e in ev)
    for n in ("rpagp.train.step", "rpagp.train.loss", "rpagp.train.backward",
              "rpagp.train.update", "rpagp.bbmm.cg", "rpagp.bbmm.slq",
              "rpagp.bbmm.backward"):
        assert count(n) == STEPS, n
    assert count("rpagp.train.refresh") == 2  # before steps 3 and 6
    assert count("rpagp.precond.build") == 5  # steps 0-2 fresh, 2 refreshes
    assert count("rpagp.bbmm.operator") == STEPS * CG
    # CG's iterations and its start, and m_i = M^{-1} z_i after it
    assert count("rpagp.precond.apply") == STEPS * (CG + 2)
    for e in ev:
        n = e["name"]
        if n.startswith("rpagp.train.") and n != "rpagp.train.step":
            assert _inside(e, "rpagp.train.step", ev), n
        if n == "rpagp.bbmm.operator":
            assert _inside(e, "rpagp.bbmm.cg", ev)
    in_cg = sum(_inside(e, "rpagp.bbmm.cg", ev) for e in ev
                if e["name"] == "rpagp.precond.apply")
    assert in_cg == STEPS * (CG + 1)
    assert all(_inside(e, "rpagp.train.step", ev) for e in ev
               if e["name"] == "rpagp.sync")


def test_one_sync_span_for_each_host_read(profiled):
    _, ev, _, counts = profiled
    # one eigh a step, two chunk reads (steps 7 and 8), the stall check
    assert sum(e["name"] == "rpagp.sync" for e in ev) == STEPS + 2 + 1
    assert counts == {"rpagp.train.step": STEPS, "rpagp.sync": STEPS + 2 + 1}


def test_records_hold_every_k2_and_k3_call(profiled, monkeypatch):
    _, _, recs, _ = profiled
    seen = {"rpagp.op.interp_transpose": [], "rpagp.op.interp_apply_sum": []}
    t_plain, a_plain = (cuda_interp.interp_transpose_plain,
                        cuda_interp.interp_apply_sum_plain)

    def tr(tfrac, V, m):
        seen["rpagp.op.interp_transpose"].append((*tfrac.shape, V.shape[1],
                                                  m))
        return t_plain(tfrac, V, m)

    def ap(tfrac, G):
        seen["rpagp.op.interp_apply_sum"].append((*tfrac.shape, *G.shape[1:]))
        return a_plain(tfrac, G)

    monkeypatch.setattr(cuda_interp, "interp_transpose_plain", tr)
    monkeypatch.setattr(cuda_interp, "interp_apply_sum_plain", ap)
    _train()
    for name, calls in seen.items():
        assert calls and [r[1:] for r in recs if r[0] == name] == calls
    # only the K2 / K3 calls are recorded, each with its (J, n, t, m)
    assert all(r[0] in seen and len(r) == 5 for r in recs)


def test_no_profiler_records_nothing(monkeypatch):
    profiling.take_records()
    profiling.take_counts()
    assert profiling.span("rpagp.sync") is profiling.span("rpagp.bbmm.cg")

    def refuse(name):
        raise AssertionError(f"a range opened with no profiler: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _train()
    assert profiling.take_records() == []
    assert set(profiling.take_counts().values()) == {0}


def test_the_profiler_changes_no_result(profiled):
    res_on, _, _, _ = profiled
    res_off = _train()
    assert res_on.losses == res_off.losses
    flat = lambda t: [v for k in sorted(t) for v in
                      (flat(t[k]) if isinstance(t[k], dict) else [t[k]])]
    for a, b in zip(flat(res_on.params), flat(res_off.params)):
        assert torch.equal(a, b)


def test_trace_leaves_no_records(tmp_path):
    tfrac = torch.rand(2, 50) * 10
    with profiling.trace(str(tmp_path), device="cpu"):
        cuda_interp.interp_transpose(tfrac, torch.ones(50, 2), 16)
        with profiling.span("rpagp.sync"):
            pass
        assert profiling._records and profiling._counts["rpagp.sync"] == 1
    assert profiling.take_records() == []
    assert set(profiling.take_counts().values()) == {0}


def test_runner_profile_and_love_spans(tmp_path):
    """--profile's trace carries the split's phase spans and the
    trainer's; LOVE's cache build has its span."""
    from rpagp_torch import runner
    from rpagp_torch.ops import love

    with open(os.path.join(ROOT, "specs", "rp_poly_j10.json")) as f:
        spec = json.load(f)
    spec["training"]["max_iters"] = 2
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    d = str(tmp_path / "trace")
    runner.main(["--model_spec", spec_path, "--datasets", "sml",
                 "--splits", "10", "--max_splits", "1", "--max_points",
                 "120", "--device", "cpu", "--output",
                 str(tmp_path / "r.csv"), "--profile", d])
    (path,) = [os.path.join(d, f) for f in os.listdir(d)
               if f.endswith(".pt.trace.json")]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rpagp.split.prepare", "rpagp.split.train",
            "rpagp.split.posterior", "rpagp.train.step"} <= names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        love.build_love_cache(lambda V: 2.0 * V, torch.randn(20),
                              torch.tensor(0.1), 3)
    assert profiling.take_records() == []  # LOVE's span records nothing
    assert "rpagp.love.lanczos" in {e.name for e in prof.events()}


# ------------------------------------------------ gpbench/spans.py ----


def _x(cat, name, ts, dur, tid, corr=None, pid=1):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": pid, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _hand_trace():
    """Thread 1: a step (0-100) holding a loss span (0-40) with CG (5-35)
    and its operator (10-20), a backward span (40-80) and a sync (85-95);
    thread 2, autograd's: the estimator's backward (50-70). Launches
    (correlation ids 1-7) and their kernels on stream 7; two idle gaps,
    30-50 (ended by kernel 5, launched in thread 2's backward span) and
    70-90 (ended by kernel 7, launched outside every span)."""
    k = lambda name, ts, dur, corr: _x("kernel", name, ts, dur, 7, corr,
                                       pid=0)
    launch = lambda ts, corr, tid=1: _x("cuda_runtime", "cudaLaunchKernel",
                                        ts, 1, tid, corr)
    return [
        _x("user_annotation", "rpagp.train.step", 0, 100, 1),
        _x("user_annotation", "rpagp.train.loss", 0, 40, 1),
        _x("user_annotation", "rpagp.bbmm.cg", 5, 30, 1),
        _x("user_annotation", "rpagp.bbmm.operator", 10, 10, 1),
        _x("user_annotation", "rpagp.train.backward", 40, 40, 1),
        _x("user_annotation", "rpagp.bbmm.backward", 50, 20, 2),
        _x("user_annotation", "rpagp.sync", 85, 10, 1),
        _x("cpu_op", "aten::mul", 11, 2, 1),
        launch(2, 1), launch(6, 2), launch(12, 3), launch(21, 4),
        launch(55, 5, tid=2), launch(60, 6, tid=2), launch(110, 7),
        _x("cuda_runtime", "cudaStreamSynchronize", 86, 5, 1, 8),
        _x("cuda_runtime", "cudaStreamSynchronize", 45, 1, 1, 9),
        k("k_a", 3, 7, 1), k("k_b", 10, 5, 2), k("k_c", 15, 10, 3),
        k("k_d", 25, 5, 4), k("k_e", 50, 12, 5), k("k_f", 62, 8, 6),
        k("k_g", 90, 4, 7),
        _x("gpu_memcpy", "Memcpy DtoH", 94, 2, 7, 99, pid=0),
    ]


def test_spans_reduce_a_hand_built_trace():
    red = gp_spans.reduce(_hand_trace())
    sp = red["spans"]
    us = lambda v: round(v * 1e6, 6)
    assert {n: (v["count"], us(v["host_s"]), us(v["device_s"]),
                us(v["self_device_s"]), v["device_events"])
            for n, v in sp.items()} == {
        "rpagp.train.step": (1, 100, 47, 0, 6),
        "rpagp.train.loss": (1, 40, 27, 7, 4),
        "rpagp.bbmm.cg": (1, 30, 20, 10, 3),
        "rpagp.bbmm.operator": (1, 10, 10, 10, 1),
        "rpagp.train.backward": (1, 40, 20, 0, 2),
        "rpagp.bbmm.backward": (1, 20, 20, 20, 2),
        "rpagp.sync": (1, 10, 0, 0, 0),
    }
    assert [[k, us(v)] for k, v in red["idle_by_span"]] == [
        ["rpagp.bbmm.backward", 20], [gp_spans.OUTSIDE, 20]]
    assert red["device_events"] == 8 and us(red["device_s"]) == 53
    # the copy has no launch in the list
    assert red["unmatched"][0] == 1 and us(red["unmatched"][1]) == 2
    assert red["syncs_in_step"] == 1
    assert red["stray_syncs"] == [["cudaStreamSynchronize",
                                   "rpagp.train.backward"]]


def test_trace_reduce_events_keeps_its_keys():
    red = gp_trace.reduce_events(_hand_trace(), 1.0)
    assert set(red) == {"wall_s", "busy_s", "kernels", "device_ops",
                        "idle_gaps"}
    assert round(red["busy_s"] * 1e6, 6) == 53  # k_g and the copy meet
    assert [round(g * 1e6, 6) for _, g in red["idle_gaps"]] == [20, 20]


def test_k3_counts_at_the_bbmm_width():
    from gpbench.counts import k2, k3

    J_, n, t, m = 20, 1844352, 9, 256
    nbytes, flops = k3.work(J_, n, t, m)
    assert nbytes == 4 * (J_ * n + J_ * t * m + n * t)
    assert flops == 8 * J_ * n * t
    # the adjoint of K2: the same bytes and operations
    assert (nbytes, flops) == k2.work(J_, n, t, m)
