"""rpagp_torch's single-card surface beside the JAX package's, on the CPU:
the step-0 stall warning of train_to_convergence, utils.results,
datasets.single_split, the transforms' inverses, utils.profiling
(PhaseTimer's report, trace, annotate), the runner's --profile, and the
package's public names.

Tolerances: the warning line, the results' dicts and table text, the
splits and inv_softplus_np equal exactly; inv_softplus / unconstrain rel
<= 1e-6 (float32 log / expm1 in two libraries).
"""

import csv
import glob
import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpagp
import rpagp_torch
from rpagp import train as jtrain
from rpagp.utils import datasets as jdatasets
from rpagp.utils import profiling as jprofiling
from rpagp.utils import results as jresults
from rpagp.utils import transforms as jtransforms
from rpagp_torch import runner, train
from rpagp_torch.utils import datasets, profiling, results, transforms
from rpagp_torch.utils.config import TrainConfig

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _warnings(err):
    return [line for line in err.splitlines() if "stalled" in line]


def test_stall_warning_matches_the_reference(capsys):
    """A loss with exactly zero gradient prints the JAX package's warning
    line, once, in both packages; a live loss prints none; a parameter
    the loss does not read stays, and the others' move is enough."""
    jtrain.train_to_convergence(lambda p: jnp.sum(p["w"]) * 0.0,
                                {"w": jnp.ones((3,))}, max_iters=3)
    ref = _warnings(capsys.readouterr().err)
    assert len(ref) == 1
    p0 = {"w": torch.ones(3)}
    train.train_to_convergence(lambda p: torch.sum(p["w"]) * 0.0, p0,
                               TrainConfig(max_iters=3))
    assert _warnings(capsys.readouterr().err) == ref
    jtrain.train_to_convergence(lambda p: jnp.sum(p["w"] ** 2),
                                {"w": jnp.ones((3,))}, max_iters=3)
    train.train_to_convergence(lambda p: torch.sum(p["w"] ** 2), p0,
                               TrainConfig(max_iters=3))
    assert _warnings(capsys.readouterr().err) == []
    # one of two leaves moving is a live step
    two = {"w": torch.ones(3), "v": {"u": torch.ones(2)}}
    train.train_to_convergence(lambda p: torch.sum(p["w"] ** 2), two,
                               TrainConfig(max_iters=2))
    assert _warnings(capsys.readouterr().err) == []


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=runner.CSV_COLUMNS,
                           extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow(r)


def test_results_match_the_reference(tmp_path, capsys):
    """aggregate / format_table / main over two runner CSVs: the same dicts
    and text as the JAX package's."""
    rng = np.random.default_rng(0)
    rows = [{"dataset": ds, "split": i, "model": model, "n_train": 100,
             "n_test": 10, "rmse": float(rng.uniform(0.2, 0.9)),
             "nll": float(rng.normal()), "mll": float(rng.normal()),
             "train_time_s": float(rng.uniform(1, 9)), "iterations": 10,
             "synthetic_data": True}
            for ds in ("sml", "elevators") for model in ("rp_poly_j20",)
            for i in range(3)]
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    _write_csv(a, rows[:4])
    _write_csv(b, rows[4:] + [dict(rows[0], model="svgp_m512")])
    agg = results.aggregate([a, b])
    assert agg == jresults.aggregate([a, b])
    assert agg[("sml", "rp_poly_j20")]["n_splits"] == 3
    assert results.format_table(agg) == jresults.format_table(agg)
    assert results.main([a, b]) == 0
    assert capsys.readouterr().out.strip() == results.format_table(agg)
    assert results.main([]) == 1


def test_single_split_matches_the_reference():
    ds = datasets.load_dataset("energy", max_points=300)
    jds = jdatasets.load_dataset("energy", max_points=300)
    for frac, seed in ((0.1, 0), (0.25, 3)):
        s = datasets.single_split(ds, test_frac=frac, seed=seed)
        js = jdatasets.single_split(jds, test_frac=frac, seed=seed)
        assert s.test_x.shape[0] == max(1, round(frac * 300))
        for f in ("train_x", "train_y", "test_x", "test_y"):
            np.testing.assert_array_equal(getattr(s, f), getattr(js, f),
                                          err_msg=f)
        assert (s.y_mean, s.y_std) == (js.y_mean, js.y_std)


def test_transforms_match_the_reference():
    v = np.array([1e-3, 0.1, 0.6931, 1.0, 5.0, 19.9, 20.0, 25.0, 1e3],
                 np.float32)
    inv = transforms.inv_softplus(torch.tensor(v))
    assert inv.dtype == torch.float32
    ref = np.asarray(jtransforms.inv_softplus(jnp.asarray(v)), np.float64)
    assert np.max(np.abs(inv.numpy() - ref) / np.maximum(np.abs(ref), 1.0)) \
        <= 1e-6
    np.testing.assert_array_equal(transforms.inv_softplus_np(v),
                                  jtransforms.inv_softplus_np(v))
    np.testing.assert_array_equal(transforms.unconstrain(torch.tensor(v)),
                                  inv)
    raw = torch.tensor([-3.0, 0.0, 2.0, 30.0])
    np.testing.assert_allclose(transforms.constrain(raw).numpy(),
                               np.asarray(jtransforms.constrain(
                                   jnp.asarray(raw.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(
        transforms.constrain(transforms.unconstrain(torch.tensor(v))).numpy(),
        v, rtol=2e-6)


def test_phase_timer_report_has_the_reference_format():
    timers = (profiling.PhaseTimer(), jprofiling.PhaseTimer())
    for tm in timers:
        for name, dt in (("train", 1.25), ("prepare", 0.5), ("train", 0.75),
                         ("posterior_long_name", 0.0625)):
            tm.totals[name] += dt
            tm.counts[name] += 1
    assert timers[0].report() == timers[1].report()
    tm = profiling.PhaseTimer()
    with tm.phase("block", block_on={"a": torch.ones(2), "b": [torch.ones(1)]}):
        pass
    assert tm.counts["block"] == 1 and tm.totals["block"] >= 0.0


def _trace_files(d):
    return glob.glob(f"{d}/*.pt.trace.json")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """trace() on the CPU writes a *.pt.trace.json holding the annotated
    region; asked for the card where none records, it raises."""
    @profiling.annotate("rpagp_torch_region")
    def work(a):
        return a @ a

    assert work.__name__ == "work"
    with profiling.trace(str(tmp_path), device="cpu") as d:
        work(torch.ones(64, 64))
    assert d == str(tmp_path)
    files = _trace_files(tmp_path)
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "rpagp_torch_region" in names
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path / "c"), device="cuda"):
            pass


def test_runner_profile_traces_the_first_split(tmp_path, capsys):
    """--profile LOGDIR: one trace, of the first of two splits (a copy of
    rp_poly_j10 cut to 5 steps)."""
    with open(os.path.join(ROOT, "specs", "rp_poly_j10.json")) as f:
        spec = json.load(f)
    spec["training"]["max_iters"] = 5
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    d = str(tmp_path / "trace")
    out = str(tmp_path / "r.csv")
    runner.main(["--model_spec", spec_path, "--datasets",
                 "sml", "--splits", "10", "--max_splits", "2",
                 "--max_points", "120", "--device", "cpu", "--output", out,
                 "--profile", d])
    assert f"[profile] trace written to {d}" in capsys.readouterr().err
    assert len(_trace_files(d)) == 1  # the first split only
    with open(out) as f:
        assert len(list(csv.DictReader(f))) == 2


def test_public_names_cover_the_reference():
    names = {n for n, v in vars(rpagp).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    assert names == {"KernelSpec", "ModelSpec", "init_model", "exact_mll",
                     "predict", "mll", "posterior", "posterior_cov",
                     "sample_posterior", "make_predictor", "gen_rp",
                     "space_equally", "train_to_convergence", "train_fixed",
                     "load_dataset", "kfold_splits", "single_split"}
    assert names <= set(rpagp_torch.__all__)
    for n in rpagp_torch.__all__:
        assert callable(getattr(rpagp_torch, n)), n
