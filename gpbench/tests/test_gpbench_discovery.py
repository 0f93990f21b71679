"""A configuration, a traffic mix, a metric, a unit's check and the
limits added as new files (and entries in BENCHMARK.json) are found by
name, with no edit to any file the benchmark has; a unit or a check
without its file is an error."""

import json
import os
import shutil

import pytest
import torch

from gpbench import harness

from _tiny import run


def _checkout(tmp_path, monkeypatch):
    """A copy of the benchmark that the harness reads in place of this
    one: (its root, its gpbench/, every file's bytes before the test)."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(root / "gpbench"))
    return root, root / "gpbench", before


def _add_cell(root, config: dict, workload: dict):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(config)
    bench["workloads"].append(workload)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def _nothing_edited(before):
    """Nothing the benchmark had was edited, but BENCHMARK.json."""
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p


def test_new_files_are_found(tmp_path, monkeypatch):
    root, g, before = _checkout(tmp_path, monkeypatch)
    cfg = json.loads((g / "configs" / "he_j20_bbmm.json").read_text())
    cfg["name"] = "he_j10_bbmm"
    cfg["kernel"]["J"] = 10
    (g / "configs" / "he_j10_bbmm.json").write_text(json.dumps(cfg))
    mix = json.loads((g / "traffic" / "train.json").read_text())
    mix["fold"] = 3
    (g / "traffic" / "train_fold3.json").write_text(json.dumps(mix))
    (g / "metrics" / "units_done.py").write_text(
        "def read(run):\n    return float(run.window['units'])\n")
    limits = json.loads((g / "limits" / "he_j20_bbmm.train.json")
                        .read_text())
    (g / "limits" / "he_j10_bbmm.train_fold3.json").write_text(
        json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench = _add_cell(root, {**bench["configs"][0], "name": "he_j10_bbmm",
                             "file": "gpbench/configs/he_j10_bbmm.json"},
                      {"name": "he_j10_bbmm.train_fold3",
                       "config": "he_j10_bbmm", "traffic": "train_fold3",
                       "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "units_done", "unit": "units",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["he_j10_bbmm.train_fold3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, _ = run("he_j10_bbmm.train_fold3")
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"units_done", "setup_s"}
    assert res["metrics"]["units_done"]["value"] == res["attempted"]
    _nothing_edited(before)


# the dense exact path: no SKI, n_train 900 under max_cholesky_size
DENSE = {"name": "dense_j4", "model": "exact_gp",
         "kernel": {"type": "projection", "J": 4, "d": 1, "base": "rbf",
                    "proj_dist": "gaussian", "ski": False},
         "training": {"lr": 0.1, "max_iters": 6, "patience": 6},
         "data": {"dataset": "synthetic", "n": 1000, "d": 11, "folds": 10},
         "reference": "exact_dense"}
DENSE_LIMITS = {"loss": 1e-4, "change": 0.01, "failed_units": 0}


@pytest.mark.parametrize("adam", ("steps", "leaves the state unchanged"))
def test_a_dense_configuration_is_new_files(tmp_path, monkeypatch, adam):
    """A configuration of another path of the program, the dense exact
    GP, added by new files only: its configuration, mix, limits and check
    module. Its cell runs correct, and reads not correct when Adam's step
    leaves the state unchanged."""
    from rpagp_torch.mll import _solver
    from rpagp_torch.utils.config import experiment_spec_from_dict

    assert _solver(experiment_spec_from_dict(DENSE).model, 900) == "exact"
    root, g, before = _checkout(tmp_path, monkeypatch)
    (g / "configs" / "dense_j4.json").write_text(json.dumps(DENSE))
    (g / "traffic" / "train_small.json").write_text(json.dumps(
        {"unit": "train_call", "fold": 1, "warmup_steps": 4,
         "sync_every": 8, "trace_units": 1}))
    (g / "limits" / "dense_j4.train_small.json").write_text(
        json.dumps(DENSE_LIMITS))
    shutil.copy(os.path.join(os.path.dirname(__file__),
                             "_exact_dense_check.py"),
                g / "checks" / "exact_dense.py")
    _add_cell(root, {"name": "dense_j4", "source":
                     "https://arxiv.org/abs/1912.12834",
                     "file": "gpbench/configs/dense_j4.json",
                     "reduced": [], "why": "a test configuration"},
              {"name": "dense_j4.train_small", "config": "dense_j4",
               "traffic": "train_small", "chips": 1, "why": "a test cell"})
    if adam != "steps":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    rc, res, _ = run("dense_j4.train_small", overrides={"device": "cpu"})
    assert rc == 0
    assert set(res["compared"]) == set(DENSE_LIMITS)
    if adam == "steps":
        assert res["correct"] is True
    else:
        assert res["correct"] is False
        change = res["compared"]["change"]
        assert change["value"] > change["limit"]
    _nothing_edited(before)


def test_a_unit_or_check_without_its_file_is_an_error():
    from gpbench import drive

    c = harness.load_cell("he_j20_bbmm.train")
    with pytest.raises(FileNotFoundError, match="units/no_such_unit.py"):
        drive.make(c.cfg, {**c.mix, "unit": "no_such_unit"}, 1, "cpu")
    with pytest.raises(FileNotFoundError, match="checks/no_such_check.py"):
        drive.make({**c.cfg, "reference": "no_such_check"}, c.mix, 1, "cpu")
    cfg = {k: v for k, v in c.cfg.items() if k != "reference"}
    with pytest.raises(KeyError, match="names no reference"):
        drive.make(cfg, c.mix, 1, "cpu")
