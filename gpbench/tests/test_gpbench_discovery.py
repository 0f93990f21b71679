"""A configuration, a traffic mix and a metric added as new files (and
entries in BENCHMARK.json) are found by name, with no edit to any file
the benchmark has."""

import json
import os
import shutil

from gpbench import harness

from _tiny import run


def test_new_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    g = root / "gpbench"
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
    bench["configs"].append({**bench["configs"][0], "name": "he_j10_bbmm",
                             "file": "gpbench/configs/he_j10_bbmm.json"})
    bench["workloads"].append({"name": "he_j10_bbmm.train_fold3",
                               "config": "he_j10_bbmm",
                               "traffic": "train_fold3", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "units_done", "unit": "units",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["he_j10_bbmm.train_fold3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(g))
    rc, res, _ = run("he_j10_bbmm.train_fold3")
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"units_done", "setup_s"}
    assert res["metrics"]["units_done"]["value"] == res["attempted"]
    # nothing the benchmark had was edited, but the BENCHMARK.json entries
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
