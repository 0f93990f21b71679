"""Each traffic mix runs a whole cell and prints its result line."""

import pytest

from _tiny import run

CELLS = ("he_j20_bbmm.train",)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_prints_a_result_line(workload, trace):
    rc, res, _ = run(workload, trace=trace)
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    for k, v in res["compared"].items():
        assert v["value"] <= v["limit"], k
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"]
        assert res["metrics"]["setup_s"]["unit"] == "s"


def test_the_cells_end_to_end_metrics():
    _, res, _ = run("he_j20_bbmm.train")
    # peak_gib reads the card's allocator: a CPU run has none
    assert set(res["metrics"]) == {"step_ms.bbmm", "setup_s"}
    assert res["metrics"]["step_ms.bbmm"]["value"] > 0


def test_no_card_means_no_result(monkeypatch):
    import torch

    from _tiny import TINY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    over = {k: v for k, v in TINY.items() if k != "device"}
    rc, res, out = run("he_j20_bbmm.train", overrides=over)
    assert rc != 0 and res is None and out == ""
