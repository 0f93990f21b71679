"""The check catches each fault a cell can have: the rest of a run
(without the look for a card) with the timed path broken underneath
reads `correct` false. And on the card, the control (the reference in
TF32 put in the program's place) fails the limits at a size a test run
holds."""

import gc

import pytest
import torch

from gpbench import drive, harness
from gpbench.tools import readings

from _tiny import run

CELLS = ("he_j20_bbmm.train",)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_pass(cell):
    rc, res, _ = run(cell)
    assert rc == 0 and res["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    rc, res, _ = run(cell)
    assert rc == 0 and res["correct"] is False
    assert res["compared"]["change"]["value"] > res["compared"]["change"][
        "limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(readings.FAULTS))
def test_half_of_the_rows_left_out(cell, fault):
    with readings.FAULTS[fault]():
        rc, res, _ = run(cell)
    assert rc == 0 and res["correct"] is False
    mvm = res["compared"]["mvm"]
    assert mvm["value"] > mvm["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_non_finite_loss_in_the_window(cell, monkeypatch):
    calls = []
    train_call = drive.find("units", "train_call")
    unit0 = train_call.Unit.unit

    def unit(self, i):
        calls.append(i)
        out = unit0(self, i)
        return {**out, "ok": False} if len(calls) == 1 else out

    monkeypatch.setattr(train_call.Unit, "unit", unit)
    rc, res, _ = run(cell)
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1
    assert res["compared"]["failed_units"]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 is a property of the card")
    c = harness.load_cell(cell, {"data": {"n": 200000}})
    tr = drive.make(c.cfg, c.mix, 12345, torch.device("cuda"))
    tr.setup()
    tr.release()
    gc.collect()
    got = tr.checks.compare(tr, control="tf32")
    assert any(got[k] > v for k, v in c.limits.items() if k in got), got
