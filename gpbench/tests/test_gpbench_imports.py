"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or rpagp (the whole name is compared: rpagp_torch is the program); and
the reference loads nothing of rpagp_torch."""

import os
import subprocess
import sys

from gpbench import harness

_RUN = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from _tiny import run
rc, res, _ = run("he_j20_bbmm.train")
from gpbench import harness
print("RC", rc, res is not None and res["correct"])
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_REF = """
import sys
sys.path.insert(0, {root!r})
import torch
from gpbench.reference import check, common, data, ski_bbmm
x = torch.rand(200, 3, dtype=torch.float64)
op = ski_bbmm.Operator(x, data.gaussian_projection(3, 2, 0), 16,
                       torch.float64)
(es, eb), = ski_bbmm.probe_normals(1, 200, 3, 2, 1, "cpu")
ski_bbmm.loss_and_grad(op, common.zero_params(2, torch.float64, "cpu"),
                       torch.rand(200), es, eb, 3, 5, 0.01)
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top(code):
    tests = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", code.format(
        root=harness.ROOT, tests=tests)], capture_output=True, text=True,
        timeout=600, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line[:3] in ("RC ", "TOP"))
    return lines, eval(lines["TOP"])


def test_a_run_loads_no_jax_and_no_rpagp():
    lines, top = _top(_RUN)
    assert lines["RC"] == "0 True"
    assert "rpagp_torch" in top
    assert not set(top) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    _, top = _top(_REF)
    assert "rpagp_torch" not in top
    assert not set(top) & set(harness.FORBIDDEN)


def test_names_are_compared_whole(monkeypatch):
    base = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rpagp_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
