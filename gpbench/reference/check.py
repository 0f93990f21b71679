"""The comparison that decides `correct`: each number the benchmark
compares, worked out from the program's outputs and the reference's.
Each is a relative gap, 0 for an exact match; its limit lives in
gpbench/limits/<workload>.json.

Training (the first three Adam steps from the initial hyperparameters):
  loss    max over the steps of |loss_prog - loss_ref| / |loss_ref|
  grad    the worst leaf of the first gradient: the gap between the two
          norms over the larger of the reference leaf's norm and the
          median leaf's
  change  the median, over the leaves whose reference gradient is at
          least a thousandth of the median leaf's (a leaf whose gradient
          is nought to rounding moves under Adam by round-off alone), of
          each leaf's gap between the norms of its change over the three
          steps, as for grad. The median and not the worst leaf: a leaf
          whose float32 gradient is near its rounding (the mean constant
          on z-scored y) turns Adam's sign-like step round on some
          seeds, and the worst leaf then reads 0.3-0.45 on sound runs
          (PERF.md)
The SKI geometry and operator:
  tfrac   the widest gap of the points' grid coordinates, in cells;
          read by gpbench/tools/readings.py and not compared: neither
          the control nor a fault moves it (PERF.md), and a geometry
          that is wrong shows in mvm
  mvm     the first SKI MVM of the first step, K V for the step's first
          search directions V (n, t): the worst column's
          ||KV_prog - KV_ref|| / ||KV_ref||. Rows the program never
          produced read as zeros: an MVM that leaves out half of the
          rows reads about 0.7 (the reference covers all of them)
Whole window:
  failed_units  the units whose losses were not all finite (limit 0)
"""

from __future__ import annotations

import statistics

import torch

# the training leaves, by their names in the program's params tree
LEAVES = ("raw_lengthscale", "raw_outputscale", "mean_const", "raw_noise")
# a leaf's change counts when its reference gradient is at least this
# share of the median leaf's
MOVING = 1e-3


def _norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(tree[k].double().cpu()))
            for k in LEAVES}


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """{leaf: |norm_prog - norm_ref| / max(norm_ref, the median leaf's)}."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn[k] for k in LEAVES)
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in keys}


def training(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [3 floats], "grad": {leaf: tensor}, "start":
    {leaf: tensor}, "end": {leaf: tensor}} (params before and after the
    three steps)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    gn = _norms(ref["grad"])
    med = statistics.median(gn.values())
    moving = [k for k in LEAVES if gn[k] >= MOVING * med]
    delta = lambda r: {k: r["end"][k].double().cpu() - r["start"][k].double()
                       .cpu() for k in LEAVES}
    change = leaf_gaps(delta(prog), delta(ref), moving)
    return {"loss": loss,
            "grad": max(leaf_gaps(prog["grad"], ref["grad"], LEAVES)
                        .values()),
            "change": statistics.median(change.values()),
            "change_worst": max(change.values())}


def widest(a, b) -> float:
    """max |a - b| in float64 (grid coordinates: in cells); inf when the
    two cover different points."""
    if a.shape != b.shape:
        return float("inf")
    return float(torch.max(torch.abs(a.double() - b.to(a.device).double())))


def rows(a, n: int):
    """a (r, t) with zero rows appended up to n rows."""
    if a.shape[0] >= n:
        return a
    return torch.cat([a, a.new_zeros(n - a.shape[0], *a.shape[1:])])


def columns(a, b) -> float:
    """The worst column's ||a_c - b_c|| / ||b_c|| in float64; inf when the
    shapes differ."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.double(), b.to(a.device).double()
    gap = torch.linalg.vector_norm(a - b, dim=0)
    return float(torch.max(gap / torch.linalg.vector_norm(b, dim=0)))
