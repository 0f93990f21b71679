"""K5's backward arithmetic (rpagp_torch/csrc/gram_mvm.cu), modelled on the CPU.

The kernel cannot run here, so this file holds a torch model of what it
computes and in which order, `_k5_model(z1, z2, w, V, G, base, S)`: the
coordinates prescaled per base (one 2^x of d' = c z1 - c z2 gives k1d
and, through one factor per base, k1d'); per 64-row by 128-column tile
the Gm = G V^T values formed column by column of t; per component each
of a row's 4 lanes adding its 32 columns (16 k + 4 g + u) in order into
one sum for dz and one for dw, the lanes added by the kernel's butterfly
and the totals added tile by tile into the row's slots; the S z2 chunks'
dz slots added in chunk order and scaled by w_j and the base's factor,
and the items' dw sums added in float64. The model is held against the
JAX package's Pallas backward kernel (`pallas_gram._gram_mvm_bwd_call`,
interpret mode, at tests/test_pallas_gram.py's shapes) and the port's
plain version. The package does not use the model:
tests/test_torch_port_cuda.py holds the kernel itself against the plain
version on the card. Tolerance: dz and dw rel <= 1e-5 (norm-wise).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_gram
from rpagp_torch.ops import cuda_gram

torch.set_num_threads(2)

ROWS, COLS, LANES = 64, 128, 4  # the kernel's tile and lanes a row
LN2 = math.log(2.0)
LOG2E = 1.0 / LN2
SCALE = {"rbf": math.sqrt(LOG2E / 2.0), "matern12": LOG2E,
         "matern32": math.sqrt(3.0) * LOG2E,
         "matern52": math.sqrt(5.0) * LOG2E}
# dz = w_j * DZ_SCALE * (the kernel's sum): the chain rule for c
DZ_SCALE = {"rbf": -math.sqrt(2.0 * LN2), "matern12": -1.0,
            "matern32": -math.sqrt(3.0) * LN2,
            "matern52": -math.sqrt(5.0) * LN2 / 3.0}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pair_terms(base, d, gm):
    """(the dz term, the dw term) of the Gram cotangent gm at prescaled
    differences d, as csrc/gram_mvm.cu bwd_pair evaluates them."""
    f32 = torch.float32
    if base == "rbf":
        ge = gm * torch.exp2(-d * d)
        return ge * d, ge
    u = torch.abs(d)
    ge = gm * torch.exp2(-u)
    if base == "matern12":
        return ge * torch.sign(d), ge
    l2 = torch.tensor(LN2, dtype=f32)
    p1 = u * l2 + 1.0
    if base == "matern32":
        return ge * d, ge * p1
    l2sq3 = torch.tensor(LN2 * LN2 / 3.0, dtype=f32)
    return (ge * d) * p1, ge * (u * (u * l2sq3 + l2) + 1.0)


def _k5_model(z1, z2, w, V, G, base, S):
    """(dz, dw) by K5's arithmetic and summation order, S z2 chunks."""
    c = torch.tensor(SCALE[base], dtype=torch.float32)
    a, bz = c * z1, c * z2
    n, J = z1.shape
    m, t = z2.shape[0], V.shape[1]
    LT = -(-m // COLS)
    # column 16 k + 4 g + u of a tile is lane g's (4 k + u)-th
    order = torch.tensor([[16 * k + 4 * g + u for k in range(8)
                           for u in range(4)] for g in range(LANES)])
    slots = torch.zeros(S, n, J)
    dw_items = []
    for s in range(S):
        for r0 in range(0, n, ROWS):
            rows = a[r0:r0 + ROWS]
            R = rows.shape[0]
            s_dz = torch.zeros(R, J)
            s_dw = torch.zeros(R, J)
            for lt in range(s * LT // S, (s + 1) * LT // S):
                l0 = lt * COLS
                cols = torch.zeros(COLS, J)
                Vt = torch.zeros(COLS, t)
                cols[:min(COLS, m - l0)] = bz[l0:l0 + COLS]
                Vt[:min(COLS, m - l0)] = V[l0:l0 + COLS]
                gm = torch.zeros(R, COLS)
                for ci in range(t):  # t FMAs a pair, column by column
                    gm = gm + G[r0:r0 + R, ci, None] * Vt[None, :, ci]
                d = rows[:, None, :] - cols[None, :, :]  # (R, COLS, J)
                tz, tw = _pair_terms(base, d, gm[:, :, None])
                lane_z = torch.zeros(LANES, R, J)
                lane_w = torch.zeros(LANES, R, J)
                for q in range(32):
                    lane_z = lane_z + tz[:, order[:, q], :].permute(1, 0, 2)
                    lane_w = lane_w + tw[:, order[:, q], :].permute(1, 0, 2)
                for h in (1, 2):  # the butterfly over the row's lanes
                    lane_z = lane_z + lane_z[torch.arange(LANES) ^ h]
                    lane_w = lane_w + lane_w[torch.arange(LANES) ^ h]
                s_dz = s_dz + lane_z[0]
                s_dw = s_dw + lane_w[0]
            slots[s, r0:r0 + R] = s_dz
            dw_item = torch.zeros(J)
            for r in range(R):
                dw_item = dw_item + s_dw[r]
            dw_items.append(dw_item)
    total = slots[0]
    for k in range(1, S):
        total = total + slots[k]
    dz = (torch.tensor(DZ_SCALE[base], dtype=torch.float32) * w) * total
    dw = torch.stack(dw_items).double().sum(0).float()
    return dz, dw


def _inputs(n, m, t, J, seed):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((n, J)).astype(np.float32)
    z2 = rng.standard_normal((m, J)).astype(np.float32)
    z2[:5] = z1[:5]  # coincident points: d = 0 (k1d' = 0 there)
    w = (0.2 + rng.random(J)).astype(np.float32)
    V = rng.standard_normal((m, t)).astype(np.float32)
    G = rng.standard_normal((n, t)).astype(np.float32)
    return z1, z2, w, V, G


@pytest.mark.parametrize("base", cuda_gram.BASES)
@pytest.mark.parametrize("shape,S", [((40, 30, 3), 1), ((300, 530, 5), 1),
                                     ((300, 530, 5), 3)],
                         ids=["small", "ragged", "ragged-3-chunks"])
def test_k5_model_matches_pallas_and_plain(base, shape, S):
    """test_pallas_gram's shapes (J = 6): the Pallas backward kernel in
    interpret mode and the port's plain version against the model, with
    one z2 chunk and with three (530 columns are 5 tiles of 128)."""
    n, m, t = shape
    arrs = _inputs(n, m, t, 6, seed=n + m)
    got = _k5_model(*(torch.from_numpy(x) for x in arrs), base, S)
    ref = pallas_gram._gram_mvm_bwd_call(*(jnp.asarray(x) for x in arrs),
                                         base=base, interpret=True)
    plain = cuda_gram.gram_mvm_bwd_plain(*(torch.from_numpy(x)
                                           for x in arrs), base)
    for g, r, p in zip(got, ref, plain):
        assert _rel(g, r) <= 1e-5
        assert _rel(g, p) <= 1e-5


@pytest.mark.parametrize("base", cuda_gram.BASES)
@pytest.mark.parametrize("t", [1, 11, 17])
def test_k5_model_widths_match_plain(base, t):
    """t = 1 (one column pass), 11 (the BBMM training width) and 17 (past
    the one-pass widths) against the port's plain version in float64,
    with coincident points (d = 0) in every column tile's first rows."""
    arrs = _inputs(150, 260, t, 5, seed=t)
    got = _k5_model(*(torch.from_numpy(x) for x in arrs), base, 2)
    want = cuda_gram.gram_mvm_bwd_plain(*(torch.from_numpy(x).double()
                                          for x in arrs), base)
    for g, r in zip(got, want):
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("base", ["matern12", "matern32", "matern52"])
def test_k5_model_zero_difference_has_zero_slope(base):
    """At d = 0 a Matern base's k1d' is 0 (jnp.sign(0) = 0 in the TPU
    kernel): one row on one column, the same coordinates, gives dz = 0
    exactly and dw = Gm k1d(0) = Gm."""
    z = torch.tensor([[0.3, -1.2]])
    V, G = torch.tensor([[2.0]]), torch.tensor([[0.5]])
    w = torch.tensor([0.7, 1.1])
    dz, dw = _k5_model(z, z.clone(), w, V, G, base, 1)
    assert torch.equal(dz, torch.zeros(1, 2))
    assert torch.allclose(dw, torch.full((2,), 1.0), rtol=1e-6)


def test_bwd_scratch_and_pass():
    """The wrapper's scratch size and column pass mirror
    rpagp_gram_mvm_bwd: at the BBMM training shape (14,939 rows and
    columns, J = 10, t = 11, 9 chunks) the coordinates, V^T (t rounded up
    to 12), the chunks' dz sums and the items' dw sums."""
    assert [cuda_gram.bwd_pass(t) for t in (1, 2, 4, 5, 11, 16, 17, 256)] == [
        1, 4, 4, 8, 12, 16, 16, 16]
    n, J, t, S = 14939, 10, 11, 9
    RT, mp = 234, 14976
    assert cuda_gram._bwd_scratch(n, n, J, t, S) == (
        J * (RT * 64 + mp) + 12 * mp + S * n * J + RT * S * J)
