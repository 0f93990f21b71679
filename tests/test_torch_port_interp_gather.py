"""K3's gather (rpagp_torch/csrc/interp.cu `apply_sum_shifted_kernel`,
`apply_sum_rows_kernel`), modelled on the CPU.

The kernel cannot run here, so this file holds a torch model of what it
computes and in which order, `_k3_model(tfrac, G)`: a point's tfrac is
clamped to [-3, m + 1] (NaN to -3), its base cell c = floor(tf) and the
Horner weights of `taps()`; its taps come from the kernel's table in
shared memory. At t = 1 that is the pre-shifted entry c + 3 (G[c - 1 ..
c + 2], zero off the grid), and out adds w_d x tap_d over the components
in order and the taps in order. At t >= 2 it is rows c + 3 .. c + 6 of
the rows table (cell r - 4 at row r, zero off the grid), read by 4 or 8
lanes a point, the lane of tap d adding w_d x tap_d over the components
in order; the 4 taps' sums meet as ((d0 + d1) + (d2 + d3)). Sweeps over
groups of components add to out in float32; at these sizes the table
holds every component, so the model has one sweep. `_stage_rows` /
`_read_rows` model the rows table's layout as the kernel writes it and
as each lane reads it.

The model is held against the port's plain version in float64 and
against the JAX package's Pallas kernel (`pallas_interp.apply_sum_call`,
interpret mode, at tests/test_pallas_interp.py's shapes, on points where
the two plans keep the same taps). The package does not use the model:
tests/test_torch_port_cuda.py holds the kernel itself against the plain
version on the card. Tolerance: rel <= 1e-5 (norm-wise); padding and
points off the grid give exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_interp
from rpagp_torch.ops import cuda_interp

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _padded(G):
    """G (J, t, m) -> (J, t, m + 8): cell c at index c + 4, zero off the
    grid (cells -4 .. m + 3)."""
    J, t, m = G.shape
    Gp = torch.zeros(J, t, m + 8, dtype=G.dtype)
    Gp[..., 4:m + 4] = G
    return Gp


def _shifted_table(G):
    """(J, m + 5, 4): entry e of component j holds G[j, 0, c - 1 + d] of
    base cell c = e - 3 (t = 1)."""
    m = G.shape[2]
    e = torch.arange(m + 5)
    return _padded(G)[:, 0][:, e[:, None] + torch.arange(4)]


def _weights_and_entry(tfrac, m):
    """k3_taps(): the clamped point's Horner weights (.., 4) and e = base
    cell + 3."""
    tf = torch.nan_to_num(tfrac, nan=-3.0).clamp(-3.0, m + 1.0)
    fl = torch.floor(tf)
    f = tf - fl
    g = 1.0 - f

    def inner(s):
        return ((1.5 * s - 2.5) * s) * s + 1.0

    def outer(s):
        return ((-0.5 * s + 2.5) * s - 4.0) * s + 2.0

    w = torch.stack([outer(1.0 + f), inner(f), inner(g), outer(1.0 + g)], -1)
    return w, (fl + 3.0).long()


def _k3_model(tfrac, G):
    """out (n, t) by K3's arithmetic and summation order."""
    J, n = tfrac.shape
    t, m = G.shape[1], G.shape[2]
    w, e = _weights_and_entry(tfrac, m)  # (J, n, 4), (J, n)
    if t == 1:
        taps = _shifted_table(G)[torch.arange(J)[:, None], e][:, :, None, :]
    else:  # rows e .. e + 3 of the rows table: cells c - 1 .. c + 2
        rows = _padded(G).transpose(1, 2)  # (J, m + 8, t)
        taps = torch.stack([rows[torch.arange(J)[:, None], e + d]
                            for d in range(4)], -1)  # (J, n, t, 4)
    if t == 1:
        out = torch.zeros(n, t)
        for j in range(J):
            for d in range(4):
                out = out + w[j, :, None, d] * taps[j, :, :, d]
        return out
    lanes = torch.zeros(4, n, t)  # the lanes of taps 0 .. 3
    for j in range(J):
        for d in range(4):
            lanes[d] = lanes[d] + w[j, :, None, d] * taps[j, :, :, d]
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _stage_rows(G, k0, tc, tp):
    """The kernel's rows table (stage_rows) of columns k0 .. k0 + tc - 1 as
    a flat array: cell c's column k at (jl (m + 8) + c + 4) tp + k."""
    J, t, m = G.shape
    R = m + 8
    flat = torch.full((J * R * tp,), float("nan"))
    Gp = _padded(G)
    for jl in range(J):
        for k in range(tp):
            for r in range(R):
                v = Gp[jl, k0 + k, r] if k < tc else 0.0
                flat[(jl * R + r) * tp + k] = v
    return flat


def _read_rows(flat, jl, e, s, tp, m):
    """The float4 lane s of a point reads: 4 s floats into the point's rows
    e .. e + 3."""
    at = (jl * (m + 8) + e) * tp + 4 * s
    return flat[at:at + 4]


def _tfrac(J, n, m, rng, kind):
    if kind == "crowded":  # every point in three cells
        tf = rng.choice([m / 2 - 0.7, m / 2 + 0.2, m / 2 + 1.45], (J, n))
        tf = tf + 0.01 * rng.random((J, n))
    elif kind == "edges":  # the grid's edges, off it, and -100 padding
        tf = rng.uniform(-3.0, m + 2.0, (J, n))
        tf[:, :14] = [-9.0, -7.5, -3.0, -2.5, -1.5, -0.25, 0.0, m - 2.0,
                      m - 1.0, m - 0.5, m + 0.5, m + 1.0, m + 7.5, m + 9.0]
        tf[:, 14:17] = [np.inf, -np.inf, np.nan]
        tf[:, -20:] = -100.0
    else:
        tf = rng.uniform(0.0, m - 1.0, (J, n))
    return tf.astype(np.float32)


@pytest.mark.parametrize("m", [17, 100, cuda_interp.M_MAX])
@pytest.mark.parametrize("t", [1, 3, 8, 11])
@pytest.mark.parametrize("kind", ["crowded", "edges"])
def test_k3_model_matches_plain(m, t, kind):
    """Crowded points, the grid's edges, points off it (NaN and infinities
    included) and padding, m not a multiple of 4 and m = M_MAX, t in {1,
    3, 8, 11}: the model against the port's plain version in float64;
    padding rows and points off the grid give exactly zero."""
    rng = np.random.default_rng(m * 10 + t)
    J, n = 3, 700
    tf = torch.from_numpy(_tfrac(J, n, m, rng, kind))
    G = torch.from_numpy(rng.standard_normal((J, t, m)).astype(np.float32))
    got = _k3_model(tf, G)
    want = cuda_interp.interp_apply_sum_plain(tf.double(), G.double())
    assert got.shape == (n, t)
    assert _rel(got, want) <= 1e-5
    if kind == "edges":
        assert bool((got[-20:] == 0).all())
        off = torch.tensor([0, 1, 2, 3, 11, 12, 13, 14, 15, 16])  # no tap on
        assert bool((got[off] == 0).all())


@pytest.mark.parametrize("t", [1, 3, 8])
def test_k3_model_matches_pallas(t):
    """test_pallas_interp's shape (J = 3, n = 1000, m = 64), points on
    [0, m - 1) where the Pallas plan and the dense plan keep the same
    taps, plus three crowded cells: the Pallas kernel in interpret mode
    and the port's plain version against the model."""
    rng = np.random.default_rng(t)
    J, n, m = 3, 1000, 64
    tf = rng.uniform(0.0, m - 1.0, (J, n)).astype(np.float32)
    tf[:, :300] = _tfrac(J, 300, m, rng, "crowded")
    G = rng.standard_normal((J, t, m)).astype(np.float32)
    got = _k3_model(torch.from_numpy(tf), torch.from_numpy(G))
    n_pad = -(-n // pallas_interp.BN) * pallas_interp.BN
    tfp = np.pad(tf, ((0, 0), (0, n_pad - n)), constant_values=-100.0)
    ref = pallas_interp.apply_sum_call(jnp.asarray(tfp), jnp.asarray(G),
                                       interpret=True)[:, :n].T
    plain = cuda_interp.interp_apply_sum_plain(torch.from_numpy(tf),
                                               torch.from_numpy(G))
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, plain) <= 1e-5


@pytest.mark.parametrize("m", [17, 256, cuda_interp.M_MAX])
@pytest.mark.parametrize("tc", [1, 3, 4, 5, 8])
def test_k3_tables_hold_the_taps(m, tc):
    """Every base cell's taps as the kernel reads them from the shifted
    table, and from the rows table of a pass of tc columns as staged and
    read by the point's tp lanes (lane s: tap 4 s / tp, columns 4 (s %
    (tp / 4)) .. + 3), equal G at cells c - 1 .. c + 2, zero off the grid
    and past tc."""
    rng = np.random.default_rng(m + tc)
    J, t, k0 = 2, 11, 3
    G = torch.from_numpy(rng.standard_normal((J, t, m)).astype(np.float32))
    tp = 8 if tc > 4 else 4
    flat = _stage_rows(G, k0, tc, tp)
    assert not bool(torch.isnan(flat).any())
    shifted = _shifted_table(G[:, k0:k0 + 1])
    cols = torch.zeros(J, tp, m + 8)  # the pass's columns, zero past tc
    cols[:, :tc] = _padded(G)[:, k0:k0 + tc]
    for jl in range(J):
        for e in range(m + 5):  # base cell e - 3
            assert torch.equal(shifted[jl, e], cols[jl, 0, e:e + 4])
            for s in range(tp):
                d, h = 4 * s // tp, s % (tp // 4)
                assert torch.equal(_read_rows(flat, jl, e, s, tp, m),
                                   cols[jl, 4 * h:4 * h + 4, e + d])
