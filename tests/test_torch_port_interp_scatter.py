"""K2's scatter (rpagp_torch/csrc/interp.cu), modelled on the CPU.

The kernel cannot run here, so this file holds a torch model of what it
computes and in which order, `_k2_model(tfrac, V, m, chunk)`: one warp a
(chunk of points, component); lane l takes the chunk's points l, l + 32,
.. in order and adds each point's four Keys-cubic taps (Horner weights
of `taps()`, a tap kept when its cell lies in [0, m), points off the grid
and the -100 padding skipped) into its own copy of the (t, m)
accumulator; cell r's 32 copies are then added starting at copy
r mod 32, and the chunks' partials in chunk order. The model is held
against the JAX package's Pallas kernel (`pallas_interp.transpose_call`,
interpret mode, at tests/test_pallas_interp.py's shapes, on points where
the two plans keep the same taps) and the port's plain version. The
package does not use the model: tests/test_torch_port_cuda.py holds the
kernel itself against the plain version on the card. Tolerance: rel <=
1e-5 (norm-wise); padding contributes exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_interp
from rpagp_torch.ops import cuda_interp

torch.set_num_threads(2)

LANES = 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _taps(tf, m):
    """(cells (.., 4), weights (.., 4)) of csrc/interp.cu taps(): base
    cell floor(tf), Horner weights; a tap off the grid, and every tap of a
    point with tf outside (-8, m + 8) (the -100 padding), goes to cell m,
    which the model drops."""
    fl = torch.floor(tf)
    f = tf - fl
    g = 1.0 - f

    def inner(s):
        return ((1.5 * s - 2.5) * s) * s + 1.0

    def outer(s):
        return ((-0.5 * s + 2.5) * s - 4.0) * s + 2.0

    w = torch.stack([outer(1.0 + f), inner(f), inner(g), outer(1.0 + g)], -1)
    on = (tf > -8.0) & (tf < m + 8.0)
    cells = fl.clamp(-16, m + 16).long()[..., None] - 1 + torch.arange(4)
    kept = on[..., None] & (cells >= 0) & (cells < m)
    return torch.where(kept, cells, m), w


def _k2_model(tfrac, V, m, chunk):
    """U (J, t, m) by K2's arithmetic and summation order."""
    J, n = tfrac.shape
    t = V.shape[1]
    U = torch.zeros(J, t, m)
    lanes = torch.arange(LANES)
    rows = torch.arange(J)[:, None, None].expand(J, LANES, 4)
    lane_idx = lanes[None, :, None].expand(J, LANES, 4)
    for start in range(0, n, chunk):
        end = min(n, start + chunk)
        acc = torch.zeros(J, LANES, t, m + 1)  # each lane's own copy
        for base in range(start, end, LANES):
            i = base + lanes
            inside = i < end
            tf = torch.where(inside, tfrac[:, i.clamp(max=n - 1)],
                             torch.tensor(-100.0))  # (J, 32)
            v = torch.where(inside[:, None], V[i.clamp(max=n - 1)],
                            torch.zeros(()))  # (32, t)
            cells, w = _taps(tf, m)  # (J, 32, 4)
            add = w[..., None] * v[None, :, None]  # (J, 32, 4, t)
            # a lane's kept taps are distinct cells, the lanes' copies
            # apart: each add below is one word's, in point order
            for k in range(t):
                for d in range(4):
                    acc[rows[..., d], lane_idx[..., d], k,
                        cells[..., d]] += add[..., d, k]
        flat = acc[..., :m].reshape(J, LANES, t * m)
        r = torch.arange(t * m)
        part = torch.zeros(J, t * m)
        for q in range(LANES):  # cell r's copies from copy r mod 32 on
            part = part + flat[:, (r + q) % LANES, r]
        U = U + part.reshape(J, t, m)
    return U


def _tfrac(J, n, m, rng, kind):
    if kind == "crowded":  # every point in three cells
        tf = rng.choice([m / 2 - 0.7, m / 2 + 0.2, m / 2 + 1.45], (J, n))
        tf = tf + 0.01 * rng.random((J, n))
    elif kind == "edges":  # the grid's edges, off it, and -100 padding
        tf = rng.uniform(-3.0, m + 2.0, (J, n))
        tf[:, :8] = [-2.5, -1.5, -0.25, 0.0, m - 2.0, m - 1.0, m - 0.5,
                     m + 0.5]
        tf[:, -20:] = -100.0
    else:
        tf = rng.uniform(0.0, m - 1.0, (J, n))
    return tf.astype(np.float32)


@pytest.mark.parametrize("m", [17, 100, 1024])
@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("kind", ["crowded", "edges"])
def test_k2_model_matches_plain(m, t, kind):
    """Crowded points, the grid's edges and padding, m not a multiple of
    32 and m = 1024, t in {1, 3, 8}, three chunks of points: the model
    against the port's plain version in float64; padding rows contribute
    exactly zero (a huge V there leaves the model's output unchanged)."""
    rng = np.random.default_rng(m * 10 + t)
    J, n = 3, 700
    tf = torch.from_numpy(_tfrac(J, n, m, rng, kind))
    V = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    got = _k2_model(tf, V, m, chunk=256)
    want = cuda_interp.interp_transpose_plain(tf.double(), V.double(), m)
    assert got.shape == (J, t, m)
    assert _rel(got, want) <= 1e-5
    if kind == "edges":
        V2 = V.clone()
        V2[-20:] = 1e6
        assert torch.equal(_k2_model(tf, V2, m, chunk=256), got)


@pytest.mark.parametrize("t", [1, 3, 8])
def test_k2_model_matches_pallas(t):
    """test_pallas_interp's shape (J = 3, n = 1000, m = 64), points on
    [0, m - 1) where the Pallas plan and the dense plan keep the same
    taps, plus three crowded cells: the Pallas kernel in interpret mode
    and the port's plain version against the model."""
    rng = np.random.default_rng(t)
    J, n, m = 3, 1000, 64
    tf = rng.uniform(0.0, m - 1.0, (J, n)).astype(np.float32)
    tf[:, :300] = _tfrac(J, 300, m, rng, "crowded")
    V = rng.standard_normal((n, t)).astype(np.float32)
    got = _k2_model(torch.from_numpy(tf), torch.from_numpy(V), m, chunk=512)
    n_pad = -(-n // pallas_interp.BN) * pallas_interp.BN
    tfp = np.pad(tf, ((0, 0), (0, n_pad - n)), constant_values=-100.0)
    VT = np.pad(V.T, ((0, 0), (0, n_pad - n)))
    ref = pallas_interp.transpose_call(jnp.asarray(tfp), jnp.asarray(VT), m,
                                       interpret=True)
    plain = cuda_interp.interp_transpose_plain(torch.from_numpy(tf),
                                               torch.from_numpy(V), m)
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, plain) <= 1e-5
