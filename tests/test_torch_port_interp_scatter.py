"""K2's scatter (rpagp_torch/csrc/interp.cu), its own and slots routes,
modelled on the CPU (its runs route: tests/test_torch_port_interp_runs.py).

The kernel cannot run here, so this file holds a torch model of what it
computes and in which order, `_k2_model(tfrac, V, m, chunk)`: one warp a
(chunk of points, component, tile of C <= 32 columns: `_tiles`); its
lanes are
P = 32 // C point slots of C column lanes, and in round r of a batch of
32 points slot p takes point r P + p, lane (p, k) adding its four
Keys-cubic taps (Horner weights of `taps()`, tfrac clamped to [-3, m + 1]
so that a tap off the grid, and every tap of padding or of a point off
the grid, lands in a padding cell) for column k into its own copy of the
m + 8 cells; cell c of column k then adds its P copies starting at copy
c mod P, and the chunks' partials in chunk order. The chunk is the
wrapper's (`cuda_interp.transpose_chunk`). The model is held against the
JAX package's Pallas kernel (`pallas_interp.transpose_call`, interpret
mode, at tests/test_pallas_interp.py's shapes, on points where the two
plans keep the same taps) and the port's plain version. The package does
not use the model: tests/test_torch_port_cuda.py holds the kernel itself
against the plain version on the card. Tolerance: rel <= 1e-5
(norm-wise); padding contributes exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_interp
from rpagp_torch.ops import cuda_interp

torch.set_num_threads(2)

LANES = 32
PAD = 4  # csrc/interp.cu K2_PAD: padding cells at each end of a copy


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _taps(tf, m):
    """(cells (.., 4), weights (.., 4)) of csrc/interp.cu taps(): tf
    clamped to [-3, m + 1] (NaN to -3), base cell floor, Horner weights;
    cell c of a padded copy at index c + PAD, so every tap lands in
    [0, m + 2 PAD) and one off the grid in the padding."""
    tf = torch.where(torch.isnan(tf), -3.0, tf).clamp(-3.0, m + 1.0)
    fl = torch.floor(tf)
    f = tf - fl
    g = 1.0 - f

    def inner(s):
        return ((1.5 * s - 2.5) * s) * s + 1.0

    def outer(s):
        return ((-0.5 * s + 2.5) * s - 4.0) * s + 2.0

    w = torch.stack([outer(1.0 + f), inner(f), inner(g), outer(1.0 + g)], -1)
    cells = fl.long()[..., None] + PAD - 1 + torch.arange(4)
    return cells, w


def _tiles(t):
    """(first column, width C) of K2's column tiles (csrc/interp.cu
    `rpagp_interp_transpose`): one column each at t <= 2, all t at
    t <= 32, else 32 columns and the rest."""
    width = 1 if t <= 2 else cuda_interp.K2_TILE
    return [(k0, min(width, t - k0)) for k0 in range(0, t, width)]


def _k2_model(tfrac, V, m, chunk):
    """U (J, t, m) by K2's arithmetic and summation order."""
    J, n = tfrac.shape
    t = V.shape[1]
    U = torch.zeros(J, t, m)
    jj = torch.arange(J)[:, None, None]
    cell = torch.arange(m)
    for start in range(0, n, chunk):
        end = min(n, start + chunk)
        part = torch.zeros(J, t, m)
        for k0, C in _tiles(t):
            P = LANES // C
            slot = torch.arange(P)
            kk = torch.arange(C)[None, None, :]
            acc = torch.zeros(J, P, C, m + 2 * PAD)  # lane (p, k)'s copy
            for base in range(start, end, LANES):
                for r in range(-(-LANES // P)):
                    off = r * P + slot  # slot p's point in the batch
                    i = base + off
                    valid = (off < LANES) & (i < end)
                    ic = i.clamp(max=n - 1)
                    tf = torch.where(valid, tfrac[:, ic],
                                     torch.tensor(-100.0))  # (J, P)
                    v = torch.where(valid[:, None], V[ic, k0:k0 + C],
                                    torch.zeros(()))  # (P, C)
                    cells, w = _taps(tf, m)  # (J, P, 4)
                    # a point's taps are distinct cells, the lanes' copies
                    # apart: each add below is one word's, in point order
                    for d in range(4):
                        acc[jj, slot[None, :, None], kk,
                            cells[..., d, None]] += (w[..., d, None]
                                                     * v[None])
            copies = acc.permute(0, 2, 1, 3)  # (J, C, P, m + 2 PAD)
            tile = torch.zeros(J, C, m)
            for u in range(P):  # cell c's copies from copy c mod P on
                tile = tile + copies[:, :, (cell + u) % P, cell + PAD]
            part[:, k0:k0 + C] = tile
        U = U + part
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
@pytest.mark.parametrize("t", [1, 2, 3, 8, 9, 11, 33])
@pytest.mark.parametrize("kind", ["crowded", "edges"])
def test_k2_model_matches_plain(m, t, kind):
    """Crowded points, the grid's edges and padding, m not a multiple of
    32 and m = 1024, t in {1, 2, 3, 8, 9, 11, 33} (one slot a lane at
    t = 1 and 2, slots of t column lanes with idle lanes at t = 3, 9, 11, a
    32-column tile and a one-column tile at t = 33), the wrapper's chunks
    (22 of 32 points): the model against the port's plain version in
    float64; padding rows contribute exactly zero (a huge V there leaves
    the model's output unchanged)."""
    rng = np.random.default_rng(m * 10 + t)
    J, n = 3, 700
    tf = torch.from_numpy(_tfrac(J, n, m, rng, kind))
    V = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    chunk = cuda_interp.transpose_chunk(J, n, t, m)
    assert -(-n // chunk) > 1
    got = _k2_model(tf, V, m, chunk)
    want = cuda_interp.interp_transpose_plain(tf.double(), V.double(), m)
    assert got.shape == (J, t, m)
    assert _rel(got, want) <= 1e-5
    if kind == "edges":
        V2 = V.clone()
        V2[-20:] = 1e6
        assert torch.equal(_k2_model(tf, V2, m, chunk), got)


@pytest.mark.parametrize("t", [1, 2, 3, 8, 9, 11, 33])
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
    got = _k2_model(torch.from_numpy(tf), torch.from_numpy(V), m,
                    cuda_interp.transpose_chunk(J, n, t, m))
    n_pad = -(-n // pallas_interp.BN) * pallas_interp.BN
    tfp = np.pad(tf, ((0, 0), (0, n_pad - n)), constant_values=-100.0)
    VT = np.pad(V.T, ((0, 0), (0, n_pad - n)))
    ref = pallas_interp.transpose_call(jnp.asarray(tfp), jnp.asarray(VT), m,
                                       interpret=True)
    plain = cuda_interp.interp_transpose_plain(torch.from_numpy(tf),
                                               torch.from_numpy(V), m)
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, plain) <= 1e-5
