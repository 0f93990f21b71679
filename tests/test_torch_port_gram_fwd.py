"""K4's forward arithmetic (rpagp_torch/csrc/gram_mvm.cu), modelled on the CPU.

The kernel cannot run here, so this file holds a torch model of what it
computes and in which order, `_k4_model(z1, z2, w, V, base, S)`: the
coordinates prescaled per base so that k1d is one 2^x of d' = c z1 - c z2
(rbf 2^(-d'^2); the Matern bases 2^(-|d'|) times their polynomial in
s = |d'| ln 2, with w_j folded in), the Gram tile's values summed over
the components in order, each of the 16 lanes of a row group contracting
its columns (tx, tx + 16, ...) of every 64-wide z2 tile of its chunk with
V, the lanes added by the kernel's butterfly, and the S chunks' partial
sums added in chunk order. The model is held against the JAX package's
Pallas kernel (`pallas_gram.projected_gram_mvm`, interpret mode, at
tests/test_pallas_gram.py's shapes) and the port's plain version. The
package does not use the model: tests/test_torch_port_cuda.py holds the
kernel itself against the plain version on the card. Tolerance: values
rel <= 1e-5 (norm-wise), the reference's own parity bar.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_gram
from rpagp_torch.ops import cuda_gram

torch.set_num_threads(2)

TILE = 64  # the kernel's Gram tile: 64 rows by 64 z2 columns
LANES = 16  # threads of a row group, lane tx holding columns tx + 16 q
LN2 = math.log(2.0)
LOG2E = 1.0 / LN2
SCALE = {"rbf": math.sqrt(LOG2E / 2.0), "matern12": LOG2E,
         "matern32": math.sqrt(3.0) * LOG2E,
         "matern52": math.sqrt(5.0) * LOG2E}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _weighted_k1d(base, d, wj):
    """w_j k1d on prescaled differences d', as the kernel evaluates it."""
    f32 = torch.float32
    if base == "rbf":
        return wj * torch.exp2(-d * d)
    a = torch.abs(d)
    e = torch.exp2(-a)
    if base == "matern12":
        return wj * e
    wl = wj * torch.tensor(LN2, dtype=f32)
    if base == "matern32":
        return (a * wl + wj) * e
    w2 = wj * torch.tensor(LN2 * LN2 / 3.0, dtype=f32)
    return (a * (a * w2 + wl) + wj) * e


def _k4_model(z1, z2, w, V, base, S):
    """out = K V by K4's arithmetic and summation order, S z2 chunks."""
    c = torch.tensor(SCALE[base], dtype=torch.float32)
    a, bz = c * z1, c * z2
    n, m, t = z1.shape[0], z2.shape[0], V.shape[1]
    LT = -(-m // TILE)
    lane = torch.arange(TILE) % LANES
    out = torch.empty(n, t)
    for r0 in range(0, n, TILE):
        rows = a[r0:r0 + TILE]
        chunks = []
        for s in range(S):
            acc = torch.zeros(LANES, rows.shape[0], t)
            for lt in range(s * LT // S, (s + 1) * LT // S):
                l0 = lt * TILE
                cols = bz[l0:l0 + TILE]
                ks = torch.zeros(rows.shape[0], cols.shape[0])
                for j in range(z1.shape[1]):
                    d = rows[:, j, None] - cols[None, :, j]
                    ks = ks + _weighted_k1d(base, d, w[j])
                Vt = V[l0:l0 + TILE]
                for tx in range(LANES):
                    sel = lane[:cols.shape[0]] == tx
                    acc[tx] += ks[:, sel] @ Vt[sel]
            for h in (8, 4, 2, 1):  # the butterfly: every lane, one total
                acc = acc + acc[torch.arange(LANES) ^ h]
            chunks.append(acc[0])
        total = chunks[0]
        for part in chunks[1:]:
            total = total + part
        out[r0:r0 + TILE] = total
    return out


def _inputs(n, m, t, J, seed):
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((n, J)).astype(np.float32)
    z2 = rng.standard_normal((m, J)).astype(np.float32)
    z2[:5] = z1[:5]  # coincident points: d = 0
    w = (0.2 + rng.random(J)).astype(np.float32)
    V = rng.standard_normal((m, t)).astype(np.float32)
    return z1, z2, w, V


@pytest.mark.parametrize("base", cuda_gram.BASES)
@pytest.mark.parametrize("shape,S", [((40, 30, 3), 1), ((300, 530, 5), 1),
                                     ((300, 530, 5), 4)],
                         ids=["small", "ragged", "ragged-4-chunks"])
def test_k4_model_matches_pallas_and_plain(base, shape, S):
    """test_pallas_gram's shapes (J = 6): the Pallas forward kernel in
    interpret mode and the port's plain version (accurate exp, no
    prescale) against the model, with one z2 chunk and with four (530
    columns are 9 tiles, chunks of 2 and 3)."""
    n, m, t = shape
    z1, z2, w, V = _inputs(n, m, t, 6, seed=n + m)
    got = _k4_model(*(torch.from_numpy(x) for x in (z1, z2, w, V)), base, S)
    ref = pallas_gram.projected_gram_mvm(jnp.asarray(z1), jnp.asarray(z2),
                                         jnp.asarray(w), jnp.asarray(V),
                                         base=base, interpret=True)
    plain = cuda_gram.gram_mvm_plain(*(torch.from_numpy(x)
                                       for x in (z1, z2, w, V)), base)
    assert got.shape == (n, t)
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, plain) <= 1e-5


@pytest.mark.parametrize("base", cuda_gram.BASES)
def test_prescaled_exp2_matches_k1d(base):
    """One 2^x of the prescaled difference is k1d of the difference, to f32
    rounding, over the range where k1d is above the flush at 2^-126."""
    d = torch.linspace(-8.0, 8.0, 4001)
    c = torch.tensor(SCALE[base], dtype=torch.float32)
    got = _weighted_k1d(base, c * d - c * torch.zeros_like(d),
                        torch.tensor(1.0))
    want = cuda_gram.k1d_tile(base, d.double()).float()
    assert float(torch.max(torch.abs(got - want))) <= 4e-7


def test_z2_chunks_fill_the_grid():
    """The wrapper's choice of z2 chunks: at the BBMM training shape
    (14,939 rows and columns, 234 tiles each) on a card holding 264 blocks
    (two an SM of an H100) 9 chunks fill 2,106 of 2,112 slots; at the
    posterior's cross product (1,660 rows, 26 tiles, one 256-column slab)
    with 132 blocks 5 chunks fill 130 of 132; one row tile and one column
    tile leave nothing to split; and every choice stays within the z2
    tiles and MAX_CHUNKS."""
    assert cuda_gram.z2_chunks(234, 234, 264) == 9
    assert cuda_gram.z2_chunks(26, 234, 132) == 5
    assert cuda_gram.z2_chunks(1, 1, 264) == 1
    for units, tiles, G in [(16, 13, 264), (3, 2, 132), (500, 500, 264),
                            (7, 40, 1000)]:
        S = cuda_gram.z2_chunks(units, tiles, G)
        assert 1 <= S <= min(tiles, cuda_gram.MAX_CHUNKS)
