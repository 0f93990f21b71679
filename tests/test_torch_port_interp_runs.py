"""K2's runs route (rpagp_torch/csrc/interp.cu `transpose_slots_kernel_runs`),
modelled on the CPU.

The kernel cannot run here, so this file holds a model of what it computes
and in which order, `runs_model(tfrac, V, m, chunk)`: a block a
(component, chunk of points), all C <= RUNS_C_MAX columns (the model takes
wider V in blocks of RUNS_C_MAX columns), the chunk in tiles of RUNS_T
points; each tile
counting-sorted by base cell (tfrac clamped to [-3, m + 1], NaN to -3, bin
floor + 3 of m + 5), stably, in point order within a bin; the entries of
bins 1 .. m + 3 split evenly among RUNS_NT threads; each thread adds its
pieces (runs of one bin inside its entries) in entry order, w_k(frac) V
for the 4 taps and C columns, on top of the block's per-(bin, tap,
column) sum S[bin], which holds the earlier tiles' runs; a piece that
continues a run from the thread before starts from zero, and the piece
that starts the run adds those of the next threads in thread order; at the
chunk's end cell c takes tap k's sum of bin c + 4 - k, in tap order, and
the chunks' partials add in chunk order. The wrapper takes this route
where `cuda_interp.runs_route` says (t <= 2 take the own route and the
rest the slots route, which tests/test_torch_port_interp_scatter.py
models). The model is held against the port's plain version in float64
and the JAX package's Pallas kernel in interpret mode (rel <= 1e-5,
norm-wise); padding, NaN and points off the grid add exactly zero.
tests/test_torch_port_cuda.py holds the kernel itself against the plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_interp
from rpagp_torch.ops import cuda_interp

T, NT = cuda_interp.RUNS_T, cuda_interp.RUNS_NT


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _weights(f):
    """taps()'s Horner weights of frac f (float32), (.., 4)."""
    g = np.float32(1.0) - f

    def inner(s):
        return ((np.float32(1.5) * s - np.float32(2.5)) * s) * s + 1

    def outer(s):
        return ((np.float32(-0.5) * s + np.float32(2.5)) * s - 4) * s + 2

    return np.stack([outer(1 + f), inner(f), inner(g), outer(1 + g)],
                    -1).astype(np.float32)


def _sort_tile(tf, m):
    """(bins, clamped tfrac, local rows) of one tile's points in the
    kernel's sorted order: a stable counting sort by bin."""
    tc = np.where(np.isnan(tf), np.float32(-3.0),
                  np.clip(tf, -3.0, m + 1.0)).astype(np.float32)
    bins = np.floor(tc).astype(np.int64) + 3
    order = np.argsort(bins, kind="stable")
    return bins[order], tc[order], order


def _tile_runs(S, bins, tc, rows, Vt, m):
    """Adds one sorted tile's runs into S (m + 5 bins, 4 taps, C), as the
    kernel's threads do."""
    nb = m + 5
    lo = int(np.searchsorted(bins, 1))
    hi = int(np.searchsorted(bins, nb - 1))
    L = hi - lo
    seg = [lo + l * L // NT for l in range(NT + 1)]
    fl = np.floor(tc)
    prods = (_weights((tc - fl).astype(np.float32))[:, :, None]
             * Vt[rows][:, None, :])  # (E, 4, C), float32
    hb, owners = {}, []
    for l in range(NT):
        s, e1 = seg[l], seg[l + 1]
        if s == e1:
            continue
        cin = s > lo and bins[s - 1] == bins[s]
        cout = e1 < hi and bins[e1] == bins[e1 - 1]
        first, a = True, s
        while a < e1:  # the pieces of [s, e1), each summed in entry order
            b = a
            while b < e1 and bins[b] == bins[a]:
                b += 1
            if first and cin:  # from zero, for the run's first thread
                hb[l] = np.cumsum(prods[a:b], axis=0, dtype=np.float32)[-1]
            else:  # on top of S[bin]
                piece = np.cumsum(np.concatenate([S[bins[a]][None],
                                                  prods[a:b]]), axis=0,
                                  dtype=np.float32)[-1]
                if b == e1 and cout:
                    owners.append((l, bins[a], piece))
                else:
                    S[bins[a]] = piece
            first, a = False, b
    for l, b, acc in owners:  # the first thread adds the others' pieces
        for l2 in range(l + 1, NT):
            if seg[l2 + 1] == seg[l2]:
                continue
            if bins[seg[l2]] != b:
                break
            acc = acc + hb[l2]
        S[b] = acc


def runs_model(tfrac, V, m, chunk):
    """U (J, t, m) by the runs route's arithmetic and summation order
    (float32), on blocks of up to RUNS_C_MAX of the t columns (the kernel
    takes one such block, all t <= RUNS_C_MAX columns of a call)."""
    tfrac, V = np.asarray(tfrac, np.float32), np.asarray(V, np.float32)
    J, n = tfrac.shape
    t = V.shape[1]
    U = np.zeros((J, t, m), np.float32)
    for k0 in range(0, t, cuda_interp.RUNS_C_MAX):
        C = min(cuda_interp.RUNS_C_MAX, t - k0)
        cols = np.zeros((J, C, m), np.float32)
        for start in range(0, n, chunk):
            end = min(n, start + chunk)
            for j in range(J):
                S = np.zeros((m + 5, 4, C), np.float32)
                for t0 in range(start, end, T):
                    t1 = min(end, t0 + T)
                    tf = np.full(T, -100.0, np.float32)  # empty slots: bin 0
                    tf[:t1 - t0] = tfrac[j, t0:t1]
                    Vt = np.zeros((T, C), np.float32)
                    Vt[:t1 - t0] = V[t0:t1, k0:k0 + C]
                    _tile_runs(S, *_sort_tile(tf, m), Vt, m)
                c = np.arange(m)
                part = ((S[c + 4, 0] + S[c + 3, 1]) + S[c + 2, 2]) + S[c + 1, 3]
                cols[j] += part.T
        U[:, k0:k0 + C] = cols
    return U


def _tfrac(J, n, m, rng, kind):
    tf = rng.uniform(0.0, m - 1.0, (J, n))
    if kind == "one_cell":  # the first tile all in one cell
        tf[:, :T] = m / 2 + 0.3 + 0.5 * rng.random((J, T))
    elif kind == "crowded":  # three cells
        tf = rng.choice([m / 2 - 0.7, m / 2 + 0.2, m / 2 + 1.45], (J, n))
        tf = tf + 0.01 * rng.random((J, n))
    elif kind == "gaussian":  # the flagship's: a normal over the grid
        tf = np.clip(m / 2 + m / 8 * rng.standard_normal((J, n)), 1.0, m - 2)
    elif kind == "edges":  # the grid's edges, off it, NaN, -100 padding
        tf = rng.uniform(-3.0, m + 2.0, (J, n))
        tf[:, :12] = [-2.5, -1.5, -0.25, 0.0, m - 2.0, m - 1.0, m - 0.5,
                      m + 0.5, -1e6, 1e6, m + 7.0, np.nan]
        tf[:, -20:] = -100.0
    return tf.astype(np.float32)


@pytest.mark.parametrize("t", [3, 9, 11, 32, 33])
@pytest.mark.parametrize("kind", ["gaussian", "one_cell", "edges"])
def test_runs_model_matches_plain(t, kind):
    """n = 2,500 (a ragged last tile of 452 points; n not a multiple of
    RUNS_T), m = 40 (runs of ~60 points, split between many threads), a
    chunk of two tiles: the model against the plain version in float64;
    points off the grid, NaN and -100 padding add exactly zero (a huge V
    there leaves the model's output unchanged)."""
    rng = np.random.default_rng(t * 7 + len(kind))
    J, n, m = 2, 2500, 40
    tf = _tfrac(J, n, m, rng, kind)
    V = rng.standard_normal((n, t)).astype(np.float32)
    chunk = 2 * T
    got = runs_model(tf, V, m, chunk)
    tfp = torch.from_numpy(np.nan_to_num(tf, nan=-100.0)).double()
    want = cuda_interp.interp_transpose_plain(tfp, torch.from_numpy(V).double(),
                                              m)
    assert _rel(got, want) <= 1e-5
    if kind == "edges":
        off = ~((tf >= -2.0) & (tf <= m + 1.0)).any(0)  # off in every component
        assert off[-20:].all() and off.sum() >= 21
        V2 = V.copy()
        V2[off] = 1e6
        assert np.array_equal(runs_model(tf, V2, m, chunk), got)


@pytest.mark.parametrize("chunk", [T, 2 * T, 3 * T])
def test_runs_model_chunks(chunk):
    """The chunks' partials add to the same U at any chunk (one, two or
    three tiles a chunk), within float32 rounding of the plain version."""
    rng = np.random.default_rng(chunk)
    J, n, m, t = 2, 3 * T + 5, 64, 9
    tf = _tfrac(J, n, m, rng, "gaussian")
    V = rng.standard_normal((n, t)).astype(np.float32)
    got = runs_model(tf, V, m, chunk)
    want = cuda_interp.interp_transpose_plain(torch.from_numpy(tf).double(),
                                              torch.from_numpy(V).double(), m)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("t", [3, 9, 11, 32, 33])
def test_runs_model_matches_pallas(t):
    """test_pallas_interp's shape (J = 3, n = 1000, m = 64), points on
    [0, m - 1) where the Pallas plan and the dense plan keep the same taps,
    plus three crowded cells: the Pallas kernel in interpret mode and the
    port's plain version against the model."""
    rng = np.random.default_rng(t)
    J, n, m = 3, 1000, 64
    tf = rng.uniform(0.0, m - 1.0, (J, n)).astype(np.float32)
    tf[:, :300] = _tfrac(J, 300, m, rng, "crowded")
    V = rng.standard_normal((n, t)).astype(np.float32)
    got = runs_model(tf, V, m, T)
    n_pad = -(-n // pallas_interp.BN) * pallas_interp.BN
    tfp = np.pad(tf, ((0, 0), (0, n_pad - n)), constant_values=-100.0)
    VT = np.pad(V.T, ((0, 0), (0, n_pad - n)))
    ref = pallas_interp.transpose_call(jnp.asarray(tfp), jnp.asarray(VT), m,
                                       interpret=True)
    plain = cuda_interp.interp_transpose_plain(torch.from_numpy(tf),
                                               torch.from_numpy(V), m)
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, plain) <= 1e-5


def test_routes_and_tiles():
    """The wrapper's mirror of the C entry's routing: own at t <= 2, runs
    at the cell's shape (J = 20, n = 1,844,352, m = 256, t = 9) and at
    sml's t = 11 on 20,000 points, slots where the runs blocks would not
    fill the card (sml's 3,723 points) or t passes runs_width(m) (the
    posteriors' t = 512, 513: 32-column tiles, the rest of one on own);
    every runs block within a block's shared memory; the flagship's
    partial sums no larger than the slots route's 79 chunks."""
    flag = (20, 1_844_352)
    assert cuda_interp.transpose_route(*flag, 1, 256) == "own"
    assert cuda_interp.transpose_route(*flag, 2, 256) == "own"
    assert cuda_interp.transpose_tiles(*flag, 9, 256) == [("runs", 0, 9)]
    assert cuda_interp.transpose_tiles(20, 20_000, 11, 512) == [("runs", 0, 11)]
    assert cuda_interp.transpose_route(20, 3723, 11, 512) == "slots"
    assert cuda_interp.transpose_route(*flag, 512, 256) == "slots"
    assert cuda_interp.transpose_route(*flag, 513, 256) == "own+slots"
    for m in (17, 64, 256, 512, 1000, cuda_interp.M_MAX):
        w = cuda_interp.runs_width(m)
        assert 9 <= w <= cuda_interp.RUNS_C_MAX
        assert cuda_interp._runs_smem(m, w) + 1024 <= cuda_interp._K2_SMEM_BLOCK
        for J, n in ((1, 1000), (20, 3723), (5, 60_000), flag):
            for t in (1, 2, 3, 9, 11, 16, 17, 33, 257, 512, 513):
                tiles = cuda_interp.transpose_tiles(J, n, t, m)
                assert [k0 for _, k0, _ in tiles] == list(
                    np.cumsum([0] + [c for _, _, c in tiles])[:-1])
                assert sum(c for _, _, c in tiles) == t
                assert all(c == 1 for r, _, c in tiles if r == "own")
                assert all(c == t <= w for r, _, c in tiles if r == "runs")
                assert all(2 <= c <= 32 for r, _, c in tiles if r == "slots")
    J, n, m, t = 20, 1_844_352, 256, 9
    chunk = cuda_interp.transpose_chunk(J, n, t, m)
    assert chunk % T == 0 and -(-n // chunk) <= 79
