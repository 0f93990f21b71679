"""K1's cooperative kernel on a batch (rpagp_torch/csrc/chol_linv_coop.cu),
modelled on the CPU.

The kernel cannot run here, so this file holds a torch model of its
schedule on B matrices, `_batch_schedule_model(T, G, C)`: the leaf's
32-wide panels and phases (tests/test_torch_port_chol_leaf.py models the
B = 1 case), C chain blocks carrying the matrices' diagonal chains
(block c those of matrices c, c + C, ...), and each phase's (matrix,
item) pairs dealt to the other G - C blocks in the kernel's interleaved
order, every block reading the state the last grid barrier left. The
model is held against the JAX package's fused batched Pallas kernel
(`pallas_chol.chol_linv_batched_fused`, interpret mode, as
tests/test_pallas_chol.py runs it); the dealing itself is checked in pure
Python. The package does not use the model: tests/test_torch_port_cuda.py
holds the kernel itself bit for bit against the one-block kernel on the
card. Tolerances: values rel <= 1e-5 (norm-wise), the reference's own
parity bar.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_chol
from test_torch_port_chol_leaf import (NB, _factor_diag,
                                       _holds_failure_contract, _phase_items,
                                       _rel, _sml_ladder_blocks,
                                       _solve_panel_rows, _spd)

torch.set_num_threads(2)

CHAIN = ("look", "dinv")  # the items a matrix's chain block carries


def _chains(B, gmax):
    """C, the chain blocks of a launch whose card holds gmax blocks:
    min(B, gmax // 2), at least 1 (rpagp_chol_linv_coop_grid)."""
    return min(B, max(1, gmax // 2))


def _grid(B, b, gmax):
    """(G, C) of the launch: G = min(gmax, C + the most items a phase
    deals out over the B matrices)."""
    C = _chains(B, gmax)
    most = max([0] + [B * (len(p) - sum(it[0] in CHAIN for it in p))
                      for kp in range(b // NB) for p in _phase_items(b, kp)])
    return min(gmax, C + most), C


def _deal_batch(B, phase, G, C):
    """The (matrix, item) pairs of one phase on each of G blocks: chain
    block c takes the chain items of matrices c, c + C, ...; pair W =
    B w + matrix of the other items goes to block C + W mod (G - C), or,
    with G = C, to block W mod G before its chain items."""
    chain = [it for it in phase if it[0] in CHAIN]
    rest = [it for it in phase if it[0] not in CHAIN]
    blocks = [[] for _ in range(G)]
    first = C if G > C else 0
    for W in range(B * len(rest)):
        blocks[first + W % (G - first)].append((W % B, rest[W // B]))
    for mt in range(B):
        blocks[mt % C] += [(mt, it) for it in chain]
    return blocks


def _batch_schedule_model(T, G, C, decouple=True):
    """(L, Linv, ok) of a (B, b, b) float32 tensor, b a multiple of 32, by
    the cooperative kernel's schedule on G blocks with C chain blocks.
    Every item of a phase reads a snapshot taken at the phase's start
    (what the grid barrier guarantees, and no more), and no tile is
    written twice in a phase. Each (matrix, panel)'s failed pivots go from
    its factor to the items that substitute its rows, which give them 0
    (decouple=False: the rule before the repair)."""
    B, b = T.shape[0], T.shape[-1]
    L, Linv = torch.tril(T).clone(), torch.zeros_like(T)
    ok = [True] * B
    fails = {}

    def t(M, mt, i, j):
        return M[mt, i * NB:(i + 1) * NB, j * NB:(j + 1) * NB]

    def factor(mt, k, S):
        D, fails[mt, k] = _factor_diag(S)
        t(L, mt, k, k)[:] = D
        ok[mt] = ok[mt] and not bool(fails[mt, k].any())

    def invert(mt, k, D):
        eye = torch.eye(NB, dtype=D.dtype)
        t(Linv, mt, k, k)[:] = torch.linalg.solve_triangular(D, eye,
                                                            upper=False)

    for mt in range(B):  # the chain blocks, beside the set-up
        factor(mt, 0, t(L, mt, 0, 0).clone())
        invert(mt, 0, t(L, mt, 0, 0))
    for kp in range(b // NB):
        for phase in _phase_items(b, kp):
            sL, sLinv = L.clone(), Linv.clone()
            written = []
            for items in _deal_batch(B, phase, G, C):
                for mt, (kind, i, *j) in items:
                    if kind in ("row", "look"):
                        P = _solve_panel_rows(t(sL, mt, kp, kp),
                                              t(sL, mt, i, kp),
                                              fails[mt, kp], decouple)
                        t(L, mt, i, kp)[:] = P
                        written.append((mt, "L", i, kp))
                        if kind == "look":
                            factor(mt, i, t(sL, mt, i, i) - P @ P.T)
                            written.append((mt, "L", i, i))
                    elif kind == "dinv":
                        invert(mt, i, t(sL, mt, i, i))
                        written.append((mt, "Linv", i, i))
                    elif kind == "inv":
                        t(Linv, mt, i, j[0])[:] = -(t(sLinv, mt, kp, kp)
                                                    @ t(sLinv, mt, i, j[0]))
                        written.append((mt, "Linv", i, j[0]))
                    elif kind == "trail":
                        t(L, mt, i, j[0])[:] = t(sL, mt, i, j[0]) - (
                            t(sL, mt, i, kp) @ t(sL, mt, j[0], kp).T)
                        written.append((mt, "L", i, j[0]))
                    else:  # "acc"
                        t(Linv, mt, i, j[0])[:] = t(sLinv, mt, i, j[0]) + (
                            t(sL, mt, i, kp) @ t(sLinv, mt, kp, j[0]))
                        written.append((mt, "Linv", i, j[0]))
            assert len(set(written)) == len(written)
    return L, Linv, torch.tensor(ok, dtype=T.dtype)


def _batch(b, bad=None):
    """Three SPD (b, b) matrices; matrix `bad`, if given, shifted so that
    its pivot 32 + 5 is the first to fail."""
    T = np.stack([_spd(b, seed=10 + s) for s in range(3)])
    if bad is not None:
        T[bad, NB + 5:, NB + 5:] -= 10.0 * np.eye(b - NB - 5, dtype=np.float32)
    return T


@functools.lru_cache(maxsize=None)
def _jax_batched(b, bad=None):
    """pallas_chol.chol_linv_batched_fused in interpret mode on _batch."""
    assert pallas_chol.fused_supported(3, b)
    L, Linv, ok = pallas_chol.chol_linv_batched_fused(
        jnp.asarray(_batch(b, bad)), True)
    return np.asarray(L), np.asarray(Linv), np.asarray(ok)


# ------------------------------------------------------------ tests ----


@pytest.mark.parametrize("G,C", [(1, 1), (4, 3), (5, 2), (40, 3)])
@pytest.mark.parametrize("b", [64, 96])
def test_batch_model_matches_pallas_kernel(b, G, C):
    """B = 3: one block for everything; every matrix's chain on a block of
    its own with one or two workers; two chain blocks, one of them
    carrying two matrices; and more blocks than the largest phase has
    items (idle blocks)."""
    T = torch.from_numpy(_batch(b))
    L, Linv, ok = _batch_schedule_model(T, G, C)
    Lj, Linvj, okj = _jax_batched(b)
    assert ok.tolist() == [1.0, 1.0, 1.0] and okj.tolist() == [1.0] * 3
    for mt in range(3):
        assert _rel(L[mt], Lj[mt]) <= 1e-5
        assert _rel(Linv[mt], Linvj[mt]) <= 1e-5
    assert float(torch.max(torch.abs(torch.triu(L, 1)))) == 0.0


@pytest.mark.parametrize("bad", [0, 1, 2])
def test_batch_model_indefinite_matrix(bad):
    """One matrix of three fails its pivot 37 (panel 1 of 3 at b = 96): its
    ok is 0 as the Pallas kernel says, every output is finite, and the
    other two matrices are exactly the model's outputs on the SPD batch
    (a matrix's arithmetic never reads another's)."""
    T = torch.from_numpy(_batch(96, bad))
    L, Linv, ok = _batch_schedule_model(T, 5, 2)
    okj = _jax_batched(96, bad)[2]
    want = [0.0 if mt == bad else 1.0 for mt in range(3)]
    assert ok.tolist() == want and okj.tolist() == want
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())
    L0, Linv0, _ = _batch_schedule_model(torch.from_numpy(_batch(96)), 5, 2)
    keep = [mt for mt in range(3) if mt != bad]
    assert torch.equal(L[keep], L0[keep])
    assert torch.equal(Linv[keep], Linv0[keep])


def test_batch_model_on_failing_ladder_blocks():
    """Three of the sml SKI model's (512, 512) Toeplitz blocks at the base
    jitter, where every block fails a pivot, on the launch an H100 gives
    B = 3 at b = 512 (three chain blocks): ok = 0 for each, as the fused
    Pallas kernel says (interpret mode), and the repaired failure contract
    holds on each (finite outputs, the factor up to the first failing
    pivot, the factor of the decoupled matrix, Linv its inverse). Without
    the repair, the panel rows keep W's residual in a failed pivot's
    column, the trailing update subtracts a column the diagonal tile never
    eliminated, and the outputs overflow: the fault both CUDA kernels had
    at (20, 512, 512)."""
    T = torch.from_numpy(_sml_ladder_blocks((0, 7, 13)))
    G, C = _grid(3, 512, 132)
    assert C == 3
    L, Linv, ok = _batch_schedule_model(T, G, C)
    okj = np.asarray(pallas_chol.chol_linv_batched_fused(jnp.asarray(T.numpy()),
                                                        True)[2])
    assert ok.tolist() == [0.0] * 3 and okj.tolist() == [0.0] * 3
    for mt in range(3):
        _holds_failure_contract(T[mt], L[mt], Linv[mt])
    L0, Linv0, ok0 = _batch_schedule_model(T, G, C, decouple=False)
    assert ok0.tolist() == [0.0] * 3
    for mt in range(3):
        assert not bool(torch.isfinite(L0[mt]).all()
                        and torch.isfinite(Linv0[mt]).all())


@pytest.mark.parametrize("B,b,gmax", [(1, 512, 132), (3, 96, 132),
                                      (20, 256, 132), (20, 256, 24),
                                      (65, 64, 132), (65, 256, 132),
                                      (3, 128, 1), (200, 64, 132)])
def test_every_pair_dealt_to_exactly_one_block(B, b, gmax):
    """Per panel and phase, the (matrix, item) pairs dealt to the G blocks
    cover every item of every matrix exactly once; no worker item goes to
    a chain block while there are workers, and the workers' shares differ
    by at most one pair; each matrix's chain items sit on block
    matrix mod C; and a worker block takes pairs of several matrices
    wherever it takes more than one pair, B > 1 and B does not divide the
    worker count (pair W is on matrix W mod B)."""
    G, C = _grid(B, b, gmax)
    assert 1 <= C <= min(B, G) and G <= gmax
    for kp in range(b // NB):
        for phase in _phase_items(b, kp):
            dealt = _deal_batch(B, phase, G, C)
            assert len(dealt) == G
            seen = [(mt, it) for items in dealt for mt, it in items]
            assert sorted(seen) == sorted((mt, it) for mt in range(B)
                                          for it in phase)
            assert len(set(seen)) == len(seen)
            for g, items in enumerate(dealt):
                for mt, it in items:
                    if it[0] in CHAIN:
                        assert g == mt % C
                    elif G > C:
                        assert g >= C
            if G > C:
                sizes = [len(items) for items in dealt[C:]]
                assert max(sizes) - min(sizes) <= 1
                for items in dealt[C:]:
                    if len(items) > 1 and B > 1 and (G - C) % B:
                        assert len({mt for mt, _ in items}) > 1


def test_flagship_ladder_launch():
    """The ladder's (20, 256, 256) on an H100 (one 256-thread block an SM,
    132 SMs): 20 chain blocks and 112 workers, the largest phase (panel 0's
    phase B) dealing 34 pairs a matrix, 680 in all; and the leaf's launch
    is unchanged, G = 132 with one chain block."""
    assert _grid(20, 256, 132) == (132, 20)
    pb = _phase_items(256, 0)[1]
    assert len([it for it in pb if it[0] not in CHAIN]) == 34
    assert _grid(1, 512, 132) == (132, 1)
