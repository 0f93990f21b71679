"""K1's leaf kernel (rpagp_torch/csrc/chol_linv_leaf.cu), modelled on the CPU.

The kernel cannot run here, so this file holds a torch model of its
schedule, `_leaf_schedule_model(A, G)`: the same 32-wide panels, the same
phases and the same dealing of each phase's tiles to G blocks, every
block reading the state as the previous grid barrier left it. The model
is held against the JAX package's Pallas kernel (interpret mode) and the
port's plain version; the dealing itself is checked in pure Python. The
package does not use the model: tests/test_torch_port_cuda.py holds the
kernel itself against the plain version and the one-block kernel on the
card. Tolerances: values rel <= 1e-5 (norm-wise), as the reference's own
parity bar.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpagp.ops import pallas_chol
from rpagp_torch.ops import cuda_chol

torch.set_num_threads(2)

NB = 32  # the kernel's panel width


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _spd(b, seed, jitter=0.5):
    B = np.random.default_rng(seed).standard_normal((b, b)).astype(np.float32)
    A = B @ B.T / b + jitter * np.eye(b, dtype=np.float32)
    return (0.5 * (A + A.T)).astype(np.float32)


def _indefinite(b, panel, seed=0):
    """SPD but for a shift that makes pivot s = 32 panel + 5 the first to
    fail; the leading s x s block is untouched. Returns (A, s)."""
    A = _spd(b, seed)
    s = NB * panel + 5
    A[s:, s:] -= 10.0 * np.eye(b - s, dtype=np.float32)
    return A, s


# ------------------------------------------------------ the schedule ----


def _phase_items(b, kp):
    """The items of phases A and B of panel kp, in the kernel's order:
    ("look", kp+1) row tile kp+1, its trailing tile (kp+1, kp+1) and that
    tile's factor, the next panel's D; ("row", ti) the panel rows of row
    tile ti; ("inv", kp, cj) the inverse tile finished from its
    accumulator; ("dinv", kp+1) the next panel's D^{-1}; ("trail", ti, tk)
    a lower trailing tile; ("acc", k, cj) a term added to the inverse
    tile's accumulator."""
    T = b // NB - 1 - kp
    pa = ([("look", kp + 1)] if T > 0 else []) + (
        [("row", kp + 1 + w) for w in range(1, T)]
        + [("inv", kp, cj) for cj in range(kp)])
    pb = ([("dinv", kp + 1)] if T > 0 else []) + (
        [("trail", kp + 1 + i, kp + 1 + j) for i in range(T)
         for j in range(i + 1)][1:]
        + [("acc", kp + 1 + v // (kp + 1), v % (kp + 1))
           for v in range(T * (kp + 1))])
    return pa, pb


def _deal(items, G):
    """The items of each of G blocks: block 0 takes the diagonal chain
    (look-ahead, inverse), the others the rest in turn, g, g + (G-1), ...;
    with G = 1, block 0 takes the rest first."""
    chain = [it for it in items if it[0] in ("look", "dinv")]
    rest = [it for it in items if it[0] not in ("look", "dinv")]
    if G == 1:
        return [rest + chain]
    return [chain] + [rest[g::G - 1] for g in range(G - 1)]


def _max_blocks(b):
    """1 + the most items a phase deals to blocks 1 .. G-1."""
    return 1 + max([0] + [len(p) - 1 for kp in range(b // NB - 1)
                          for p in _phase_items(b, kp)])


def _factor_diag(S):
    """(D, fail) of a diagonal 32x32 tile, column by column, with the
    unit-column contract on a pivot d <= 0 (or NaN): fail (32,) bool marks
    the failed pivots."""
    S = S.clone()
    D = torch.zeros_like(S)
    fail = torch.zeros(NB, dtype=torch.bool)
    for j in range(NB):
        d = S[j, j]
        col = torch.zeros(NB, dtype=S.dtype)
        if bool(d > 0):
            col[j:] = S[j:, j] * (1.0 / torch.sqrt(d))
        else:
            col[j] = 1.0
            fail[j] = True
        S[j + 1:, j + 1:] -= torch.outer(col[j + 1:], col[j + 1:])
        D[:, j] = col
    return D, fail


def _solve_panel_rows(D, W, fail, decouple=True):
    """W D^{-T} (the rows of a row tile against the panel's diagonal tile),
    with 0 in the failed pivots' columns: the kernels' rule, which
    decouples a failed pivot's column from the panel rows as the unit
    column decouples it from the tile's own rows. decouple=False leaves
    W's residual there (the rule before the repair)."""
    P = torch.linalg.solve_triangular(D, W.T, upper=False).T
    if decouple:
        P[:, fail] = 0.0
    return P


def _leaf_schedule_model(A, G, decouple=True):
    """(L, Linv, ok) of one (b, b) float32 tensor, b a multiple of 32, by
    the leaf kernel's schedule on G blocks. Every item of a phase reads a
    snapshot taken at the phase's start (what the grid barrier
    guarantees, and no more), and no tile is written twice in a phase.
    A panel's failed pivots go from its factor to the items that
    substitute its rows (the kernel's `fail` masks)."""
    b = A.shape[0]
    L, Linv = torch.tril(A).clone(), torch.zeros_like(A)
    fails = {}

    def t(M, i, j):
        return M[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB]

    def factor(k, S):  # D of S into the diagonal tile k of L
        D, fails[k] = _factor_diag(S)
        t(L, k, k)[:] = D
        return not bool(fails[k].any())

    def invert(k, D):  # D^{-1} into the diagonal tile k of Linv
        eye = torch.eye(NB, dtype=D.dtype)
        t(Linv, k, k)[:] = torch.linalg.solve_triangular(D, eye, upper=False)

    ok = factor(0, t(L, 0, 0).clone())  # on block 0, beside the set-up
    invert(0, t(L, 0, 0))
    for kp in range(b // NB):
        for phase in _phase_items(b, kp):
            sL, sLinv = L.clone(), Linv.clone()
            written = []
            for items in _deal(phase, G):
                for kind, i, *j in items:
                    if kind in ("row", "look"):  # W D^{-T}, by substitution
                        P = _solve_panel_rows(t(sL, kp, kp), t(sL, i, kp),
                                              fails[kp], decouple)
                        t(L, i, kp)[:] = P
                        written.append(("L", i, kp))
                        if kind == "look":
                            ok = factor(i, t(sL, i, i) - P @ P.T) and ok
                            written.append(("L", i, i))
                    elif kind == "dinv":
                        invert(i, t(sL, i, i))
                        written.append(("Linv", i, i))
                    elif kind == "inv":
                        t(Linv, i, j[0])[:] = -(t(sLinv, kp, kp)
                                                @ t(sLinv, i, j[0]))
                        written.append(("Linv", i, j[0]))
                    elif kind == "trail":
                        t(L, i, j[0])[:] = t(sL, i, j[0]) - (
                            t(sL, i, kp) @ t(sL, j[0], kp).T)
                        written.append(("L", i, j[0]))
                    else:  # "acc"
                        t(Linv, i, j[0])[:] = t(sLinv, i, j[0]) + (
                            t(sL, i, kp) @ t(sLinv, kp, j[0]))
                        written.append(("Linv", i, j[0]))
            assert len(set(written)) == len(written)
    return L, Linv, ok


@functools.lru_cache(maxsize=None)
def _sml_ladder_blocks(idx):
    """Blocks idx of the (20, 512, 512) Toeplitz batch that the exact grid
    solver's ladder factors first for rp_poly_j20_ski (J = 20 degree-1 RBF,
    m = 512) on synthetic sml split 0, at the port's initial params
    (projection seed 0) and the base jitter: every block fails a pivot
    there (they are numerically rank ~70), so they hold K1's failure rule
    at b = 512. numpy float32, (len(idx), 512, 512)."""
    import dataclasses
    import os

    from rpagp_torch.models import exact_gp
    from rpagp_torch.ops import grid_solve, ski
    from rpagp_torch.utils import datasets
    from rpagp_torch.utils.config import load_spec

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = load_spec(os.path.join(root, "specs", "rp_poly_j20_ski.json")).model
    spec = dataclasses.replace(spec, solver="grid")
    split = next(datasets.kfold_splits(datasets.load_dataset("sml"), k=10,
                                       seed=0, equal_train=True))
    x = torch.as_tensor(split.train_x)
    params, buffers = exact_gp.init_model(
        spec, x.shape[1], generator=torch.Generator().manual_seed(0),
        device="cpu")
    state = ski.build_ski(spec.kernel, params["kernel"], buffers["kernel"], x,
                          spec.kernel.grid_size)
    T = grid_solve._toeplitz_blocks(spec.kernel, params["kernel"], state)
    T = T[list(idx)]
    eye = torch.eye(T.shape[-1])
    return (T + (spec.grid_jitter * T[:, 0, 0])[:, None, None] * eye).numpy()


def _failed_columns(L):
    """The columns of a factor that the failure rule decoupled: a unit
    diagonal and exact zeros below it."""
    below = torch.tril(L, -1)
    return [j for j in range(L.shape[0])
            if float(L[j, j]) == 1.0 and float(below[:, j].abs().max()) == 0.0]


def _holds_failure_contract(A, L, Linv):
    """The repaired failure contract on one failed (b, b) matrix, to the
    backward-error bar b * eps (f32): every output finite; the factor of A's
    leading block up to the first failing pivot s (L L^T = A[:s, :s]);
    L on the other rows and columns N is the Cholesky factor of A[N, N]
    (each failed pivot's row and column taken out); Linv = L^{-1}.
    Returns s. (An f32 factor of these blocks sits ~kappa(A) eps ~ 1e-3
    from the exact one, so the bar is on the residuals, as for the
    plain version itself.)"""
    b = A.shape[0]
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())
    Ld, Ad, eye = L.double(), A.double(), torch.eye(b, dtype=torch.float64)
    F = _failed_columns(L)
    s = F[0]
    lead = Ld[:s, :s] @ Ld[:s, :s].T - Ad[:s, :s]
    assert float(torch.linalg.norm(lead) / torch.linalg.norm(Ad[:s, :s])) \
        <= b * 2.0**-24
    N = torch.tensor([j for j in range(b) if j not in set(F)])
    LN, AN = Ld[N][:, N], Ad[N][:, N]
    assert float(torch.linalg.norm(LN @ LN.T - AN) / torch.linalg.norm(AN)) \
        <= b * 2.0**-24
    res = torch.linalg.norm(Ld @ Linv.double() - eye)
    assert float(res / (torch.linalg.norm(Ld) * torch.linalg.norm(
        Linv.double()))) <= b * 2.0**-24
    return s


@functools.lru_cache(maxsize=None)
def _jax_chol_linv(b, panel=None):
    """pallas_chol.chol_linv in interpret mode on _spd(b, 0), or on the
    input of _indefinite(b, panel)."""
    A = _spd(b, 0) if panel is None else _indefinite(b, panel)[0]
    L, Linv, ok = pallas_chol.chol_linv(jnp.asarray(A), True)
    return np.asarray(L), np.asarray(Linv), float(ok)


# ------------------------------------------------------------ tests ----


@pytest.mark.parametrize("G", [1, 7, 120])
@pytest.mark.parametrize("b", [64, 128, 256])
def test_leaf_model_matches_pallas_kernel(b, G):
    """b <= 128 reaches pallas_chol's `_leaf_kernel`, b = 256 its 128-wide
    `_panel_kernel`; G = 120 leaves blocks idle at every size here."""
    L, Linv, ok = _leaf_schedule_model(torch.from_numpy(_spd(b, 0)), G)
    Lj, Linvj, okj = _jax_chol_linv(b)
    assert ok and okj == 1.0
    assert _rel(L, Lj) <= 1e-5
    assert _rel(Linv, Linvj) <= 1e-5
    assert float(torch.max(torch.abs(torch.triu(L, 1)))) == 0.0


def test_leaf_model_at_the_main_path_size():
    """b = 512 on 132 blocks (one per SM of an H100; the largest phase
    deals 134 items to the 131 blocks besides block 0) against LAPACK
    through the port's plain version; L Linv = I to b eps (norm-wise,
    relative to |L| |Linv|)."""
    A = torch.from_numpy(_spd(512, 1))
    assert _max_blocks(512) == 135
    L, Linv, ok = _leaf_schedule_model(A, 132)
    Lp, Linvp, okp = cuda_chol.chol_linv_plain(A[None])
    assert ok and float(okp[0]) == 1.0
    assert _rel(L, Lp[0]) <= 1e-5
    assert _rel(Linv, Linvp[0]) <= 1e-5
    Ld, Linvd = L.double(), Linv.double()
    res = torch.linalg.norm(Ld @ Linvd - torch.eye(512, dtype=torch.float64))
    assert float(res / (torch.linalg.norm(Ld) * torch.linalg.norm(Linvd))) \
        <= 512 * 2.0**-24


@pytest.mark.parametrize("panel", [0, 2, 3], ids=["first", "middle", "last"])
def test_leaf_model_indefinite(panel):
    """The first failing pivot in the first, a middle or the last of the
    four panels at b = 128: ok = 0 as the Pallas kernel says, every output
    finite, and the leading block up to the failing pivot is the plain
    factor (and inverse) of A's leading principal block."""
    A, s = _indefinite(128, panel)
    L, Linv, ok = _leaf_schedule_model(torch.from_numpy(A), 7)
    assert not ok and _jax_chol_linv(128, panel)[2] == 0.0
    assert bool(torch.isfinite(L).all() and torch.isfinite(Linv).all())
    lead = torch.from_numpy(A[:s, :s])[None]
    Lp, Linvp, okp = cuda_chol.chol_linv_plain(lead)
    assert float(okp[0]) == 1.0
    assert _rel(L[:s, :s], Lp[0]) <= 1e-5
    assert _rel(Linv[:s, :s], Linvp[0]) <= 1e-5


def test_leaf_model_on_a_failing_ladder_block():
    """b = 512 on 132 blocks, on a Toeplitz block of the sml SKI model that
    fails at the base jitter: ok = 0 as the Pallas kernel says (interpret
    mode), and the repaired failure contract holds (every output finite,
    the factor of the decoupled matrix, Linv its inverse). Without the
    repair the same schedule overflows."""
    A = _sml_ladder_blocks((7,))[0]
    L, Linv, ok = _leaf_schedule_model(torch.from_numpy(A), 132)
    okj = float(pallas_chol.chol_linv(jnp.asarray(A), True)[2])
    assert not ok and okj == 0.0
    _holds_failure_contract(torch.from_numpy(A), L, Linv)
    L0, Linv0, ok0 = _leaf_schedule_model(torch.from_numpy(A), 132,
                                          decouple=False)
    assert not ok0
    assert not bool(torch.isfinite(L0).all() and torch.isfinite(Linv0).all())


@pytest.mark.parametrize("b,G", [(512, 132), (512, 1), (256, 7), (128, 120),
                                 (64, 2)])
def test_every_tile_dealt_to_exactly_one_block(b, G):
    """Per panel, the phases' items dealt to G blocks cover exactly the
    tiles the one-block kernel visits in that panel (the look-ahead takes
    row tile kp+1, trailing tile (kp+1, kp+1) and the next D), each once;
    block 0 holds the diagonal chain, the others shares that differ by at
    most one item; and each inverse tile Linv[k, cj] gets its accumulator
    terms at panels cj .. k-1, in order, and is finished at panel k, as
    the one-block kernel sums them."""
    npan = b // NB
    terms = {}
    for kp in range(npan):
        T = npan - 1 - kp
        pa, pb = _phase_items(b, kp)
        for phase in (pa, pb):
            dealt = _deal(phase, G)
            assert len(dealt) == G
            seen = [it for items in dealt for it in items]
            assert sorted(seen) == sorted(phase)
            assert len(set(seen)) == len(seen)
            if G > 1:
                assert all(it[0] in ("look", "dinv") for it in dealt[0])
                sizes = [len(items) for items in dealt[1:]]
                assert max(sizes) - min(sizes) <= 1
        chain = [it[0] for it in pa + pb if it[0] in ("look", "dinv")]
        assert chain == (["look", "dinv"] if T > 0 else [])
        rows = [it[1] for it in pa if it[0] in ("row", "look")]
        assert sorted(rows) == list(range(kp + 1, npan))
        trail = [it[1:] for it in pb if it[0] == "trail"]
        assert sorted(trail + [(kp + 1, kp + 1)] * (T > 0)) == sorted(
            (ti, tk) for ti in range(kp + 1, npan) for tk in range(kp + 1,
                                                                   ti + 1))
        for it in pb:
            if it[0] == "acc":
                terms.setdefault(it[1:], []).append(kp)
        for it in pa:
            if it[0] == "inv":
                assert terms.pop((kp, it[2])) == list(range(it[2], kp))
    assert not terms


@pytest.mark.parametrize("case", ["cpu", "float64", "batch", "meta"])
def test_leaf_wrapper_refuses(case):
    """The leaf kernel's wrapper launches only on a float32 CUDA tensor
    holding one matrix, and the public entry point takes the plain version
    only on the CPU; here (no card) every call raises before a build."""
    if case == "meta":
        with pytest.raises(TypeError):
            cuda_chol.chol_linv(torch.eye(32, device="meta"))
        return
    A = {"cpu": torch.eye(64)[None],
         "float64": torch.eye(64, dtype=torch.float64, device="meta")[None],
         "batch": torch.eye(64).expand(2, 64, 64).contiguous()}[case]
    with pytest.raises(ValueError if case == "batch" else TypeError):
        cuda_chol.chol_linv_cuda(A, "chol_linv")
