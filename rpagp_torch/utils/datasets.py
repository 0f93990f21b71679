"""UCI regression data layer: loading, normalization, k-fold splits (the
port's own copy of rpagp/utils/datasets.py, with the numpy paths of
rpagp/utils/native.py that it needs).

Loads the Andrew-Gordon-Wilson-collection UCI ``.mat`` files (a single
``data`` array, X = data[:, :-1], y = data[:, -1]), z-scores per split
using TRAIN statistics only, and yields 90/10 k-fold splits.

Offline fallback: when no ``.mat`` file is found under $RPAGP_DATA_DIR (or
./uci_data), a deterministic synthetic regression problem with the real
dataset's (N, D) shape is generated instead, flagged `synthetic`; RMSE/NLL
numbers on it are not comparable to the paper's tables.

The JAX package may read and permute through an optional C++ runtime;
this copy keeps only its numpy fallbacks, which that package documents as
bit-identical to it (splitmix64 Fisher-Yates permutation, column
z-score), so both packages make the same splits.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Iterator

import numpy as np

# (n, d) shapes of the UCI sets the reference paper uses (Wilson .mat
# collection)
UCI_SHAPES = {
    "challenger": (23, 4),
    "fertility": (100, 9),
    "concreteslump": (103, 7),
    "autos": (159, 25),
    "servo": (167, 4),
    "breastcancer": (194, 33),
    "machine": (209, 7),
    "yacht": (308, 6),
    "autompg": (392, 7),
    "housing": (506, 13),
    "boston": (506, 13),
    "forest": (517, 12),
    "stock": (536, 11),
    "pendulum": (630, 9),
    "energy": (768, 8),
    "concrete": (1030, 8),
    "solar": (1066, 10),
    "airfoil": (1503, 5),
    "wine": (1599, 11),
    "gas": (2565, 128),
    "skillcraft": (3338, 19),
    "sml": (4137, 26),
    "parkinsons": (5875, 20),
    "pumadyn32nm": (8192, 32),
    "poletele": (15000, 26),
    "pol": (15000, 26),
    "elevators": (16599, 18),
    "bike": (17379, 17),
    "kin40k": (40000, 8),
    "protein": (45730, 9),
    "tamielectric": (45781, 3),
    "keggdirected": (48827, 20),
    "slice": (53500, 385),
    "keggundirected": (63608, 27),
    "3droad": (434874, 3),
    "song": (515345, 90),
    "buzz": (583250, 77),
    "houseelectric": (2049280, 11),
}


@dataclasses.dataclass
class Dataset:
    name: str
    X: np.ndarray  # (n, d) float
    y: np.ndarray  # (n,) float
    synthetic: bool


@dataclasses.dataclass
class Split:
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    y_mean: float  # train-y statistics, for un-normalized RMSE reporting
    y_std: float


def _data_dir() -> str:
    return os.environ.get("RPAGP_DATA_DIR", os.path.join(os.getcwd(), "uci_data"))


def _load_mat(name: str):
    """Wilson-collection .mat layout (one 'data' array, y in the last
    column), or a CSV/TXT table of the same layout; None if absent."""
    for cand in (f"{name}.mat", os.path.join(name, f"{name}.mat")):
        path = os.path.join(_data_dir(), cand)
        if os.path.exists(path):
            import scipy.io

            data = np.asarray(scipy.io.loadmat(path)["data"], np.float64)
            return data[:, :-1], data[:, -1]
    for cand in (f"{name}.csv", f"{name}.txt"):
        path = os.path.join(_data_dir(), cand)
        if os.path.exists(path):
            data = np.loadtxt(path, delimiter=",")
            return data[:, :-1], data[:, -1]
    return None


def _synthetic(name: str, n: int, d: int, seed: int = 0):
    """Deterministic smooth additive regression problem of shape (n, d):
    y = sum_j a_j sin(w_j . x + b_j) + noise."""
    # zlib.crc32 is stable across processes (hash() is salted per process)
    rng = np.random.default_rng(zlib.crc32(name.encode()) + seed)
    X = rng.standard_normal((n, d))
    J = max(4, d)
    W = rng.standard_normal((d, J)) / np.sqrt(d)
    b = rng.uniform(0, 2 * np.pi, J)
    a = rng.standard_normal(J) / np.sqrt(J)
    y = np.sin(X @ W + b) @ a + 0.1 * rng.standard_normal(n)
    return X, y


def load_dataset(name: str, max_points: int | None = None) -> Dataset:
    """Load a UCI dataset by name; synthetic fallback if the .mat is absent.
    max_points: optional deterministic subsample cap for quick runs."""
    name = name.lower()
    loaded = _load_mat(name)
    if loaded is not None:
        X, y = loaded
        synthetic = False
    else:
        if name not in UCI_SHAPES:
            raise ValueError(
                f"unknown dataset {name!r} and no .mat found in {_data_dir()}")
        n, d = UCI_SHAPES[name]
        X, y = _synthetic(name, n, d)
        synthetic = True
    if max_points is not None and X.shape[0] > max_points:
        idx = np.random.default_rng(0).permutation(X.shape[0])[:max_points]
        X, y = X[idx], y[idx]
    return Dataset(name=name, X=np.asarray(X), y=np.asarray(y),
                   synthetic=synthetic)


def _splitmix64_stream(seed: int, count: int) -> np.ndarray:
    """The first `count` outputs of splitmix64(seed), vectorized: the state
    advances by a constant each call, so output i is a pure function of
    seed + (i+1)*golden."""
    golden = np.uint64(0x9E3779B97F4A7C15)
    z = np.uint64(seed) + (np.arange(1, count + 1, dtype=np.uint64) * golden)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def kfold_perm(n: int, seed: int) -> np.ndarray:
    """Deterministic Fisher-Yates permutation of [0, n) on the splitmix64
    stream."""
    perm = np.arange(n, dtype=np.int64)
    if n > 1:
        draws = _splitmix64_stream(seed, n - 1)
        for k, i in enumerate(range(n - 1, 0, -1)):
            j = int(draws[k] % np.uint64(i + 1))
            perm[i], perm[j] = perm[j], perm[i]
    return perm


def zscore_fit_apply(X: np.ndarray):
    """Column z-score of a float64 copy of X; returns (X_n, means, stds)."""
    X = np.array(X, dtype=np.float64)
    means = X.mean(axis=0)
    stds = X.std(axis=0)
    stds[stds < 1e-10] = 1.0
    X -= means
    X /= stds
    return X, means, stds


def kfold_splits(ds: Dataset, k: int = 10, seed: int = 0, dtype=np.float32,
                 equal_train: bool = False) -> Iterator[Split]:
    """90/10 k-fold CV with per-split z-scoring from TRAIN statistics only.

    equal_train=True trims every fold's TRAIN set to the common minimum
    size (n - max fold size) by dropping the tail of the permuted index
    list, at most one row per fold, so every split has one train shape.
    Test folds are never trimmed: they partition the data exactly."""
    n = ds.X.shape[0]
    perm = kfold_perm(n, seed)
    folds = np.array_split(perm, k)
    n_train_common = n - max(len(f) for f in folds)
    for i in range(k):
        test_idx = folds[i]
        train_idx = np.concatenate([folds[j] for j in range(k) if j != i])
        if equal_train:
            train_idx = train_idx[:n_train_common]
        yield _make_split(ds, train_idx, test_idx, dtype)


def single_split(ds: Dataset, test_frac: float = 0.1, seed: int = 0,
                 dtype=np.float32) -> Split:
    """One train/test split: the first round(test_frac * n) rows (at least
    1) of the seeded permutation are the test set."""
    n = ds.X.shape[0]
    perm = kfold_perm(n, seed)
    n_test = max(1, int(round(test_frac * n)))
    return _make_split(ds, perm[n_test:], perm[:n_test], dtype)


def _make_split(ds: Dataset, train_idx, test_idx, dtype) -> Split:
    Xtr, ytr = ds.X[train_idx], ds.y[train_idx]
    Xte, yte = ds.X[test_idx], ds.y[test_idx]
    Xtr_n, x_mean, x_std = zscore_fit_apply(Xtr)
    y_mean, y_std = float(ytr.mean()), float(ytr.std())
    y_std = y_std if y_std > 1e-10 else 1.0
    z = lambda X: ((X - x_mean) / x_std).astype(dtype)
    zy = lambda y: ((y - y_mean) / y_std).astype(dtype)
    return Split(Xtr_n.astype(dtype), zy(ytr), z(Xte), zy(yte), y_mean, y_std)
