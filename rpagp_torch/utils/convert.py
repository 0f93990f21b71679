"""Carry (params, buffers) trees between the JAX package and the port.

The JAX package keeps params and buffers as pytrees of arrays (dicts,
plus NamedTuples: SKIState, and the BBMM path's Preconditioner,
LoveCache and CGResult); the port keeps dicts of tensors and its own
NamedTuples of the same fields. `to_torch` takes the JAX trees as numpy
arrays (for example after jax.device_get) and returns the port's;
`to_numpy` goes back, which is how gradients are compared. RNG streams do not port, so
the tests hand both packages the same projections this way.
`local_rows` slices a global array into one rank's rows as the JAX
package's `shard_rows` lays them out over a mesh's data axis, so a
rank of the parallel path takes the reference's sharded inputs (its
probe normals, its LOVE restart table) from the global numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cg import CGResult
from ..ops.love import LoveCache
from ..ops.precond import Preconditioner
from ..ops.ski import SKIState

# NamedTuples carried field for field, keyed by their fields
_TUPLES = {cls._fields: cls for cls in (CGResult, LoveCache, Preconditioner)}


def to_torch(tree, device="cuda"):
    """numpy / array-like tree -> the same tree of tensors on `device` (the
    card unless the caller asks for the CPU; floating arrays as float32,
    integer arrays keep their dtype). A JAX SKIState becomes the port's,
    of either plan (a dense state's sorted-plan fields stay None), and a
    JAX CGResult, LoveCache or Preconditioner the port's of that name."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "tfrac"):
        return SKIState(*(None if getattr(tree, f) is None
                          else to_torch(getattr(tree, f), device)
                          for f in SKIState._fields))
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) in _TUPLES:
        return _TUPLES[tree._fields](*(to_torch(v, device) for v in tree))
    t = torch.from_numpy(np.array(tree, copy=True))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def to_numpy(tree):
    """Dict tree of tensors (params, gradients) -> dict tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def local_rows(arr, index: int, count: int, axis: int = 0):
    """Block `index` of `count` equal contiguous blocks of `arr` along
    `axis`: the rows device `index` of a data axis of `count` holds under
    the JAX package's P("data") layout (P(None, "data") with axis=1).
    Works on numpy arrays and tensors alike; the axis must divide."""
    n = arr.shape[axis]
    if n % count:
        raise ValueError(f"{n} rows do not divide into {count} shards")
    b = n // count
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(index * b, (index + 1) * b)
    return arr[tuple(sl)]
