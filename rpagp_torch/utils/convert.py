"""Carry (params, buffers) trees between the JAX package and the port.

The JAX package keeps params and buffers as pytrees of arrays (dicts,
plus the SKIState NamedTuple); the port keeps dicts of tensors and its
own SKIState. `to_torch` takes the JAX trees as numpy arrays (for
example after jax.device_get) and returns the port's; `to_numpy` goes
back, which is how gradients are compared. RNG streams do not port, so
the tests hand both packages the same projections this way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ski import SKIState


def to_torch(tree, device="cpu"):
    """numpy / array-like tree -> the same tree of tensors on `device`
    (floating arrays as float32). A JAX SKIState becomes the port's; its
    sorted-plan fields must be None (only the dense plan ports)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "tfrac"):
        extra = [f for f in tree._fields
                 if f not in SKIState._fields and getattr(tree, f) is not None]
        if extra:
            raise ValueError(f"only the dense SKI plan ports; got {extra}")
        return SKIState(*(to_torch(getattr(tree, f), device)
                          for f in SKIState._fields))
    t = torch.from_numpy(np.array(tree, copy=True))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def to_numpy(tree):
    """Dict tree of tensors (params, gradients) -> dict tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
