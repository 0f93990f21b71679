"""Checkpoint / resume of dict trees of tensors (port of
rpagp/utils/checkpoint.py, its npz backend).

A checkpoint is two files: `path.npz` holds the leaves, flattened in the
order of their sorted dict paths, and `path.json` the structure those
paths and the leaves' shapes make up (the JAX package stores its pytree
treedef there). Leaves are tensors on any device: they are saved through
`.cpu().numpy()` and loaded back onto the device of the matching leaf of
`like`. A torch.Generator is carried as its `get_state()` byte tensor.

save_checkpoint / load_checkpoint round-trip, for example,
  {"params": ..., "buffers": ..., "opt_state": ..., "generator": ...,
   "step": tensor}
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a dict tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """`like`'s dict structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _structure(flat) -> list:
    return [[path, list(leaf.shape)] for path, leaf in flat]


def save_checkpoint(path: str, state: dict) -> None:
    """Write a dict tree of tensors to `path` (.npz leaves + .json
    structure)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = [(p, torch.as_tensor(leaf)) for p, leaf in _flatten(state)]
    np.savez(path + ".npz", **{f"leaf_{i}": leaf.detach().cpu().numpy()
                               for i, (_, leaf) in enumerate(flat)})
    with open(path + ".json", "w") as f:
        json.dump({"structure": _structure(flat), "num_leaves": len(flat)}, f)


def load_checkpoint(path: str, like: dict) -> dict:
    """Load a checkpoint written by save_checkpoint. `like` supplies the
    structure (the dict tree that was saved, or one of the same paths and
    shapes) and each leaf's device; a checkpoint of another structure
    raises ValueError rather than filling the wrong slots."""
    with open(path + ".json") as f:
        meta = json.load(f)
    flat = [(p, torch.as_tensor(leaf)) for p, leaf in _flatten(like)]
    n = len(flat)
    if meta["num_leaves"] != n:
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves but `like` has "
            f"{n}: structure mismatch (spec/optimizer changed?)")
    if meta["structure"] != _structure(flat):
        raise ValueError(
            "checkpoint structure does not match `like`:\n"
            f"  saved: {meta['structure']}\n  like:  {_structure(flat)}")
    with np.load(path + ".npz") as data:
        leaves = [torch.from_numpy(data[f"leaf_{i}"]).to(leaf.device)
                  for i, (_, leaf) in enumerate(flat)]
    return _unflatten(like, iter(leaves))


class Checkpointer:
    """Periodic training checkpointer with keep-last-k rotation: files
    `ckpt_{step:08d}.npz` / `.json` under `directory`."""

    def __init__(self, directory: str, every: int = 50, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._saved: list[str] = []

    def maybe_save(self, step: int, state: dict) -> Optional[str]:
        """Save `state` when step is a multiple of `every`; returns the
        path written, or None."""
        if step % self.every != 0:
            return None
        path = os.path.join(self.directory, f"ckpt_{step:08d}")
        save_checkpoint(path, state)
        self._saved.append(path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            for suffix in (".npz", ".json"):
                try:
                    os.remove(old + suffix)
                except OSError:
                    pass
        return path

    def latest(self) -> Optional[str]:
        """The newest checkpoint's path (without suffix), or None."""
        if self._saved:
            return self._saved[-1]
        if not os.path.isdir(self.directory):
            return None
        cands = sorted(f[: -len(".npz")] for f in os.listdir(self.directory)
                       if f.startswith("ckpt_") and f.endswith(".npz"))
        return os.path.join(self.directory, cands[-1]) if cands else None
