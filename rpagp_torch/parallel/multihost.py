"""The process layer of the parallel path (port of
rpagp/parallel/multihost.py): one process a rank, NCCL on CUDA with one
card a rank, gloo on the CPU.

The JAX package is one program over a mesh of devices; the port is
multi-controller, so a run is N processes started by torchrun, each
holding its own rows:

    torchrun --nproc_per_node N -m rpagp_torch.runner --distributed ...

`initialize` reads torchrun's RANK, WORLD_SIZE and LOCAL_RANK (and its
MASTER_ADDR / MASTER_PORT rendezvous). Without them it starts a world of
one in this process, as the reference's mesh spans the one device it
sees. `shard_rows_global` / `replicate_global` build a rank's tensors
from host data that every rank holds alike (the data layer is
deterministic per seed), as `jax.make_array_from_callback` does.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# the device initialize chose for this rank (make_mesh's default) and
# the collectives' timeout (the subgroups of a 2-D mesh take it too)
_state = {"device": None, "timeout": None}

DEFAULT_TIMEOUT_S = 600.0


def initialize(device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
               store=None, rank=None, world_size=None) -> torch.device:
    """Bring up the process group (idempotent) and return this rank's
    device: cuda:LOCAL_RANK with NCCL unless `device` asks for the CPU,
    which takes gloo. Under torchrun the rendezvous is its environment;
    without it, a world of one on `store` (an in-process HashStore unless
    given), or `world_size` ranks on a shared `store` (a FileStore, say)
    with this one's `rank`. Asking for CUDA where there is none raises;
    every collective raises after `timeout_s` seconds."""
    if dist.is_initialized():
        if _state["device"] is None:
            _state["device"] = _device_for(dist.get_backend(), device)
        return _state["device"]
    world = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None \
        else world_size
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the distributed path runs on CUDA (NCCL, one "
                               "card a rank) and this machine has no CUDA "
                               "device; ask for the CPU (gloo) explicitly")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no distributed backend for device {dev}")
    timeout = datetime.timedelta(seconds=timeout_s)
    if "MASTER_ADDR" in os.environ and store is None:
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=timeout)
    else:
        if world != 1 and store is None:
            raise RuntimeError(f"WORLD_SIZE={world} without a rendezvous "
                               "(MASTER_ADDR): start the ranks with torchrun")
        dist.init_process_group(backend, store=store or dist.HashStore(),
                                rank=rank, world_size=world, timeout=timeout)
    _state["device"], _state["timeout"] = dev, timeout
    return dev


def group_timeout() -> datetime.timedelta:
    """The timeout initialize gave the world, for its subgroups."""
    return _state["timeout"] or datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def _device_for(backend, device):
    if device is not None:
        return torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown():
    """Destroy the process group initialize made (and its meshes)."""
    from . import sharding

    sharding._MESHES.clear()
    _state["device"] = _state["timeout"] = None
    if dist.is_initialized():
        dist.destroy_process_group()


def process_zero() -> bool:
    """True on the rank that owns logging, CSVs and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_global_mesh():
    """1-D data mesh over every rank of the world (sharding.make_mesh)."""
    from . import sharding

    return sharding.make_mesh()


def shard_rows_global(arr, mesh):
    """This rank's contiguous rows of host data `arr` (every rank passes
    the same full array), as a tensor on the mesh's device; the rows must
    divide by the data axis. (sharding.shard_rows: in the port one rank's
    rows are always its own process's.)"""
    from . import sharding

    return sharding.shard_rows(np.asarray(arr), mesh)


def replicate_global(tree, mesh):
    """A tree of host data (the same on every rank) as tensors on the
    mesh's device (sharding.replicate)."""
    from . import sharding

    return sharding.replicate(tree, mesh)
