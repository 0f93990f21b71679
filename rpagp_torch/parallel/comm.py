"""Collectives on tensors: the JAX package's lax.psum / pmean / pmin /
pmax / ppermute inside shard_map, as torch.distributed calls over a
process group (one process a rank, each holding its own rows).

The gradient contract is the JAX package's under check_vma=False: the
transpose of a psum is another psum. So `psum` here is an autograd
Function whose backward all-reduces the cotangent too, and a rank's
gradient of a replicated parameter is a mesh sum of the cotangent paths,
exactly as each device's is in the reference (parallel/sharding.py's
`distributed_grid_mll` docstring). The caller then assembles gradients
with the reference's pmean or psum (`sharding.assemble_grads`).

No fallback: NCCL takes CUDA tensors and gloo CPU tensors, and anything
else raises before the collective; a failed or timed-out collective
raises out of torch.distributed. A rank never carries on alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _check(t, group):
    """Refuse a tensor on the wrong device for the group's backend."""
    backend = dist.get_backend(group)
    want = {"nccl": "cuda", "gloo": "cpu"}.get(backend)
    if want is not None and t.device.type != want:
        raise ValueError(f"{backend} collective asked for a {t.device.type} "
                         f"tensor: {backend} takes {want} tensors only")


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """A reduced copy of t over `group` (t itself is not modified)."""
    _check(t, group)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    """all_reduce(SUM) forward; all_reduce(SUM) of the cotangent backward
    (the reference's psum transpose under check_vma=False)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def psum(x, group):
    return _PSum.apply(x, group)


def pmean(x, group):
    return psum(x, group) / dist.get_world_size(group)


def pmin(x, group):
    """Elementwise minimum over the group (no gradient)."""
    return all_reduce(x, group, dist.ReduceOp.MIN)


def pmax(x, group):
    """Elementwise maximum over the group (no gradient)."""
    return all_reduce(x, group, dist.ReduceOp.MAX)


def all_true(flag, group) -> bool:
    """One host bool that every rank agrees on: the MIN of a device flag
    over the group, read once. Branch on this, never on a rank's own
    flag, before any code that runs collectives."""
    f = flag.detach().to(torch.int32).reshape(1)
    return bool(all_reduce(f, group, dist.ReduceOp.MIN))


class _GradPMean(torch.autograd.Function):
    """Identity forward; pmean of the cotangent backward (the reference's
    dist_chol._grad_pmean)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g, ctx.group) / dist.get_world_size(ctx.group),
                None)


def grad_pmean(x, group):
    return _GradPMean.apply(x, group)


def _shift(x, group, shift):
    _check(x, group)
    n = dist.get_world_size(group)
    if n == 1:  # a ring of one: the permutation is the identity
        return x.clone()
    r = dist.get_rank(group)
    send = x.detach().contiguous()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """Ring shift: rank r sends to r + shift and receives from r - shift;
    the backward shifts the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x, group, shift: int = 1):
    """The reference ring's ppermute [(j, j + 1) for j]: x from rank
    r - shift of the group."""
    return _PPermute.apply(x, group, shift)
