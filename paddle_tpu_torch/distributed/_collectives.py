"""Differentiable collectives for the mesh trainers' shard-local code.

Every function here takes a process group and is called by every rank of
that group at the same point of its program. Values are either replicated
over the group (every rank holds the same tensor) or split over it (each
rank holds its block). The adjoints follow from that: a rank whose
replicated result feeds a replicated computation gets the whole cotangent
already, so the backward of a sum over the group is the identity, and the
backward of a copy into a split computation is a sum. Megatron-LM's
``f`` and ``g`` operators are :func:`copy_to` and :func:`reduce_from`;
its sequence-parallel pair is :func:`gather_seq` and :func:`scatter_seq`.

Each collective is called on every group, one rank or many, and adds one
to ``CALLS[kind]`` when it is called, forward or backward. The in-place
forms (``all_reduce_``, ``reduce_``, ``broadcast_``, ``average_``) serve
the optimizers and wrappers of ``fleet``, ``sharding`` and
``DataParallel``, and count there too.
"""
from __future__ import annotations

from collections import Counter
from typing import List

import torch
import torch.distributed as dist

CALLS: Counter = Counter()
# torch 2.13 renames the single-tensor forms; older releases have only the
# first names
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def reset_calls() -> None:
    CALLS.clear()


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


# ------------------------------------------------------ raw collectives

def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` replaced in place by its sum (or ``op``) over the group."""
    CALLS["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_(t: torch.Tensor, dst: int, group) -> torch.Tensor:
    """The sum of ``t`` over the group, in place on global rank ``dst``."""
    CALLS["reduce"] += 1
    dist.reduce(t, dst=dst, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` overwritten in place by global rank ``src``'s."""
    CALLS["broadcast"] += 1
    dist.broadcast(t, src=src, group=group)
    return t


def average_(tensors: List[torch.Tensor], group, nranks: int) -> None:
    """``tensors`` (of one type) averaged over the group in place, through
    one flat buffer and one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    flat.div_(nranks)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [part.view(t.shape)
                                   for part, t in zip(parts, tensors)])


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: the sum (or ``op``) of ``x`` over the group."""
    return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                       group, op)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` joined along ``dim`` in rank order."""
    n = _size(group)
    moved = dim != 0 and n > 1
    src = (x.movedim(dim, 0) if moved else x).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    CALLS["all_gather"] += 1
    _all_gather_single(out, src, group=group)
    return out.movedim(0, dim).contiguous() if moved else out


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the group, split along ``dim``: this rank's
    block."""
    n = _size(group)
    moved = dim != 0 and n > 1
    src = (x.movedim(dim, 0) if moved else x).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of size {src.shape[0]} does not split "
                         f"over {n} ranks")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    CALLS["reduce_scatter"] += 1
    _reduce_scatter_single(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous() if moved else out


def chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (no communication)."""
    n = _size(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over "
                         f"{n} ranks")
    step = size // n
    return x.narrow(dim, _rank(group) * step, step).contiguous()


# ------------------------------------------------ differentiable forms

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.dim, ctx.group), None, None


def copy_to(x, group):
    """Replicated ``x`` entering a computation split over the group:
    identity forward, sum of the ranks' partial cotangents backward."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Partial sums completed into a replicated value: sum forward,
    identity backward."""
    return _ReduceFrom.apply(x, group)


def gather_seq(x, dim, group):
    """A split activation gathered for a computation split over the group
    (sequence parallelism's entry to a column product): all-gather
    forward, reduce-scatter backward."""
    return _GatherSeq.apply(x, dim, group)


def scatter_seq(x, dim, group):
    """Partial sums completed and split along ``dim`` (sequence
    parallelism's exit from a row product): reduce-scatter forward,
    all-gather backward."""
    return _ScatterSeq.apply(x, dim, group)


def split(x, dim, group):
    """A replicated value cut into the ranks' blocks: this rank's block
    forward, all-gather backward."""
    return _Split.apply(x, dim, group)


def gather(x, dim, group):
    """A split value made whole for a replicated computation: all-gather
    forward, this rank's block of the cotangent backward."""
    return _Gather.apply(x, dim, group)
