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
:func:`ring_shift` is one step of a ring (context parallelism's
``ppermute``): each rank's value to the next, its send and receive issued
together.

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


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """``x`` cut into the group's blocks along ``split_dim``, block r sent
    to rank r, and the blocks received joined along ``concat_dim`` in rank
    order: a value split along ``concat_dim`` becomes split along
    ``split_dim``."""
    n = _size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does "
                         f"not split over {n} ranks")
    parts = [p.contiguous() for p in x.chunk(n, split_dim)]
    flat_in = torch.cat([p.reshape(-1) for p in parts])
    flat_out = torch.empty_like(flat_in)
    CALLS["all_to_all"] += 1
    dist.all_to_all_single(flat_out, flat_in, group=group)
    return torch.cat([o.view(parts[0].shape) for o in flat_out.chunk(n)],
                     concat_dim)


def shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """The tensor of the rank ``step`` places back in the group, while
    ``x`` goes to the rank ``step`` places on (group ranks taken modulo its
    size). The send and its paired receive are issued together
    (``batch_isend_irecv``): on a ring every rank sends before it
    receives, so a send that waited for its receiver would deadlock."""
    n = _size(group)
    src = x.contiguous()
    if n == 1:
        return src.clone()
    me = _rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    out = torch.empty_like(src)
    CALLS["ring_shift"] += 1
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, dst, group=group),
            dist.P2POp(dist.irecv, out, frm, group=group)]):
        work.wait()
    return out


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


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, concat_dim, split_dim, ctx.group), None, None, \
            None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return shift(g, -1, ctx.group), None


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


def resplit(x, split_dim, concat_dim, group):
    """A value split along ``concat_dim`` made split along ``split_dim``:
    an all-to-all forward, the reverse all-to-all backward."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def ring_shift(x, group):
    """One step of a ring: this rank's ``x`` to the next rank of the group,
    the previous rank's received (the reference's ``ppermute`` with the
    permutation i -> i + 1); backward, the cotangent shifted back."""
    return _RingShift.apply(x, group)
