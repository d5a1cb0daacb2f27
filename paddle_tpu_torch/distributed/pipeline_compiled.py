"""Pipeline parallelism over a ``pp`` mesh axis: the counterpart of
``paddle_tpu/distributed/pipeline_compiled.py``.

The reference streams micro-batches between stages with ``ppermute``
inside one compiled program. Here each stage is a process: stage ``p``
holds layers ``[p L/pp, (p+1) L/pp)`` and runs micro-batch ``m`` at tick
``t = m + p`` (the reference's ``stream_tick_count(M, pp)`` ticks, its
(pp - 1)/T bubble), receiving its input from stage ``p - 1`` and sending
its output to stage ``p + 1`` with ``torch.distributed`` ``recv``/``send``.
The last stage's outputs then reach every stage of the line, as the
reference's ``psum`` over ``pp`` does, so the head and the loss run
replicated over ``pp``.

The backward runs the same schedule in reverse, one micro-batch at a time
(the reference's scan transpose): the last stage starts from its share of
the output's cotangent (each stage holds the same cotangent of the
replicated output; it is counted once), each stage backpropagates through
its layers and sends its input's cotangent back, and stage 0's input
cotangents reach every stage of the line, so a parameter used before the
trunk (the embeddings) gets the same whole gradient on every stage.

The schedule is GPipe / FThenB: micro-batches are independent, so 1F1B,
VPP and ZeroBubble order the same sums differently and save memory; they
are not ported (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from . import _collectives


def stream_permutation(n: int):
    """Activation ring of the streamed pipeline: stage i hands its output
    to stage i + 1 every tick."""
    return [(i, (i + 1) % n) for i in range(n)]


def stream_tick_count(num_micro: int, n: int) -> int:
    return num_micro + n - 1


def fb_permutations(n: int):
    """The compiled 1F1B train step's per-tick pair (the reference's
    lowering, ``ROADMAP.md`` §1 item 11): activations flow down the ring,
    cotangents flow up it. The pipeline checker
    (``analysis/distributed_checks.py``) simulates it."""
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [((i + 1) % n, i) for i in range(n)]
    return down, up


def fb_tick_count(num_micro: int, n: int) -> int:
    return num_micro + 2 * (n - 1)


def _send(t: torch.Tensor, dst: int) -> None:
    _collectives.CALLS["send"] += 1
    dist.send(t.contiguous(), dst=dst)


def _recv(like: torch.Tensor, src: int) -> torch.Tensor:
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    _collectives.CALLS["recv"] += 1
    dist.recv(out, src=src)
    return out


class _Pipeline(torch.autograd.Function):
    """``x_mb`` ``[M, mb, ...]`` (replicated over the line) and this
    stage's parameters in; the trunk's outputs ``[M, mb, ...]``
    (replicated over the line) out."""

    @staticmethod
    def forward(ctx, stage_fn, line, group, x_mb, *params):
        p = line.index(dist.get_rank())
        n = len(line)
        grad = any(ctx.needs_input_grad[3:])
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(params, ctx.needs_input_grad[4:])]
        ins, outs = [], []
        for m in range(x_mb.shape[0]):  # tick m + p
            a = x_mb[m].detach() if p == 0 else _recv(x_mb[m], line[p - 1])
            a.requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                out = stage_fn(leaves, a)
            if p < n - 1:
                _send(out.detach(), line[p + 1])
            ins.append(a)
            outs.append(out)
        y = torch.stack([o.detach() for o in outs]) if p == n - 1 \
            else torch.empty_like(x_mb)
        _collectives.CALLS["broadcast"] += 1
        dist.broadcast(y, src=line[-1], group=group)
        ctx.stage = (line, group, ins, outs, leaves)
        return y

    @staticmethod
    def backward(ctx, dy):
        line, group, ins, outs, leaves = ctx.stage
        p = line.index(dist.get_rank())
        n = len(line)
        dx = torch.zeros((len(ins),) + tuple(ins[0].shape),
                         dtype=ins[0].dtype, device=ins[0].device)
        for m in reversed(range(len(ins))):
            g = dy[m] if p == n - 1 else _recv(outs[m], line[p + 1])
            torch.autograd.backward(outs[m], g)
            if p > 0:
                _send(ins[m].grad, line[p - 1])
            else:
                dx[m] = ins[m].grad
        _collectives.CALLS["broadcast"] += 1
        dist.broadcast(dx, src=line[0], group=group)
        del ctx.stage
        return (None, None, None, dx) + tuple(
            leaf.grad if leaf.requires_grad else None for leaf in leaves)


def spmd_pipeline(stage_fn: Callable, x_mb: torch.Tensor,
                  params: Sequence[torch.Tensor], mesh,
                  axis_name: str = "pp") -> torch.Tensor:
    """Stream micro-batches through the stages of this rank's line along
    ``axis_name``.

    stage_fn(params, a) -> a applies THIS stage's layers (``params``:
    this stage's tensors, in the order given) to one micro-batch ``a``
    ``[mb, ...]``. x_mb: ``[M, mb, ...]``, the same on every stage.
    Returns ``[M, mb, ...]``, the same on every stage; differentiable in
    ``x_mb`` and ``params``."""
    from .parallel_env import rank_of
    line = [rank_of(r) for r in mesh.line(axis_name)]  # torch ranks
    return _Pipeline.apply(stage_fn, line, mesh.get_group(axis_name),
                           x_mb, *params)


def pipelined_trunk(block_fn: Callable, mesh, num_microbatches: int,
                    axis_name: str = "pp", remat: bool = True):
    """Wrap a transformer trunk into the pipeline.

    block_fn(x, blk) -> x applies ONE block with params blk (this layer's
    slice of each stacked leaf). Returns trunk(blocks, x), where blocks'
    leaves are this stage's ``[L/pp, ...]`` and x ``[B, S, H]`` is this
    rank's batch, the same on every stage; the result is ``[B, S, H]``,
    the same on every stage. Each block is recomputed in the backward
    when ``remat`` (``torch.utils.checkpoint``, not reentrant)."""

    def trunk(blocks, x):
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(
                f"batch {b} not divisible by micro-batches "
                f"{num_microbatches}")
        keys = sorted(blocks)

        def stage(leaves: List[torch.Tensor], a):
            for layer in zip(*(t.unbind(0) for t in leaves)):
                blk = dict(zip(keys, layer))
                if remat:
                    a = checkpoint(block_fn, a, blk, use_reentrant=False)
                else:
                    a = block_fn(a, blk)
            return a

        x_mb = x.reshape(num_microbatches, b // num_microbatches,
                         *x.shape[1:])
        y = spmd_pipeline(stage, x_mb, [blocks[k] for k in keys], mesh,
                          axis_name)
        return y.reshape(b, *x.shape[1:])

    return trunk


# --------------------------------------------------------------- schedules

class FThenB:
    """The reference's schedule descriptor for the one schedule ported:
    GPipe/FThenB, what :func:`pipelined_trunk` runs. It records the
    micro-batch count and remat policy a caller passes along."""

    name = "FThenB"

    def __init__(self, num_microbatches: Optional[int] = None,
                 remat: bool = True):
        self.num_microbatches = num_microbatches
        self.remat = remat
