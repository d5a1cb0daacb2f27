"""The eager communication API: the counterpart of
``paddle_tpu/distributed/communication.py`` (``paddle.distributed.
all_reduce``, ``broadcast``, ``send``, ...).

Each collective runs over the group's ``torch.distributed`` process group
(``process_group.py``): NCCL for a CUDA tensor, gloo for a CPU one, on the
tensor's own memory, with no copy through the host. Results are what the
reference gives:

- a collective that returns into its argument (``all_reduce``,
  ``broadcast``, ``reduce`` on ``dst``, ``reduce_scatter``, ``scatter``,
  ``recv``) writes the result into the tensor in place, cut from any
  autograd graph (a leaf keeps its ``stop_gradient``);
- one that returns lists (``all_gather``, ``gather`` on ``dst``,
  ``alltoall``) appends new tensors with the argument's ``stop_gradient``;
- ``ReduceOp.AVG`` divides the sum by the group size (an integer tensor
  by truncation, as the reference's cast does);
- on a one-rank group every collective is the identity (``send`` and
  ``recv`` raise), before ``init_parallel_env`` too.

``isend`` and ``irecv`` complete before they return, as the reference's
do, and give a finished task. The ``stream`` namespace holds the same
functions.

Each collective over more than one rank is one attempt under
``retry.comm_policy()`` that fires the ``comm::<name>`` fault site before
the torch call (``_resilient``). An error that torch raises from inside
the call is not retried: a half-done collective needs the step's rollback
(``ElasticStep``), not a second call. While a telemetry plane is on, each
such collective runs in a ``comm::<name>`` span carrying its payload bytes
(``_obs_comm``), counted once per call as ``comm.calls.<name>`` and
``comm.bytes.<name>``, outside the retries.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .._core.tensor import Tensor
from ..observability import _state as _OBS
from .process_group import (TORCH_OPS, Group, ReduceOp,  # noqa: F401
                            default_group, get_backend, get_group,
                            new_group)
from .resilience import faults as _faults
from .resilience import retry as _retry


class _CallFailed(Exception):
    """Carries an error raised by the torch call past the retry policy."""


def _obs_comm(name: str, of=()):
    """Span and call/byte counters for one collective (callers gate on
    ``_OBS.ACTIVE``). The payload is the bytes of the tensors ``of``,
    priced once per call (not per attempt); the span carries it so the
    cross-rank overlap report can turn comm time into achieved
    bandwidth."""
    nbytes = _nbytes(of)
    if _OBS.METRICS:
        from ..observability import metrics
        metrics.inc("comm.calls." + name)
        if nbytes:
            metrics.inc("comm.bytes." + name, nbytes)
    from ..observability.spans import span
    return span("comm::" + name, hist=f"comm.{name}_us", bytes=nbytes)


def _nbytes(ts) -> int:
    return sum(p.numel() * p.element_size()
               for p in (_payload(t) for t in ts)
               if isinstance(p, torch.Tensor))


def _resilient(name: str, fn, *args, _of=(), **kw):
    """``fn(*args, **kw)``, one collective, as one attempt under the comm
    retry policy that fires ``comm::<name>`` first; what ``fn`` raises
    goes to the caller unretried. ``_of`` holds the payload's tensors,
    whose bytes the span carries; they are summed only while a telemetry
    plane is on."""
    if not _OBS.ACTIVE:
        return _attempts(name, fn, *args, **kw)
    with _obs_comm(name, _of):
        return _attempts(name, fn, *args, **kw)


def _attempts(name: str, fn, *args, **kw):
    def attempt():
        if _faults.ACTIVE:
            _faults.inject("comm::" + name)
        try:
            return fn(*args, **kw)
        except Exception as e:
            raise _CallFailed(e) from None

    try:
        return _retry.comm_policy().run(attempt, what="comm::" + name)
    except _CallFailed as wrapped:
        err = wrapped.args[0]
        raise err.with_traceback(err.__traceback__) from None


def _group(group) -> Group:
    return group if group is not None else default_group()


def _single(group) -> bool:
    return _group(group).nranks <= 1


def _pg(group):
    g = _group(group)
    if g.pg is None:
        raise RuntimeError("multi-process collectives need "
                           "init_parallel_env() first")
    if g.rank < 0:
        raise RuntimeError(f"this rank is not a member of {g}")
    return g.pg


def _member(group, rank: int, what: str) -> int:
    """``rank`` (global) checked to be in the group."""
    g = _group(group)
    if g.get_group_rank(rank) < 0:
        raise ValueError(f"{what}={rank} is not a member of {g}")
    return rank


def _payload(t) -> torch.Tensor:
    return t._t if isinstance(t, Tensor) else t


def _buffer(t) -> torch.Tensor:
    """A contiguous tensor of ``t``'s value that a collective may write:
    the payload itself when that is safe in place (a contiguous tensor with
    no autograd history), else a copy."""
    p = _payload(t)
    if p.grad_fn is None and p.is_contiguous():
        return p
    return p.detach().clone(memory_format=torch.contiguous_format)


def _adopt(t, value: torch.Tensor) -> None:
    """The result ``value`` into ``t``: in place where ``t``'s payload has
    no autograd history and the same shape and dtype, else as a new leaf
    with ``t``'s ``stop_gradient``."""
    p = _payload(t)
    if value is p:
        return
    if p.grad_fn is None and p.shape == value.shape \
            and p.dtype == value.dtype:
        with torch.no_grad():
            p.copy_(value)
        return
    if not isinstance(t, Tensor):
        raise ValueError("a torch.Tensor argument keeps its shape and dtype")
    fresh = value.detach()
    if p.requires_grad and fresh.is_floating_point():
        fresh.requires_grad_(True)
    t._t = fresh


def _wrap_like(value: torch.Tensor, like) -> Tensor:
    out = Tensor(value.detach())
    if isinstance(like, Tensor) and not like.stop_gradient \
            and value.is_floating_point():
        out.stop_gradient = False
    return out


def _average(buf: torch.Tensor, n: int) -> None:
    if buf.is_floating_point() or buf.is_complex():
        buf.div_(n)
    else:
        buf.copy_(torch.div(buf, n, rounding_mode="trunc"))


def _reduce_into(buf, op, n) -> None:
    """What remains of a reduction after the sum: AVG's division."""
    if op == ReduceOp.AVG:
        _average(buf, n)


# --------------------------------------------------------------- collectives

def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place: the reduction of ``tensor`` over the group."""
    if _single(group):
        return tensor
    pg = _pg(group)
    buf = _buffer(tensor)
    with torch.no_grad():
        _resilient("all_reduce", dist.all_reduce, buf,
                   op=TORCH_OPS[op], group=pg, _of=(buf,))
        _reduce_into(buf, op, _group(group).nranks)
    _adopt(tensor, buf)
    return tensor


def all_gather(tensor_list: List, tensor, group=None, sync_op=True):
    """Appends each rank's ``tensor`` to ``tensor_list``, in rank order."""
    if _single(group):
        tensor_list.append(_wrap_like(_payload(tensor).clone(), tensor))
        return tensor_list
    pg = _pg(group)
    src = _payload(tensor).detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(_group(group).nranks)]
    _resilient("all_gather", dist.all_gather, outs, src, group=pg,
               _of=(src,))
    tensor_list.extend(_wrap_like(o, tensor) for o in outs)
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    if _single(group):
        object_list.append(obj)
        return object_list
    out = [None] * _group(group).nranks
    _resilient("all_gather_object", dist.all_gather_object, out, obj,
               group=_pg(group))
    object_list.extend(out)
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """In place: ``src``'s ``tensor`` on every rank."""
    if _single(group):
        return tensor
    pg = _pg(group)
    buf = _buffer(tensor)
    with torch.no_grad():
        _resilient("broadcast", dist.broadcast, buf,
                   src=_member(group, src, "src"), group=pg,
                   _of=(buf,))
    _adopt(tensor, buf)
    return tensor


def broadcast_object_list(object_list, src=0, group=None):
    if _single(group):
        return object_list
    _resilient("broadcast_object_list", dist.broadcast_object_list,
               object_list, src=_member(group, src, "src"),
               group=_pg(group))
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place on ``dst``: the reduction over the group; the other ranks'
    tensors stay as they were."""
    if _single(group):
        return tensor
    pg = _pg(group)
    dst = _member(group, dst, "dst")
    buf = _payload(tensor).detach().clone(
        memory_format=torch.contiguous_format)
    with torch.no_grad():
        _resilient("reduce", dist.reduce, buf, dst=dst, op=TORCH_OPS[op],
                   group=pg, _of=(buf,))
    if dist.get_rank() == dst:
        _reduce_into(buf, op, _group(group).nranks)
        _adopt(tensor, buf)
    return tensor


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """In place: the reduction over the group of every rank's
    ``tensor_list[r]``, for this rank r (one reduce to each rank, so the
    parts may differ in shape)."""
    if _single(group):
        _adopt(tensor, _payload(tensor_list[0]).detach().clone())
        return tensor
    pg = _pg(group)
    g = _group(group)

    def reduces():
        mine = None
        for r, part in zip(g.ranks, tensor_list):
            buf = _payload(part).detach().clone(
                memory_format=torch.contiguous_format)
            dist.reduce(buf, dst=r, op=TORCH_OPS[op], group=pg)
            if r == dist.get_rank():
                mine = buf
        return mine

    with torch.no_grad():
        mine = _resilient("reduce_scatter", reduces, _of=tensor_list)
        _reduce_into(mine, op, g.nranks)
    _adopt(tensor, mine)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """In place: ``src``'s ``tensor_list[r]`` on rank r."""
    if _single(group):
        if tensor_list:
            _adopt(tensor, _payload(tensor_list[0]).detach().clone())
        return tensor
    pg = _pg(group)
    src = _member(group, src, "src")
    buf = _buffer(tensor)
    parts = None
    if dist.get_rank() == src:
        parts = [_payload(t).detach().contiguous() for t in tensor_list]
    with torch.no_grad():
        _resilient("scatter", dist.scatter, buf, scatter_list=parts,
                   src=src, group=pg, _of=parts or (buf,))
    _adopt(tensor, buf)
    return tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """On ``dst``: every rank's ``tensor`` appended to ``gather_list``."""
    if _single(group):
        if gather_list is not None:
            gather_list.append(_wrap_like(_payload(tensor).clone(), tensor))
        return gather_list
    pg = _pg(group)
    dst = _member(group, dst, "dst")
    src = _payload(tensor).detach().contiguous()
    outs = None
    if dist.get_rank() == dst:
        outs = [torch.empty_like(src) for _ in range(_group(group).nranks)]
    _resilient("gather", dist.gather, src, gather_list=outs, dst=dst,
               group=pg, _of=(src,))
    if outs is not None and gather_list is not None:
        gather_list.extend(_wrap_like(o, tensor) for o in outs)
    return gather_list


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Appends, for each rank r in order, rank r's ``in_tensor_list`` entry
    for this rank: the parts' shapes, then one ``all_to_all_single`` over
    the flattened parts (parts may differ in shape)."""
    if _single(group):
        out_tensor_list.extend(_wrap_like(_payload(t).clone(), t)
                               for t in in_tensor_list)
        return out_tensor_list
    pg = _pg(group)
    n = _group(group).nranks
    ins = [_payload(t).detach().contiguous() for t in in_tensor_list]
    # what this rank receives is shaped as each sender's part for it: the
    # senders' shapes go first (a rank cannot tell from its own parts)
    every: List = [None] * n
    dist.all_gather_object(every, [tuple(t.shape) for t in ins], group=pg)
    me = _group(group).get_group_rank(dist.get_rank())
    got_shapes = [every[r][me] for r in range(n)]
    flat_in = torch.cat([t.reshape(-1) for t in ins])
    sizes_out = [int(torch.Size(s).numel()) for s in got_shapes]
    flat_out = flat_in.new_empty(sum(sizes_out))
    _resilient("all_to_all", dist.all_to_all_single, flat_out, flat_in,
               output_split_sizes=sizes_out,
               input_split_sizes=[t.numel() for t in ins], group=pg,
               _of=ins)
    like = in_tensor_list[0]
    for part, s in zip(flat_out.split(sizes_out), got_shapes):
        out_tensor_list.append(_wrap_like(part.reshape(s), like))
    return out_tensor_list


all_to_all = alltoall


def send(tensor, dst=0, group=None, sync_op=True):
    if _group(group).nranks <= 1:
        raise RuntimeError("send needs a multi-process group")
    pg = _pg(group)
    buf = _payload(tensor).detach().contiguous()
    _resilient("send", dist.send, buf, dst=_member(group, dst, "dst"),
               group=pg, _of=(buf,))


def recv(tensor, src=0, group=None, sync_op=True):
    """In place: the tensor ``src`` sent."""
    if _group(group).nranks <= 1:
        raise RuntimeError("recv needs a multi-process group")
    pg = _pg(group)
    buf = _buffer(tensor)
    with torch.no_grad():
        _resilient("recv", dist.recv, buf, src=_member(group, src, "src"),
                   group=pg, _of=(buf,))
    _adopt(tensor, buf)
    return tensor


class _Done:
    """The task of a point-to-point call that has completed."""

    def wait(self, timeout=None) -> bool:
        return True

    def is_completed(self) -> bool:
        return True


def isend(tensor, dst=0, group=None):
    send(tensor, dst, group)
    return _Done()


def irecv(tensor, src=0, group=None):
    recv(tensor, src, group)
    return _Done()


def barrier(group=None):
    if _single(group):
        return
    _resilient("barrier", dist.barrier, group=_pg(group))


def wait(tensor, group=None, use_calc_stream=True):
    """Returns once ``tensor``'s value is there: a pending value of the lazy
    window lands, and the card's current stream finishes what it queued."""
    p = _payload(tensor)
    if p.is_cuda:
        torch.cuda.current_stream(p.device).synchronize()


class _StreamNS:
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    reduce_scatter = staticmethod(reduce_scatter)
    scatter = staticmethod(scatter)
    alltoall = staticmethod(alltoall)
    send = staticmethod(send)
    recv = staticmethod(recv)


stream = _StreamNS()
