"""Tensor-parallel functions over the ``mp`` axis: the counterpart of the
compiled half of ``paddle_tpu/distributed/fleet/mp_ops.py``.

``vocab_parallel_softmax_cross_entropy`` is the reference's
``c_softmax_with_cross_entropy`` over a vocab-sharded classifier: each mp
rank projects the hidden states onto its slice of the vocabulary, so the
full ``[B, S, V]`` logits never exist, and three collectives over mp
finish the loss (a gradient-free max, the sum of the exponentials, the
label's logit) in its logits-level body,
``vocab_parallel_cross_entropy``. ``vocab_parallel_lookup`` is the
matching embedding lookup. Both take this rank's shard of the ``[V, H]``
weight (rows ``[r V/mp, (r+1) V/mp)`` on mp rank r) and return values
replicated over mp.

The mesh trainers' Megatron layout is built from the rest: ``tp_enter``
before a column-split product and ``tp_leave`` after a row-split one
(with sequence parallelism, the all-gather and reduce-scatter along the
sequence), ``embed_tokens`` and ``head_logits`` over a vocab-split
embedding.

The eager multi-process half (the reference's ``PyLayer`` collectives,
upstream ``fleet/layers/mpu/mp_ops.py``) serves the tensor-parallel layers
of ``mp_layers.py`` through the same differentiable collectives:
``mp_identity`` is ``copy_to`` (the reference's ``CIdentity``),
``mp_allreduce`` ``reduce_from`` (``MPAllReduce``), ``mp_concat`` ``gather``
of the last dim (``CConcat``), ``mp_split`` ``split`` of it (``CSplit``);
``mp_lookup_table`` and ``mp_softmax_cross_entropy`` are the lookup and
the cross entropy above over a given vocab start. Each takes a ``Group``;
its collectives run over the group's process group on the tensors' own
device (NCCL on a card, gloo on the CPU), a one-rank group included, and
count in ``_collectives.CALLS``. A group without a process group (one
process before ``init_parallel_env``) makes each the plain computation on
this rank's tensors (``None``: the default group).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..._core.tensor import Tensor
from .. import _collectives as C


def _dense(hidden, weight, labels):
    logits = (hidden @ weight.t()).float()
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def vocab_parallel_cross_entropy(logits, labels, vocab_start, group,
                                 ignore_index=None):
    """Per-token loss from this rank's columns ``[..., V/mp]`` of the
    logits, vocab ids from ``vocab_start``, the whole logits never on one
    rank: a gradient-free max over the group shifts them, and the sum of
    the exponentials and the label's shifted logit (on exactly one rank)
    are each completed by ``reduce_from``. Tokens labelled
    ``ignore_index`` get loss 0. ``group`` None: the logits are the whole
    vocabulary, and nothing is communicated."""
    per = logits.shape[-1]
    gmax = logits.detach().amax(-1)
    if group is not None:
        gmax = C.all_reduce(gmax, group, op=dist.ReduceOp.MAX)
    shifted = logits - gmax[..., None]
    sumexp = torch.exp(shifted).sum(-1)
    if group is not None:
        sumexp = C.reduce_from(sumexp, group)
    labels = labels.long()
    local = (labels >= vocab_start) & (labels < vocab_start + per)
    idx = (labels - vocab_start).clamp(0, per - 1)
    picked = torch.gather(shifted, -1, idx[..., None])[..., 0]
    picked = torch.where(local, picked, 0.0)
    if group is not None:
        picked = C.reduce_from(picked, group)
    loss = torch.log(sumexp) - picked
    if ignore_index is not None:
        loss = torch.where(labels == ignore_index, 0.0, loss)
    return loss


def vocab_parallel_softmax_cross_entropy(hidden, vocab_weight, labels, mesh,
                                         axis: str = "mp"):
    """Per-token loss ``[B, S]`` (fp32) from hidden ``[B, S, H]``
    (replicated over ``axis``) and this rank's rows of the classifier
    weight. Without the axis, or at its size 1, the dense head on the whole
    weight."""
    if mesh is None or mesh.axis_size(axis) <= 1:
        return _dense(hidden, vocab_weight, labels)
    group = mesh.get_group(axis)
    h = C.copy_to(hidden, group)
    logits = (h @ vocab_weight.t()).float()
    return vocab_parallel_cross_entropy(
        logits, labels, mesh.axis_index(axis) * vocab_weight.shape[0], group)


def vocab_parallel_lookup(weight, ids, group, vocab_start=None):
    """Rows of a ``[V, H]`` embedding whose vocab dim is split over
    ``group``: each rank looks up the ids in its rows (from
    ``vocab_start``, by default its rank times their count), zeros the
    others, and the sum over the group completes every row. ``group``
    None: this rank's rows alone."""
    n = weight.shape[0]
    lo = dist.get_rank(group) * n if vocab_start is None else vocab_start
    local = (ids >= lo) & (ids < lo + n)
    rows = weight[(ids - lo).clamp(0, n - 1)]
    rows = torch.where(local[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return rows if group is None else C.reduce_from(rows, group)


def mp_group(mesh):
    """The mp group of this rank, or None (no mesh, or no mp axis)."""
    if mesh is None or "mp" not in mesh.dim_names:
        return None
    return mesh.get_group("mp")


def tp_enter(y, group, sp: bool):
    """A replicated (or, under SP, sequence-split) activation entering a
    column-split product: Megatron's ``f`` (or SP's all-gather)."""
    if group is None:
        return y
    return C.gather_seq(y, 1, group) if sp else C.copy_to(y, group)


def tp_leave(y, group, sp: bool):
    """A row-split product's partial sums completed: Megatron's ``g`` (or
    SP's reduce-scatter)."""
    if group is None:
        return y
    return C.scatter_seq(y, 1, group) if sp else C.reduce_from(y, group)


def vocab_sharded(weight, vocab_size: int, mesh) -> bool:
    """Whether ``weight`` (``[V, H]``) is this rank's vocab shard over mp
    (at mp size 1, the whole vocabulary as one shard)."""
    return (mp_group(mesh) is not None
            and weight.shape[0] * mesh.axis_size("mp") == vocab_size)


def embed_tokens(wte, tokens, vocab_size: int, mesh):
    """``wte[tokens]``; over a vocab-split ``wte``, the vocab-parallel
    lookup (replicated over mp)."""
    if vocab_sharded(wte, vocab_size, mesh):
        return vocab_parallel_lookup(wte, tokens, mp_group(mesh))
    return wte[tokens]


def head_logits(x, weight, vocab_size: int, mesh):
    """``x @ weight.T``; over a vocab-split weight at mp > 1, each rank's
    logits gathered into the whole (replicated over mp)."""
    if vocab_sharded(weight, vocab_size, mesh) and mesh.axis_size("mp") > 1:
        group = mp_group(mesh)
        return C.gather(C.copy_to(x, group) @ weight.t(), x.dim() - 1, group)
    return x @ weight.t()


# ============================================= the eager multi-process half

def _pg(group):
    """The process group of ``group`` (None: the default group), or None
    where it has none."""
    if group is None:
        from ..process_group import default_group
        group = default_group()
    return getattr(group, "pg", None)


def mp_identity(x, group):
    """Copy forward, the sum of the ranks' cotangents backward
    (``_c_identity``)."""
    pg = _pg(group)
    return x if pg is None else Tensor(C.copy_to(x._t, pg))


def mp_allreduce(x, group):
    """The sum over the group forward, identity backward
    (``_mp_allreduce``)."""
    pg = _pg(group)
    return x if pg is None else Tensor(C.reduce_from(x._t, pg))


def mp_concat(x, group, rank, nranks):
    """The ranks' blocks joined along the last dim forward, this rank's
    block of the cotangent backward (``_c_concat``). ``rank`` and
    ``nranks`` are the group's own, as the reference passes them."""
    pg = _pg(group)
    return x if pg is None else Tensor(C.gather(x._t, x.ndim - 1, pg))


def mp_split(x, group, rank, nranks):
    """This rank's block of the last dim forward, the blocks joined back
    backward (``_c_split``)."""
    pg = _pg(group)
    return x if pg is None else Tensor(C.split(x._t, x.ndim - 1, pg))


def mp_lookup_table(weight_local, ids, vocab_start, group):
    """Rows of a vocab-split embedding (``_c_lookup_table``): the
    mesh path's ``vocab_parallel_lookup``."""
    return Tensor(vocab_parallel_lookup(weight_local._t, ids._t, _pg(group),
                                        vocab_start))


def mp_softmax_cross_entropy(logits_local, label, vocab_start, group,
                             ignore_index=-100):
    """Per-token loss from vocab-split logits
    (``c_softmax_with_cross_entropy``): the mesh path's
    ``vocab_parallel_cross_entropy``. ``label`` may carry a trailing unit
    dim."""
    logits, lab = logits_local._t, label._t
    if lab.dim() == logits.dim():
        lab = lab[..., 0]
    return Tensor(vocab_parallel_cross_entropy(logits, lab, vocab_start,
                                               _pg(group), ignore_index))
