"""Tensor-parallel functions over the ``mp`` axis: the counterpart of the
compiled half of ``paddle_tpu/distributed/fleet/mp_ops.py``.

``vocab_parallel_softmax_cross_entropy`` is the reference's
``c_softmax_with_cross_entropy`` over a vocab-sharded classifier: each mp
rank projects the hidden states onto its slice of the vocabulary, so the
full ``[B, S, V]`` logits never exist, and three collectives over mp
finish the loss (a gradient-free max, the sum of the exponentials, the
label's logit). ``vocab_parallel_lookup`` is the matching embedding
lookup. Both take this rank's shard of the ``[V, H]`` weight (rows ``[r
V/mp, (r+1) V/mp)`` on mp rank r) and return values replicated over mp.

The mesh trainers' Megatron layout is built from the rest: ``tp_enter``
before a column-split product and ``tp_leave`` after a row-split one
(with sequence parallelism, the all-gather and reduce-scatter along the
sequence), ``embed_tokens`` and ``head_logits`` over a vocab-split
embedding.

The eager multi-process primitives of the reference's module (the
``PyLayer`` collectives ``_c_identity`` and the rest) are not ported yet.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import _collectives as C


def _dense(hidden, weight, labels):
    logits = (hidden @ weight.t()).float()
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def vocab_parallel_softmax_cross_entropy(hidden, vocab_weight, labels, mesh,
                                         axis: str = "mp"):
    """Per-token loss ``[B, S]`` (fp32) from hidden ``[B, S, H]``
    (replicated over ``axis``) and this rank's rows of the classifier
    weight. Without the axis, or at its size 1, the dense head on the whole
    weight."""
    if mesh is None or mesh.axis_size(axis) <= 1:
        return _dense(hidden, vocab_weight, labels)
    group = mesh.get_group(axis)
    vshard = vocab_weight.shape[0]
    lo = mesh.axis_index(axis) * vshard
    h = C.copy_to(hidden, group)
    logits = (h @ vocab_weight.t()).float()
    # the global max for a stable softmax; gradient-free, the shift
    # cancels in the softmax
    gmax = C.all_reduce(logits.detach().amax(-1), group, op=dist.ReduceOp.MAX)
    shifted = logits - gmax[..., None]
    sumexp = C.reduce_from(torch.exp(shifted).sum(-1), group)
    # the label's (shifted) logit lives on exactly one rank
    labels = labels.long()
    local = (labels >= lo) & (labels < lo + vshard)
    idx = (labels - lo).clamp(0, vshard - 1)
    picked = torch.gather(shifted, -1, idx[..., None])[..., 0]
    picked = C.reduce_from(torch.where(local, picked, 0.0), group)
    return torch.log(sumexp) - picked


def vocab_parallel_lookup(weight, ids, group):
    """Rows of a ``[V, H]`` embedding whose vocab dim is split over
    ``group``: each rank looks up the ids in its rows, zeros the others,
    and the sum over the group completes every row."""
    n = weight.shape[0]
    lo = dist.get_rank(group) * n
    local = (ids >= lo) & (ids < lo + n)
    rows = weight[(ids - lo).clamp(0, n - 1)]
    rows = torch.where(local[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return C.reduce_from(rows, group)


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
