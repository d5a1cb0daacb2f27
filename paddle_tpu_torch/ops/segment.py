"""Segment reductions: the counterpart of ``paddle_tpu/incubate/__init__.py``
``segment_sum`` / ``segment_mean`` / ``segment_max`` / ``segment_min``
(Paddle's ``segment_pool`` op family), re-exported by ``incubate``.

``data`` ``[N, ...]`` and ``segment_ids`` ``[N]`` (any integer type, in
any order) give ``[num_segments, ...]``, ``num_segments = max(ids) + 1``.
That count sets the output's length, so it is read on the host, the one
host read here. As in the reference, an empty segment gives 0 for every
reduction: ``max`` and ``min`` fill it (where ``jax.ops.segment_max``
would leave the type's extreme), ``sum`` is 0 there by itself and
``mean`` divides by ``max(count, 1)``. Integer data keeps its type for
sum, max and min; the mean of integers is a float (float64 for int64,
float32 otherwise), as ``jnp``'s true division gives it.

A tie for the max (or min) shares the gradient evenly among the tied
elements, as ``jax.ops.segment_max``'s gradient does; ``scatter_reduce``
with ``amax`` / ``amin`` does the same.
"""
from __future__ import annotations

import torch

from .._core.dispatch import apply, unwrap
from .._core.op_registry import register_op
from ._helper import inexact


def _index(ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``ids`` as an int64 index of ``data``'s shape (a broadcast view)."""
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).long()
    return idx.expand(data.shape)


def _zeros(data: torch.Tensor, num_segments: int) -> torch.Tensor:
    return data.new_zeros((num_segments,) + tuple(data.shape[1:]))


@register_op("segment_sum")
def _segment_sum(data, ids, num_segments):
    return _zeros(data, num_segments).index_add(0, ids.reshape(-1).long(),
                                                data)


def _extremal(reduce):
    def body(data, ids, num_segments):
        # include_self=False: an empty segment keeps the 0 it starts from
        return _zeros(data, num_segments).scatter_reduce(
            0, _index(ids, data), data, reduce, include_self=False)
    return body


_segment_max = register_op("segment_max", _extremal("amax"))
_segment_min = register_op("segment_min", _extremal("amin"))


@register_op("segment_mean")
def _segment_mean(data, ids, num_segments):
    idx = ids.reshape(-1).long()
    s = _zeros(data, num_segments).index_add(0, idx, data)
    # the members counted in data's type, as the reference counts them
    ones = torch.ones((data.shape[0],) + (1,) * (data.dim() - 1),
                      dtype=data.dtype, device=data.device)
    c = _zeros(ones, num_segments).index_add(0, idx, ones)
    out_t = inexact(data.dtype)
    return s.to(out_t) / torch.clamp(c, min=1).to(out_t)


def _num_segments(segment_ids) -> int:
    ids = unwrap(segment_ids)
    return int(ids.max()) + 1 if ids.numel() else 0  # the host read


def _api(op_name, body, doc):
    def api(data, segment_ids, name=None):
        return apply(op_name, body, data, segment_ids,
                     num_segments=_num_segments(segment_ids))
    api.__name__ = api.__qualname__ = op_name
    api.__doc__ = doc
    return api


segment_sum = _api("segment_sum", _segment_sum,
                   "Sum over segments (segment_pool SUM).")
segment_mean = _api("segment_mean", _segment_mean,
                    "Mean over segments (segment_pool MEAN).")
segment_max = _api("segment_max", _segment_max,
                   "Max over segments (segment_pool MAX); 0 where empty.")
segment_min = _api("segment_min", _segment_min,
                   "Min over segments (segment_pool MIN); 0 where empty.")

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min"]
