"""Reductions: the counterpart of ``paddle_tpu/ops/reduction.py`` (its op
names: ``sum_``, ``mean``, ``max``, so AMP's lists apply)."""
from __future__ import annotations

import numbers

from .._core.dispatch import apply
from .manipulation import cast
from .math import inexact


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, numbers.Integral):
        return (int(axis),)
    if hasattr(axis, "tolist"):
        axis = axis.tolist()
    return tuple(int(a) for a in axis)


def _reduce(name, fn):
    """``fn(t, dims, keepdim)`` over ``axis`` (None: every axis)."""
    def op(x, axis=None, keepdim=False, name=None):
        axes = _axes(axis)

        def body(t):
            if t.dim() == 0:
                t = t.unsqueeze(0)
            dims = tuple(range(t.dim())) if axes is None else axes
            return fn(t, dims, bool(keepdim))
        return apply(op_name, body, x)
    op_name = name
    return op


_sum = _reduce("sum_", lambda t, d, k: t.sum(d, keepdim=k))
mean = _reduce("mean", lambda t, d, k: t.to(inexact(t.dtype)).mean(
    d, keepdim=k))
max = _reduce("max", lambda t, d, k: t.amax(d, keepdim=k))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    out = _sum(x, axis, keepdim)
    return out if dtype is None else cast(out, dtype)
