"""``Tensor.__getitem__`` / ``__setitem__`` and ``masked_fill``: the
counterpart of ``paddle_tpu/ops/indexing.py``.

An index is split into a hashable spec (ints, slices, ``None``,
``Ellipsis``) and its tensor parts (integer or boolean ``Tensor``s, lists
and arrays, which become tensors on the indexed tensor's device), and
the body indexes the payload by numpy's rules, as the reference's does: a
boolean mask selects its nonzero positions (a data-dependent shape, read
on the host, as the reference reads it), advanced indices broadcast
together. A slice with a negative step (which torch refuses) reads the
flipped axis with a positive one. ``__setitem__`` writes into a copy and
adopts it (``Tensor._adopt``): the old payload, and any view of it, keeps
its values, as the reference's copies do.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .._core.dispatch import apply, unwrap
from .._core.op_registry import register_op
from .._core.tensor import Tensor
from .manipulation import _masked_fill, masked_fill  # noqa: F401


def _decompose(idx, device):
    """(spec, tensors) of an index."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    spec, tensors = [], []
    for it in idx:
        if isinstance(it, (Tensor, torch.Tensor, list, np.ndarray)):
            t = unwrap(it) if isinstance(it, (Tensor, torch.Tensor)) else \
                torch.as_tensor(np.asarray(it), device=device)
            tensors.append(t)
            spec.append(("tensor", len(tensors) - 1))
        elif isinstance(it, slice):
            spec.append(("slice", None if it.start is None else
                         int(it.start), None if it.stop is None else
                         int(it.stop), None if it.step is None else
                         int(it.step)))
        elif it is None:
            spec.append(("newaxis",))
        elif it is Ellipsis:
            spec.append(("ellipsis",))
        elif isinstance(it, numbers.Integral):
            spec.append(("int", int(it)))
        else:
            raise TypeError(f"unsupported index element: {it!r}")
    return tuple(spec), tensors


def _consumed(s, tvals):
    """How many axes of the indexed tensor one spec entry reads."""
    if s[0] == "tensor":
        t = tvals[s[1]]
        return t.dim() if t.dtype == torch.bool else 1
    return 0 if s[0] in ("newaxis", "ellipsis") else 1


def _rebuild(x, spec, tvals):
    """(axes to flip, torch index): every negative-step slice read as a
    positive one over its flipped axis; with an array index present, every
    integer index an array of ones' shape (numpy counts an integer among
    the advanced indices, torch applies it first)."""
    used = sum(_consumed(s, tvals) for s in spec)
    nd = max([1 if t.dtype == torch.bool else t.dim() for t in tvals]
             + [0])
    key, flips, axis = [], [], 0
    for s in spec:
        kind = s[0]
        if kind == "tensor":
            key.append(tvals[s[1]])
        elif kind == "slice":
            sl = slice(s[1], s[2], s[3])
            if sl.step is not None and sl.step < 0:
                n = x.shape[axis]
                r = range(*sl.indices(n))
                q0 = n - 1 - r[0] if len(r) else 0
                sl = slice(q0, q0 + len(r) * -sl.step, -sl.step) if len(r) \
                    else slice(0, 0)
                flips.append(axis)
            key.append(sl)
        elif kind == "newaxis":
            key.append(None)
        elif kind == "ellipsis":
            key.append(Ellipsis)
            axis += x.dim() - used
            continue
        elif nd:
            key.append(torch.full((1,) * nd, s[1], dtype=torch.int64,
                                  device=x.device))
        else:
            key.append(s[1])
        axis += _consumed(s, tvals)
    return flips, tuple(key)


@register_op("getitem_")
def _getitem(x, *tvals, spec):
    flips, key = _rebuild(x, spec, tvals)
    return (torch.flip(x, flips) if flips else x)[key]


@register_op("setitem_")
def _setitem(x, v, *tvals, spec):
    flips, key = _rebuild(x, spec, tvals)
    out = torch.flip(x, flips) if flips else x.clone()
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, dtype=x.dtype, device=x.device)
    out[key] = v.to(x.dtype)
    return torch.flip(out, flips) if flips else out


def getitem(x: Tensor, idx):
    spec, tensors = _decompose(idx, x._payload.device)
    return apply("getitem_", _getitem, x, *tensors, spec=spec)


def setitem(x: Tensor, idx, value):
    spec, tensors = _decompose(idx, x._payload.device)
    if isinstance(value, (list, np.ndarray)):
        value = torch.as_tensor(np.asarray(value), device=x._t.device)
    x._adopt(apply("setitem_", _setitem, x, value, *tensors, spec=spec))


def install():
    Tensor.__getitem__ = getitem
    Tensor.__setitem__ = setitem
