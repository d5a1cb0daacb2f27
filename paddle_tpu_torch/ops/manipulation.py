"""Shape and type manipulation: the counterpart of
``paddle_tpu/ops/manipulation.py``, in paddle's signatures (``perm``,
``axis``, lists of Tensors)."""
from __future__ import annotations

import numbers

import torch

from .._core import dtype as dtypes
from .._core.dispatch import apply


def reshape(x, shape, name=None):
    if hasattr(shape, "tolist"):
        shape = shape.tolist()
    shape = tuple(int(s) for s in shape)
    return apply("reshape", lambda t: t.reshape(shape), x)


def cast(x, dtype):
    dt = dtypes.to_torch(dtype)
    return apply("cast", lambda t: t if t.dtype == dt else t.to(dt), x)


astype = cast


def transpose(x, perm, name=None):
    perm = tuple(int(p) for p in perm)
    return apply("transpose", lambda t: t.permute(perm), x)


def concat(x, axis=0, name=None):
    return apply("concat_", lambda *ts: torch.cat(ts, int(axis)), *x)


def split(x, num_or_sections, axis=0, name=None):
    def body(t):
        ax = int(axis) % t.dim()
        dim = t.shape[ax]
        if isinstance(num_or_sections, numbers.Integral):
            n = int(num_or_sections)
            if dim % n:
                raise ValueError(f"dim {dim} not divisible by {n}")
            sizes = [dim // n] * n
        else:  # one -1 takes what the others leave
            known = sum(int(s) for s in num_or_sections if int(s) >= 0)
            sizes = [dim - known if int(s) < 0 else int(s)
                     for s in num_or_sections]
        return list(torch.split(t, sizes, ax))
    return apply("split_", body, x)


def unbind(x, axis=0):
    return apply("unbind_", lambda t: list(torch.unbind(t, int(axis))), x)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis .. stop_axis`` merged into one."""
    nd = max(len(x.shape), 1)
    start, stop = int(start_axis) % nd, int(stop_axis) % nd
    return apply("flatten_", lambda t: t.flatten(start, stop) if t.dim()
                 else t.reshape(1), x)


def squeeze(x, axis=None, name=None):
    """Drops the given axes of size 1 (all of them for ``None``); an axis
    that is not of size 1 stays, as in the reference."""
    nd = len(x.shape)
    if axis is None:
        axes = tuple(i for i, s in enumerate(x.shape) if s == 1)
    else:
        axes = (axis,) if isinstance(axis, numbers.Integral) else \
            tuple(axis)
        axes = tuple(a % nd for a in axes if x.shape[a % nd] == 1)
    return apply("squeeze", lambda t: t.squeeze(axes) if axes else t, x)


def unsqueeze(x, axis, name=None):
    """Inserts axes of size 1 at the given positions of the result."""
    axes = (axis,) if isinstance(axis, numbers.Integral) else tuple(axis)

    def body(t):
        nd = t.dim() + len(axes)
        for a in sorted(int(a) % nd for a in axes):
            t = t.unsqueeze(a)
        return t
    return apply("unsqueeze", body, x)
