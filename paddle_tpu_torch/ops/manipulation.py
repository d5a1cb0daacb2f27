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
