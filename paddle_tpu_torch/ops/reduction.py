"""Reductions: the counterpart of ``paddle_tpu/ops/reduction.py`` (its op
names, so AMP's lists apply: ``sum_``, ``mean``, ``logsumexp``, ``std_``
and ``var_`` are on the black list).

Integer sums and products come out int64 and means, deviations and
``logsumexp`` of integers float (as JAX's with x64 on). ``median`` is
``jnp.median``'s: the mean of the two middle values of an even count, and
NaN wherever the reduced values hold a NaN (``torch.median`` gives the
lower middle value).
"""
from __future__ import annotations

import builtins
import numbers

import torch

from .._core.dispatch import apply
from .._core.op_registry import register_op
from ._helper import inexact, sort_nan_last, tensor_method
from .manipulation import cast


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, numbers.Integral):
        return int(axis)
    if hasattr(axis, "tolist"):
        axis = axis.tolist()
    return tuple(int(a) for a in axis)


def _dims(x, axis):
    """The reduced dims of payload ``x`` as a tuple (every dim for None)."""
    if axis is None:
        return tuple(range(x.dim()))
    nd = builtins.max(x.dim(), 1)
    if isinstance(axis, int):
        return (axis % nd,)
    return tuple(a % nd for a in axis)


def _keep(out, x, dims, keepdim):
    """Reinserts the reduced ``dims`` of ``x`` as size 1 when ``keepdim``
    (for the torch functions that reduce one dim at a time or none)."""
    if keepdim:
        for d in sorted(dims):
            if x.dim():
                out = out.unsqueeze(d)
    return out


def _def_reduce(name, fn):
    """Op ``name``: ``fn(x, dims, keepdim)`` over ``axis`` (a 0-d input
    reduces as it is)."""
    def body(x, axis, keepdim):
        if x.dim() == 0:
            return fn(x.unsqueeze(0), (0,), False)
        return fn(x, _dims(x, axis), keepdim)
    register_op(name, body)

    def wrapper(x, axis=None, keepdim=False, name=None):
        return apply(op_name, body, x, axis=_axes(axis),
                     keepdim=bool(keepdim))
    op_name = name
    wrapper.__name__ = name
    tensor_method(name)(wrapper)
    return wrapper


def _prod(x, dims, keepdim):
    """The product over ``dims`` as a tree of pairwise products (log2 n
    passes): its gradient is zero-safe and reads nothing back, where
    torch's prod backward asks the host whether x holds a zero. bf16 and
    fp16 multiply in float32 and round once; integers in int64."""
    dt = x.dtype
    if dt == torch.bool or not (x.is_floating_point() or x.is_complex()):
        y = x.to(torch.int64)
    else:
        y = x.float() if dt in (torch.bfloat16, torch.float16) else x
    y, _ = _to_last(y, tuple(dims))
    while y.shape[-1] > 1:
        if y.shape[-1] % 2:
            y = torch.cat([y, torch.ones_like(y[..., :1])], -1)
        y = y[..., 0::2] * y[..., 1::2]
    out = y[..., 0] if y.shape[-1] else torch.ones(
        y.shape[:-1], dtype=y.dtype, device=y.device)
    out = _keep(out, x, dims, keepdim)
    return out.to(dt) if dt in (torch.bfloat16, torch.float16) else out


_sum_raw = _def_reduce("sum_", lambda x, d, k: x.sum(d, keepdim=k))
mean = _def_reduce("mean", lambda x, d, k: x.to(inexact(x.dtype)).mean(
    d, keepdim=k))
max = _def_reduce("max", lambda x, d, k: x.amax(d, keepdim=k))
min = _def_reduce("min", lambda x, d, k: x.amin(d, keepdim=k))
amax = _def_reduce("amax", lambda x, d, k: x.amax(d, keepdim=k))
amin = _def_reduce("amin", lambda x, d, k: x.amin(d, keepdim=k))
prod = _def_reduce("prod", _prod)
all = _def_reduce("all", lambda x, d, k: x.bool().all(d, keepdim=k))
any = _def_reduce("any", lambda x, d, k: x.bool().any(d, keepdim=k))
logsumexp = _def_reduce("logsumexp", lambda x, d, k: torch.logsumexp(
    x.to(inexact(x.dtype)), d, keepdim=k))
nansum = _def_reduce("nansum", lambda x, d, k: torch.nansum(
    x, d, keepdim=k))
nanmean = _def_reduce("nanmean", lambda x, d, k: torch.nanmean(
    x.to(inexact(x.dtype)), d, keepdim=k))
logsumexp_raw = logsumexp


@tensor_method("sum")
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    out = _sum_raw(x, axis=axis, keepdim=keepdim)
    return out if dtype is None else cast(out, dtype)


def _moments(fn):
    def body(x, axis, keepdim, ddof):
        x = x.to(inexact(x.dtype))
        if x.dim() == 0:
            return fn(x.unsqueeze(0), 0, correction=ddof)
        return fn(x, _dims(x, axis), correction=ddof, keepdim=keepdim)
    return body


_std = register_op("std_", _moments(torch.std))
_var = register_op("var_", _moments(torch.var))


@tensor_method("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply("std_", _std, x, axis=_axes(axis), keepdim=bool(keepdim),
                 ddof=1 if unbiased else 0)


@tensor_method("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply("var_", _var, x, axis=_axes(axis), keepdim=bool(keepdim),
                 ddof=1 if unbiased else 0)


def _to_last(x, axis):
    """``x`` with the reduced dims moved last and merged into one, and
    those dims."""
    if x.dim() == 0:
        return x.reshape(1), ()
    dims = _dims(x, axis)
    keep = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(keep + list(dims))
    n = 1
    for d in dims:
        n *= x.shape[d]
    return y.reshape(y.shape[:len(keep)] + (n,)), dims


@register_op("median_")
def _median(x, axis, keepdim):
    y, dims = _to_last(x.to(inexact(x.dtype)), axis)
    n = y.shape[-1]
    s = sort_nan_last(y, -1)[0]
    lo, hi = s[..., (n - 1) // 2], s[..., n // 2]
    out = lo if n % 2 else (lo + hi) * 0.5
    out = torch.where(torch.isnan(y).any(-1), torch.nan, out)
    return _keep(out, x, dims, keepdim)


@tensor_method("median")
def median(x, axis=None, keepdim=False, name=None):
    return apply("median_", _median, x, axis=_axes(axis),
                 keepdim=bool(keepdim))


@register_op("quantile_")
def _quantile(x, q, axis, keepdim):
    """``jnp.quantile``'s linear method: between the sorted values at
    floor and ceil of q * (n - 1); NaN over a NaN. Sorted on the device
    (``torch.quantile`` reads q back to check it)."""
    y, dims = _to_last(x.to(inexact(x.dtype)), axis)
    n = y.shape[-1]
    s = sort_nan_last(y, -1)[0]
    qs = [float(v) for v in q] if isinstance(q, (list, tuple)) else \
        [float(q)]
    outs = []
    for v in qs:
        pos = v * (n - 1)
        lo = int(pos // 1)
        hi = builtins.min(lo + 1, n - 1)
        frac = pos - lo
        outs.append(s[..., lo] + (s[..., hi] - s[..., lo]) * frac)
    out = torch.stack(outs, 0)
    out = torch.where(torch.isnan(y).any(-1), torch.nan, out)
    if keepdim:
        for d in sorted(dims):
            out = out.unsqueeze(d + 1)
    return out if isinstance(q, (list, tuple)) else out[0]


def quantile(x, q, axis=None, keepdim=False, name=None):
    return apply("quantile_", _quantile, x, q=q, axis=_axes(axis),
                 keepdim=bool(keepdim))


@register_op("count_nonzero_")
def _count_nonzero(x, axis, keepdim):
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dims) if x.dim() else \
        (x != 0).to(torch.int64)
    return _keep(out.to(torch.int64), x, dims, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply("count_nonzero_", _count_nonzero, x, axis=_axes(axis),
                 keepdim=bool(keepdim))
