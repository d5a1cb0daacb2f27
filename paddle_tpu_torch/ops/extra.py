"""Long-tail tensor ops: the counterpart of ``paddle_tpu/ops/extra.py``
(``angle``, ``bincount``, ``copysign``, ``diff``, ``frexp``,
``histogram``, ``kron``, ``ldexp``, ``nanmedian``, ``polar``, ``renorm``,
``rot90``, ``select_scatter``, ``take``, ``tensordot``, ``trapezoid``,
``unfold``, ``vander``, and the ``accuracy_check`` / ``quant_linear_i8``
primitives).

``bincount``'s output length depends on the data (``max(x) + 1``): it is
read on the host, the one host read here. ``histogram`` with no range
takes it from the data on the device.
"""
from __future__ import annotations

import torch

from .._core.dispatch import apply, unwrap
from .._core.op_registry import register_op
from ._helper import (cast_to, def_binary, def_unary, inexact,
                      promoted, sort_nan_last, tensor_method)


def _angle(x):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64)  # jnp.angle takes integers to float64
    if x.dtype in (torch.bfloat16, torch.float16):  # no CUDA kernel
        return torch.angle(x.float()).to(x.dtype)
    return torch.angle(x)


angle = def_unary("angle", _angle)
copysign = def_binary("copysign", torch.copysign, to_inexact=True)


@register_op("ldexp")
def _ldexp(x, y):
    """``x * 2**y`` in ``x``'s float type, whatever ``y``'s type."""
    x = cast_to(x, inexact(x.dtype))
    if not isinstance(y, torch.Tensor):
        y = torch.full((), int(y), dtype=torch.int32, device=x.device)
    return x * torch.pow(2.0, y.to(torch.int32)).to(x.dtype)


@tensor_method("ldexp")
def ldexp(x, y, name=None):
    return apply("ldexp", _ldexp, x, y)


kron = def_binary("kron", torch.kron, scalars=False)


def _polar(abs_, angle_):
    return abs_ * torch.exp(1j * angle_.to(torch.float32))


polar = def_binary("polar", _polar, scalars=False)


@register_op("bincount")
def _bincount(x, weights=None, length=1):
    return torch.bincount(x.reshape(-1).to(torch.int64), weights,
                          minlength=length)[:length]


@tensor_method("bincount")
def bincount(x, weights=None, minlength=0, name=None):
    t = unwrap(x)
    top = int(t.max()) + 1 if t.numel() else 0  # the host read
    return apply("bincount", _bincount, x, weights,
                 length=max(top, int(minlength), 1))


@register_op("diff")
def _diff(x, n=1, axis=-1):
    return torch.diff(x, n, axis)


@tensor_method("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply("diff", _diff, x, n=n, axis=axis)


@register_op("rot90")
def _rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@tensor_method("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return apply("rot90", _rot90, x, k=k, axes=tuple(axes))


@register_op("vander")
def _vander(x, n=None, increasing=False):
    n = x.shape[-1] if n is None else n
    powers = torch.arange(n, device=x.device)
    out = torch.pow(x.unsqueeze(-1), powers)
    return out if increasing else out.flip(-1)


def vander(x, n=None, increasing=False, name=None):
    return apply("vander", _vander, x, n=n, increasing=increasing)


@register_op("trapezoid")
def _trapezoid(y, x=None, dx=1.0, axis=-1):
    y = y.to(inexact(y.dtype))
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply("trapezoid", _trapezoid, y, x, axis=axis)
    return apply("trapezoid", _trapezoid, y, dx=1.0 if dx is None else dx,
                 axis=axis)


@register_op("nanmedian")
def _nanmedian(x, axis=None, keepdim=False):
    """``jnp.nanmedian``: the median of the non-NaN values (the mean of the
    two middle ones of an even count), NaN where all are NaN."""
    from .reduction import _keep, _to_last
    y, dims = _to_last(x.to(inexact(x.dtype)), axis)
    s = sort_nan_last(y, -1)[0]
    n = (~torch.isnan(y)).sum(-1, keepdim=True)
    lo = torch.take_along_dim(s, ((n - 1) // 2).clamp(min=0), -1)
    hi = torch.take_along_dim(s, (n // 2).clamp(max=y.shape[-1] - 1), -1)
    out = torch.where(n % 2 == 1, lo, (lo + hi) * 0.5)[..., 0]
    out = torch.where(n[..., 0] == 0, torch.nan, out)
    return _keep(out, x, dims, keepdim)


@tensor_method("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    return apply("nanmedian", _nanmedian, x, axis=axis, keepdim=keepdim)


@register_op("histogram_op")
def _histogram(x, bins=100, min=0.0, max=0.0):
    """``jnp.histogram``'s counts: ``bins`` equal bins over [min, max]
    (the data's range when both are 0), the last bin closed; in the float
    type of ``x``, as the reference's."""
    x = x.reshape(-1).to(inexact(x.dtype))
    if min == 0.0 and max == 0.0:
        lo, hi = x.amin(), x.amax()
    else:
        lo = torch.full((), min, dtype=x.dtype, device=x.device)
        hi = torch.full((), max, dtype=x.dtype, device=x.device)
    edges = lo + (hi - lo) * torch.linspace(0, 1, bins + 1, dtype=x.dtype,
                                            device=x.device)
    idx = torch.searchsorted(edges, x, right=True) - 1
    idx = torch.where(x == edges[-1], bins - 1, idx)
    inside = (idx >= 0) & (idx < bins)
    counts = torch.zeros(bins, dtype=torch.int64, device=x.device)
    return counts.index_add(0, idx.clamp(0, bins - 1),
                            inside.to(torch.int64)).to(x.dtype)


@tensor_method("histogram")
def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    return apply("histogram_op", _histogram, input, bins=bins,
                 min=float(min), max=float(max))


@register_op("take_op")
def _take(x, index, mode="raise"):
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx % n
    return flat[idx]


@tensor_method("take")
def take(x, index, mode="raise", name=None):
    return apply("take_op", _take, x, index, mode=mode)


@register_op("tensordot_op")
def _tensordot(x, y, axes=2):
    x, y = promoted(x, y)
    if isinstance(axes, tuple):
        axes = [list(a) if isinstance(a, tuple) else [a] for a in axes]
    return torch.tensordot(x, y, axes)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                     for a in axes)
    return apply("tensordot_op", _tensordot, x, y, axes=axes)


@register_op("renorm_op")
def _renorm(x, p=2.0, axis=0, max_norm=1.0):
    axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
    return x * factor


@tensor_method("renorm")
def renorm(x, p, axis, max_norm, name=None):
    return apply("renorm_op", _renorm, x, p=float(p), axis=axis,
                 max_norm=float(max_norm))


@register_op("frexp", multi_output=True)
def _frexp(x):
    m, e = torch.frexp(x.to(inexact(x.dtype)))
    return m, e


@tensor_method("frexp")
def frexp(x, name=None):
    return tuple(apply("frexp", _frexp, x))


@register_op("select_scatter_op")
def _select_scatter(x, values, axis=0, index=0):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


def select_scatter(x, values, axis, index, name=None):
    return apply("select_scatter_op", _select_scatter, x, values, axis=axis,
                 index=index)


@register_op("unfold_op")
def _unfold(x, axis=0, size=1, step=1):
    """Windows of ``size`` every ``step`` along ``axis``, the window's
    content as the last axis."""
    return x.unfold(axis, size, step)


@tensor_method("unfold")
def unfold(x, axis, size, step, name=None):
    return apply("unfold_op", _unfold, x, axis=axis, size=size, step=step)


@register_op("accuracy_check")
def _accuracy_check(x, y, fn_name="", rtol=1e-5, atol=1e-8, equal_nan=False):
    """One compare: all of ``x`` close to ``y``."""
    return torch.isclose(*promoted(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@register_op("quant_linear_i8")
def _quant_linear_i8(x, wq, w_scale, act_scale, qmax):
    """Dynamic-activation int8 linear: x quantized at ``act_scale``, an
    int8 x int8 product summed in int32, dequantized by ``act_scale`` and
    the per-channel ``w_scale``."""
    xq = torch.clamp(torch.round(x / act_scale), -qmax - 1, qmax).to(
        torch.int8)
    # the int32 sums in float64, where every one is exact (|sum| < 2^53);
    # CUDA has no int32 product
    acc = torch.tensordot(xq.to(torch.float64), wq.to(torch.float64),
                          ([x.dim() - 1], [0])).to(torch.int32)
    return acc.to(torch.float32) * (act_scale * w_scale)
