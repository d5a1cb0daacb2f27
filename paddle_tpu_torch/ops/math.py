"""Elementwise math: the counterpart of ``paddle_tpu/ops/math.py``.

Binary ops take ``Tensor``s, torch tensors or Python scalars and promote
as the reference does (``_helper``); ``divide`` and the other ops that
need a float take an integer result to float (int64 to float64, narrower
integers and bool to float32), as do the unary transcendental ops. The op
names are the reference's, so AMP's lists apply to them as they do there.
Bodies follow the reference's formulas where they differ from torch's
fused ones (``hypot`` is the square root of the sum of squares); bf16 and
fp16 transcendental and composite bodies compute in float32 and round
once, as XLA computes them.
"""
from __future__ import annotations

import torch

from .._core import dtype as dtypes
from .._core.dispatch import apply
from .._core.op_registry import register_op
from ._helper import (cast_to, def_binary, def_unary, inexact,  # noqa: F401
                      low_in_f32, promoted, result_type, tensor_method)

# --------------------------------------------------------------- unary
exp = def_unary("exp", torch.exp, True)
expm1 = def_unary("expm1", torch.expm1, True)
log = def_unary("log", torch.log, True)
log2 = def_unary("log2", torch.log2, True)
log10 = def_unary("log10", torch.log10, True)
log1p = def_unary("log1p", torch.log1p, True)
sqrt = def_unary("sqrt", torch.sqrt, True)
rsqrt = def_unary("rsqrt", torch.rsqrt, True)
abs = def_unary("abs", lambda x: x if x.dtype == torch.bool
                else torch.abs(x))
absolute = abs
neg = def_unary("neg", torch.neg)
negative = neg
sign = def_unary("sign", torch.sign)
floor = def_unary("floor", torch.floor)
ceil = def_unary("ceil", torch.ceil)
round = def_unary("round", torch.round)  # half to even, as jnp.round
trunc = def_unary("trunc", torch.trunc)
frac = def_unary("frac", lambda x: x - torch.trunc(x))
sin = def_unary("sin", torch.sin, True)
cos = def_unary("cos", torch.cos, True)
tan = def_unary("tan", torch.tan, True)
asin = def_unary("asin", torch.asin, True)
acos = def_unary("acos", torch.acos, True)
atan = def_unary("atan", torch.atan, True)
sinh = def_unary("sinh", torch.sinh, True)
cosh = def_unary("cosh", torch.cosh, True)
tanh = def_unary("tanh", torch.tanh, True)
asinh = def_unary("asinh", torch.asinh, True)
acosh = def_unary("acosh", torch.acosh, True)
atanh = def_unary("atanh", torch.atanh, True)
erf = def_unary("erf", torch.erf, True)
erfinv = def_unary("erfinv", torch.erfinv, True)
sigmoid = def_unary("sigmoid", torch.sigmoid, True)
square = def_unary("square", lambda x: torch.square(
    x.to(torch.int32) if x.dtype == torch.bool else x))
reciprocal = def_unary("reciprocal", torch.reciprocal, True)
logit = def_unary("logit", torch.logit, True)
digamma = def_unary("digamma", torch.digamma, True)
lgamma = def_unary("lgamma", torch.lgamma, True)
conj = def_unary("conj", lambda x: torch.conj_physical(x)
                 if x.is_complex() else x)
real = def_unary("real", lambda x: torch.real(x).clone()
                 if x.is_complex() else x)
imag = def_unary("imag", lambda x: torch.imag(x).clone()
                 if x.is_complex() else torch.zeros_like(x))
isnan = def_unary("isnan", torch.isnan)
isinf = def_unary("isinf", torch.isinf)
isfinite = def_unary("isfinite", torch.isfinite)

# --------------------------------------------------------------- binary
add = def_binary("add", torch.add)
subtract = def_binary("subtract", torch.sub)
multiply = def_binary("multiply", torch.mul)
divide = def_binary("divide", torch.true_divide, to_inexact=True)
# JAX computes these three on bool operands in int32
floor_divide = def_binary("floor_divide", torch.floor_divide,
                          bool_as=torch.int32)
mod = def_binary("mod", torch.remainder, bool_as=torch.int32)
remainder = mod
floor_mod = mod
pow = def_binary("pow", torch.pow, bool_as=torch.int32)
maximum = def_binary("maximum", torch.maximum, scalars=False)
minimum = def_binary("minimum", torch.minimum, scalars=False)
fmax = def_binary("fmax", torch.fmax, scalars=False)
fmin = def_binary("fmin", torch.fmin, scalars=False)
atan2 = def_binary("atan2", low_in_f32(torch.atan2), to_inexact=True,
                   scalars=False)
logaddexp = def_binary("logaddexp", low_in_f32(torch.logaddexp),
                       to_inexact=True, scalars=False)
heaviside = def_binary("heaviside", torch.heaviside, to_inexact=True,
                       scalars=False)
hypot = def_binary("hypot", low_in_f32(lambda x, y: torch.sqrt(x * x + y * y)),
                   to_inexact=True)
nextafter = def_binary("nextafter", torch.nextafter, to_inexact=True,
                       scalars=False)
gcd = def_binary("gcd", torch.gcd, scalars=False)
lcm = def_binary("lcm", torch.lcm, scalars=False)

# --------------------------------------------------------------- comparison
equal = def_binary("equal", torch.eq)
not_equal = def_binary("not_equal", torch.ne)
greater_than = def_binary("greater_than", torch.gt)
greater_equal = def_binary("greater_equal", torch.ge)
less_than = def_binary("less_than", torch.lt)
less_equal = def_binary("less_equal", torch.le)

# --------------------------------------------------------------- logical
logical_and = def_binary("logical_and", torch.logical_and, scalars=False)
logical_or = def_binary("logical_or", torch.logical_or, scalars=False)
logical_xor = def_binary("logical_xor", torch.logical_xor, scalars=False)
logical_not = def_unary("logical_not", torch.logical_not)
bitwise_and = def_binary("bitwise_and", torch.bitwise_and)
bitwise_or = def_binary("bitwise_or", torch.bitwise_or)
bitwise_xor = def_binary("bitwise_xor", torch.bitwise_xor)
bitwise_not = def_unary("bitwise_not", torch.bitwise_not)


# --------------------------------------------------------------- scale et al
@register_op("scale")
def _scale(x, scale, bias, bias_after_scale):
    return x * scale + bias if bias_after_scale else (x + bias) * scale


@tensor_method("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    return apply("scale", _scale, x, scale=float(scale), bias=float(bias),
                 bias_after_scale=bool(bias_after_scale))


@register_op("clip")
def _clip(x, lo, hi):
    if lo is None and hi is None:
        return x.clone()
    return torch.clamp(x, lo, hi)


@tensor_method("clip")
def clip(x, min=None, max=None, name=None):
    return apply("clip", _clip, x, min, max)


@register_op("lerp")
def _lerp(x, y, w):
    return x + w * (y - x)


@tensor_method("lerp")
def lerp(x, y, weight, name=None):
    return apply("lerp", _lerp, x, y, weight)


@register_op("cumsum_")
def _cumsum(x, axis, reverse, dtype):
    if dtype is not None:
        x = x.to(dtypes.to_torch(dtype))
    if reverse:
        x = torch.flip(x, (axis,))
    out = low_in_f32(torch.cumsum)(x, axis)
    if dtype is None and not x.is_floating_point() and not x.is_complex() \
            and x.dtype != torch.bool:
        out = out.to(x.dtype)  # JAX sums integers in their own type
    return torch.flip(out, (axis,)) if reverse else out


def _flat(x, axis):
    """``x`` flattened when ``axis`` is None (the cumulative ops' rule)."""
    if axis is None:
        from .manipulation import flatten
        return flatten(x), 0
    return x, int(axis)


@tensor_method("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat(x, axis)
    d = None if dtype is None else dtypes.to_dtype(dtype).name
    return apply("cumsum_", _cumsum, x, axis=axis, reverse=False, dtype=d)


@register_op("cumprod_")
@low_in_f32
def _cumprod(x, axis):
    """The running product as a Hillis-Steele scan (log2 n passes of
    pairwise products): its gradient is zero-safe and reads nothing back,
    where torch's cumprod backward asks the host whether x holds a zero."""
    y = torch.movedim(x, axis, -1)
    n, step = y.shape[-1], 1
    while step < n:
        y = torch.cat([y[..., :step], y[..., step:] * y[..., :-step]], -1)
        step *= 2
    return torch.movedim(y, -1, axis)


@tensor_method("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    out = apply("cumprod_", _cumprod, x, axis=int(dim))
    if dtype is not None:
        from .manipulation import cast
        out = cast(out, dtype)
    return out


@register_op("logcumsumexp_")
@low_in_f32
def _logcumsumexp(x, axis):
    return torch.logcumsumexp(x, axis)


@tensor_method("logcumsumexp")
def logcumsumexp(x, axis=None, dtype=None, name=None):
    x, axis = _flat(x, axis)
    return apply("logcumsumexp_", _logcumsumexp, x, axis=axis)


def increment(x, value=1.0, name=None):
    return x._adopt(add(x, value))


@register_op("stanh")
def _stanh(x, scale_a, scale_b):
    return scale_b * torch.tanh(scale_a * x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply("stanh", _stanh, x, scale_a=float(scale_a),
                 scale_b=float(scale_b))


register_op("rsqrt_grad_friendly", torch.rsqrt)
register_op("multiply_no_broadcast",
            lambda x, y: torch.mul(*promoted(x, y)))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    from .parity import _allclose
    return apply("allclose_k", _allclose, x, y, rtol=float(rtol),
                 atol=float(atol), equal_nan=bool(equal_nan))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    from .parity import _isclose
    return apply("isclose_k", _isclose, x, y, rtol=float(rtol),
                 atol=float(atol), equal_nan=bool(equal_nan))


def equal_all(x, y, name=None):
    from .parity import _equal_all
    return apply("equal_all_k", _equal_all, x, y)


@register_op("nan_to_num")
def _nan_to_num(x, nan, posinf, neginf):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@tensor_method("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply("nan_to_num", _nan_to_num, x, nan=float(nan),
                 posinf=posinf, neginf=neginf)
