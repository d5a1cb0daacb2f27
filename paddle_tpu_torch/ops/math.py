"""Elementwise math: the counterpart of ``paddle_tpu/ops/math.py``.

Binary ops take ``Tensor``s, torch tensors or Python scalars and promote
as the reference does (JAX's rules with x64 on): two tensors to
``promote_types`` of their types (a 0-d tensor as any other), a tensor's
own type beside a Python scalar of its kind, float64 for an integer or bool tensor beside a Python
float, int64 for a bool tensor beside a Python int; ``divide`` then takes
int64 to float64 and narrower integers and bool to float32 (as do the
unary ops that need a float: ``exp``, ``log``, ``tanh``). The op names
are the reference's, so AMP's lists apply to them as they do there.
"""
from __future__ import annotations

import torch

from .._core.dispatch import apply


def inexact(dt: torch.dtype) -> torch.dtype:
    """The reference's float type for results of ``dt`` inputs."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.float64 if dt in (torch.int64, torch.uint64) \
        else torch.float32


def result_type(x, y) -> torch.dtype:
    """The reference's type of ``x op y`` for payloads or Python scalars
    (at least one a tensor)."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return torch.promote_types(x.dtype, y.dtype)
    t, s = (x, y) if isinstance(x, torch.Tensor) else (y, x)
    if isinstance(s, bool):
        return t.dtype
    if isinstance(s, int):
        return torch.int64 if t.dtype == torch.bool else t.dtype
    if isinstance(s, float):
        return t.dtype if t.dtype.is_floating_point else torch.float64
    raise TypeError(f"unsupported operand {type(s).__name__}")


def _cast(x, dt):
    if isinstance(x, torch.Tensor):
        return x if x.dtype == dt else x.to(dt)
    if isinstance(x, bool) and dt != torch.bool:
        return int(x)  # torch refuses bool scalars in some ops (x - True)
    return x


def _binary(name, fn, to_inexact=False, bool_as=None):
    def body(x, y):
        dt = result_type(x, y)
        if to_inexact:
            dt = inexact(dt)
        elif dt == torch.bool and bool_as is not None:
            dt = bool_as
        x, y = _cast(x, dt), _cast(y, dt)
        if not isinstance(x, torch.Tensor):  # scalar first: pow, rsub
            x = torch.tensor(x, dtype=dt, device=y.device)
        return fn(x, y)

    def op(x, y, name=None):
        return apply(op_name, body, x, y)

    op_name = name
    op.__name__ = name
    return op


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide, to_inexact=True)
# JAX computes these two on bool operands in int32
floor_divide = _binary("floor_divide", torch.floor_divide,
                       bool_as=torch.int32)
remainder = _binary("mod", torch.remainder)
mod = remainder
pow = _binary("pow", torch.pow, bool_as=torch.int32)


def _compare(name, fn):
    def op(x, y, name=None):
        return apply(op_name, lambda a, b: fn(a, b), x, y)
    op_name = name
    op.__name__ = name
    return op


equal = _compare("equal", torch.eq)
not_equal = _compare("not_equal", torch.ne)
less_than = _compare("less_than", torch.lt)
less_equal = _compare("less_equal", torch.le)
greater_than = _compare("greater_than", torch.gt)
greater_equal = _compare("greater_equal", torch.ge)


def _unary(name, fn, to_inexact=False):
    def body(x):
        return fn(_cast(x, inexact(x.dtype)) if to_inexact else x)

    def op(x, name=None):
        return apply(op_name, body, x)

    op_name = name
    op.__name__ = name
    return op


exp = _unary("exp", torch.exp, True)
log = _unary("log", torch.log, True)
tanh = _unary("tanh", torch.tanh, True)
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
