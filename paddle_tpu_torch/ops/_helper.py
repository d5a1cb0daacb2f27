"""Helpers that define ops tersely: the counterpart of
``paddle_tpu/ops/_helper.py``.

``def_unary`` and ``def_binary`` register a body under the op's name and
return the user-facing wrapper (also collected as a ``Tensor`` method);
``make_inplace`` builds the ``op_`` variant; ``tensor_method`` marks any
function as a ``Tensor`` method. ``ops/__init__.py`` attaches them all.

Type promotion is the reference's (JAX's rules with x64 on), worked out
here once for every binary op: two tensors to ``promote_types`` of their
types (a 0-d tensor as any other), a tensor's own type beside a Python
scalar of its kind, float64 for an integer or bool tensor beside a Python
float, int64 for a bool tensor beside a Python int. An ``inexact`` op then
takes an integer result to float (int64 to float64, narrower integers and
bool to float32).
"""
from __future__ import annotations

import functools

import torch

from .._core.dispatch import apply
from .._core.op_registry import register_op
from .._core.tensor import Tensor

_TENSOR_METHODS = {}


def tensor_method(name):
    """Marks a function to become ``Tensor.<name>`` as well."""
    def deco(fn):
        _TENSOR_METHODS[name] = fn
        return fn
    return deco


def attach_tensor_methods():
    for name, fn in _TENSOR_METHODS.items():
        setattr(Tensor, name, fn)


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
        return t.dtype if t.dtype.is_floating_point or t.dtype.is_complex \
            else torch.float64
    if isinstance(s, complex):
        return t.dtype if t.dtype.is_complex else torch.complex128
    raise TypeError(f"unsupported operand {type(s).__name__}")


def cast_to(x, dt):
    """A payload at type ``dt`` (a Python scalar as it is, but no bool
    where ``dt`` is not bool: torch refuses bool scalars in some ops)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == dt else x.to(dt)
    if isinstance(x, bool) and dt != torch.bool:
        return int(x)
    return x


def promoted(x, y, to_inexact=False, bool_as=None, scalars=True):
    """``x`` and ``y`` at the reference's result type: payloads, with a
    Python scalar ``y`` left a scalar where ``scalars`` (torch's op takes
    one) and made a 0-d tensor on the other's device otherwise (a fill,
    never a copy from the host)."""
    dt = result_type(x, y)
    if to_inexact:
        dt = inexact(dt)
    elif dt == torch.bool and bool_as is not None:
        dt = bool_as
    x, y = cast_to(x, dt), cast_to(y, dt)
    if not isinstance(x, torch.Tensor):
        x = torch.full((), x, dtype=dt, device=y.device)
    elif not isinstance(y, torch.Tensor) and not scalars:
        y = torch.full((), y, dtype=dt, device=x.device)
    return x, y


def argsort_nan_last(x, dim):
    """A stable ascending argsort with NaN last on every device (torch's
    CUDA sort of bf16 places NaN otherwise than its CPU sort): NaN sorted
    as +inf, then a stable sort on the NaN flag moves them after it."""
    if not (x.is_floating_point() or x.is_complex()):
        return torch.sort(x, dim=dim, stable=True).indices
    nan = torch.isnan(x)
    key = torch.where(nan, torch.inf, x)
    order = torch.sort(key, dim=dim, stable=True).indices
    flag = torch.take_along_dim(nan, order, dim).to(torch.uint8)
    return torch.take_along_dim(
        order, torch.sort(flag, dim=dim, stable=True).indices, dim)


def low_in_f32(fn):
    """``fn`` computed in float32 when its tensor arguments are bf16 or
    fp16, its result rounded once to that type (a running sum or product,
    or a composite body, in the low type would round at every step, on the
    card otherwise than on the CPU)."""
    low_types = (torch.bfloat16, torch.float16)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        low = next((a.dtype for a in args if isinstance(a, torch.Tensor)
                    and a.dtype in low_types), None)
        if low is None:
            return fn(*args, **kwargs)
        return fn(*[a.float() if isinstance(a, torch.Tensor)
                    and a.dtype in low_types else a for a in args],
                  **kwargs).to(low)
    return run


def sort_nan_last(x, dim):
    """(values, indices) of ``argsort_nan_last``; the values a gather of
    ``x``, so the gradient reaches the elements they came from."""
    idx = argsort_nan_last(x, dim)
    return torch.take_along_dim(x, idx, dim), idx


def def_unary(name, fn, to_inexact=False):
    """Op ``name``: ``fn`` of one payload (taken to its float type first
    when ``to_inexact``, as the reference's transcendental ops do, and
    computed in float32 for bf16/fp16, rounded once, as XLA computes
    them: torch's CPU kernels for the low types may land an ulp from
    that, and from its CUDA kernels, on the other side)."""
    if to_inexact:
        low_fn = low_in_f32(fn)

        def body(x):
            return low_fn(cast_to(x, inexact(x.dtype)))
    else:
        def body(x):
            return fn(x)
    register_op(name, body)

    def wrapper(x, name=None):
        return apply(op_name, body, x)
    op_name = name
    wrapper.__name__ = name
    _TENSOR_METHODS[name] = wrapper
    return wrapper


def def_binary(name, fn, to_inexact=False, bool_as=None, scalars=True):
    """Op ``name``: ``fn`` of two payloads (or a payload and a Python
    scalar) promoted to the reference's result type (see the module
    docstring; ``bool_as`` is the type JAX computes a bool result in;
    ``scalars``: ``fn`` takes a Python scalar second operand)."""
    def body(x, y):
        return fn(*promoted(x, y, to_inexact, bool_as, scalars))
    register_op(name, body)

    def wrapper(x, y, name=None):
        return apply(op_name, body, x, y)
    op_name = name
    wrapper.__name__ = name
    _TENSOR_METHODS[name] = wrapper
    return wrapper


def make_inplace(fn, name):
    """The ``op_`` variant of ``fn``: its result takes the place of
    ``self``'s payload (``Tensor._adopt``), as the reference's in-place ops
    adopt a functional result. The old payload is never written, so what
    autograd saved of it stays valid and no view of it sees the write."""
    def inplace(self, *args, **kwargs):
        return self._adopt(fn(self, *args, **kwargs))
    inplace.__name__ = name
    _TENSOR_METHODS[name] = inplace
    return inplace
