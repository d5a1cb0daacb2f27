"""Shape and type manipulation: the counterpart of
``paddle_tpu/ops/manipulation.py``, in paddle's signatures (``perm``,
``axis``, lists of Tensors).

Several torch functions here return views of their input (``reshape``,
``transpose``, ``expand``, ``squeeze``); the port's in-place ops replace a
tensor's payload instead of writing through it (``Tensor._adopt``), so no
op of the port changes a view's values behind it, as the reference's
copies never change.
"""
from __future__ import annotations

import numbers

import torch

from .._core import dtype as dtypes
from .._core.dispatch import apply
from .._core.op_registry import register_op
from .._core.tensor import Tensor
from ._helper import tensor_method


def _int(s):
    """An int, or a symbolic size as it is (a traced program with a
    dynamic dim keeps the dim symbolic)."""
    return s if isinstance(s, torch.SymInt) else int(s)


def _ints(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (numbers.Integral, torch.SymInt)):
        return (_int(shape),)
    return tuple(_int(s) for s in shape)


def _ndim(x):
    return x.ndim if isinstance(x, (Tensor, torch.Tensor)) else \
        torch.as_tensor(x).dim()


def _shape(x):
    return tuple(x.shape)


@register_op("reshape")
def _reshape(x, shape):
    return x.reshape(shape)


@tensor_method("reshape")
def reshape(x, shape, name=None):
    return apply("reshape", _reshape, x, shape=_ints(shape))


@register_op("cast")
def _cast(x, dtype):
    dt = dtypes.to_torch(dtype)
    return x if x.dtype == dt else x.to(dt)


@tensor_method("cast")
def cast(x, dtype):
    """``x`` in ``dtype``; ``x`` itself where it has that type already, as
    in the reference (no op runs, and none is recorded)."""
    d = dtypes.to_dtype(dtype)
    if getattr(x, "_t", x).dtype == d.torch_dtype:
        return x
    return apply("cast", _cast, x, dtype=d.name)


astype = tensor_method("astype")(cast)


@register_op("transpose")
def _transpose(x, perm):
    return x.permute(perm)


@tensor_method("transpose")
def transpose(x, perm, name=None):
    return apply("transpose", _transpose, x, perm=_ints(perm))


@tensor_method("t")
def t(x, name=None):
    if _ndim(x) < 2:
        return x
    if _ndim(x) != 2:
        raise ValueError("t() expects a 0-, 1- or 2-D tensor")
    return transpose(x, [1, 0])


@register_op("flatten_")
def _flatten(x, start, stop):
    return x.reshape(x.shape[:start] + (-1,) + x.shape[stop + 1:])


@tensor_method("flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = max(_ndim(x), 1)
    return apply("flatten_", _flatten, x, start=int(start_axis) % nd,
                 stop=int(stop_axis) % nd)


@register_op("squeeze")
def _squeeze(x, axes):
    # no axis left (none given, or none of size 1): every axis of size 1,
    # as the reference's jnp.squeeze(x, None)
    return torch.squeeze(x, axes) if axes else torch.squeeze(x)


@tensor_method("squeeze")
def squeeze(x, axis=None, name=None):
    if axis is None:
        axes = ()
    else:
        shape, nd = _shape(x), _ndim(x)
        axes = (axis,) if isinstance(axis, numbers.Integral) else \
            tuple(axis)
        axes = tuple(int(a) % nd for a in axes)
        axes = tuple(a for a in axes if shape[a] == 1)
    return apply("squeeze", _squeeze, x, axes=axes)


@register_op("unsqueeze")
def _unsqueeze(x, axes):
    nd = x.dim() + len(axes)
    for a in sorted(int(a) % nd for a in axes):
        x = x.unsqueeze(a)
    return x


@tensor_method("unsqueeze")
def unsqueeze(x, axis, name=None):
    axes = (axis,) if isinstance(axis, numbers.Integral) else \
        tuple(int(a) for a in axis)
    return apply("unsqueeze", _unsqueeze, x, axes=axes)


@register_op("concat_")
def _concat(*xs, axis):
    return torch.cat(xs, axis)


def concat(x, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply("concat_", _concat, *list(x), axis=int(axis))


@register_op("stack_")
def _stack(*xs, axis):
    return torch.stack(xs, axis)


def stack(x, axis=0, name=None):
    return apply("stack_", _stack, *list(x), axis=int(axis))


@register_op("split_", multi_output=True)
def _split(x, indices, axis):
    return tuple(torch.tensor_split(x, list(indices), axis))


@tensor_method("split")
def split(x, num_or_sections, axis=0, name=None):
    shape = _shape(x)
    axis = int(axis) % len(shape)
    dim = shape[axis]
    if isinstance(num_or_sections, numbers.Integral):
        n = int(num_or_sections)
        if dim % n:
            raise ValueError(f"dim {dim} not divisible by {n}")
        indices = tuple((dim // n) * i for i in range(1, n))
    else:  # one -1 takes what the others leave
        known = sum(int(s) for s in num_or_sections if int(s) >= 0)
        sections = [dim - known if int(s) < 0 else int(s)
                    for s in num_or_sections]
        indices = tuple(sum(sections[:i + 1])
                        for i in range(len(sections) - 1))
    return list(apply("split_", _split, x, indices=indices, axis=axis))


@tensor_method("chunk")
def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@register_op("unbind_", multi_output=True)
def _unbind(x, axis):
    return tuple(torch.unbind(x, axis))


@tensor_method("unbind")
def unbind(x, axis=0):
    return list(apply("unbind_", _unbind, x, axis=int(axis) % _ndim(x)))


@register_op("tile")
def _tile(x, reps):
    return torch.tile(x, reps)


@tensor_method("tile")
def tile(x, repeat_times, name=None):
    return apply("tile", _tile, x, reps=_ints(repeat_times))


@register_op("expand")
def _expand(x, shape):
    return torch.broadcast_to(x, shape)


@tensor_method("expand")
def expand(x, shape, name=None):
    shape, xs = list(_ints(shape)), _shape(x)
    off = len(shape) - len(xs)
    shape = [xs[i - off] if s == -1 else s for i, s in enumerate(shape)]
    return apply("expand", _expand, x, shape=tuple(shape))


@tensor_method("expand_as")
def expand_as(x, y, name=None):
    return apply("expand", _expand, x, shape=_shape(y))


@tensor_method("broadcast_to")
def broadcast_to(x, shape, name=None):
    return apply("expand", _expand, x, shape=_ints(shape))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[_shape(t) for t in inputs])
    return [apply("expand", _expand, t, shape=tuple(shape)) for t in inputs]


@register_op("flip")
def _flip(x, axes):
    return torch.flip(x, axes)


@tensor_method("flip")
def flip(x, axis, name=None):
    axes = (axis,) if isinstance(axis, numbers.Integral) else \
        tuple(int(a) for a in axis)
    return apply("flip", _flip, x, axes=axes)


@register_op("roll_")
def _roll(x, shifts, axes):
    return torch.roll(x, shifts, axes)


@tensor_method("roll")
def roll(x, shifts, axis=None, name=None):
    if axis is None:
        out = apply("roll_", _roll, flatten(x), shifts=shifts, axes=0)
        return reshape(out, _shape(x))
    return apply("roll_", _roll, x, shifts=shifts, axes=axis)


@register_op("repeat_interleave_")
def _repeat_interleave(x, repeats, axis):
    if isinstance(repeats, int):  # the output's length given: no host read
        return torch.repeat_interleave(x, repeats, axis,
                                       output_size=x.shape[axis] * repeats)
    size = sum(int(r) for r in repeats)
    return torch.repeat_interleave(
        x, torch.as_tensor(repeats, device=x.device), axis, output_size=size)


@tensor_method("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):  # the output's length depends on it
        repeats = tuple(repeats.tolist())
    if axis is None:
        x, axis = flatten(x), 0
    return apply("repeat_interleave_", _repeat_interleave, x,
                 repeats=repeats, axis=int(axis))


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


@register_op("pad_")
def _pad(x, pad_width, mode, value):
    flat = [p for lo_hi in reversed(pad_width) for p in lo_hi]
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, value=value)
    # torch pads the trailing axes only, and needs a batch axis or two in
    # front of them: pad the axes that are padded, over a view that has
    # those in front
    k = next((i for i, p in enumerate(pad_width) if p != (0, 0)),
             len(pad_width))
    lead = x.shape[:k]
    y = x.reshape((-1,) + x.shape[k:]) if k else x.unsqueeze(0)
    out = torch.nn.functional.pad(y, flat[:2 * (x.dim() - k)], mode=mode)
    return out.reshape(lead + out.shape[1:]) if k else out.squeeze(0)


def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None):
    """``pad`` as per-axis [lo, hi] pairs for every axis, or flat pairs
    for the last axes, the last axis first (paddle's and torch's order)."""
    if isinstance(pad, Tensor):
        pad = pad.tolist()
    pad, nd = [int(p) for p in pad], _ndim(x)
    if len(pad) == 2 * nd:
        width = tuple((pad[2 * i], pad[2 * i + 1]) for i in range(nd))
    else:
        k = len(pad) // 2
        width = tuple([(0, 0)] * (nd - k) + [
            (pad[2 * i], pad[2 * i + 1]) for i in range(k - 1, -1, -1)])
    return apply("pad_", _pad, x, pad_width=width, mode=_PAD_MODES[mode],
                 value=float(value))


@register_op("diagonal_")
def _diagonal(x, offset, axis1, axis2):
    return torch.diagonal(x, offset, axis1, axis2)


@tensor_method("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("diagonal_", _diagonal, x, offset=int(offset),
                 axis1=int(axis1), axis2=int(axis2))


@register_op("masked_fill_")
def _masked_fill(x, mask, v):
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, dtype=x.dtype, device=x.device)
    return torch.where(mask, v.to(x.dtype), x)


@tensor_method("masked_fill")
def masked_fill(x, mask, value, name=None):
    return apply("masked_fill_", _masked_fill, x, mask, value)


@register_op("moveaxis_")
def _moveaxis(x, src, dst):
    return torch.movedim(x, src, dst)


@tensor_method("moveaxis")
def moveaxis(x, source, destination, name=None):
    return apply("moveaxis_", _moveaxis, x, src=source, dst=destination)


@register_op("as_real")
def _as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


@register_op("as_complex")
def _as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return apply("as_real", _as_real, x)


def as_complex(x, name=None):
    return apply("as_complex", _as_complex, x)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards
    return apply("shard_index", lambda v: torch.where(
        torch.div(v, size, rounding_mode="floor") == shard_id, v % size,
        ignore_value), input)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


view_as = expand_as
