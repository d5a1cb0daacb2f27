"""Convolutions: the counterpart of ``paddle_tpu/nn/functional/conv.py``.

The reference convolves with ``lax.conv_general_dilated``, plain XLA and
no Pallas kernel; the port calls ``torch.nn.functional.conv2d`` (cuDNN on
the card). Signatures and semantics are the reference's:

- weights are paddle's ``[out, in / groups, kh, kw]`` in both layouts (the
  reference transposes them to HWIO for NHWC; here an NHWC input is
  permuted to NCHW and back, the weight used as it is);
- padding is an int, one int per spatial dim, ``2n`` ints (low, high per
  dim), ``n`` (low, high) pairs, ``"SAME"`` or ``"VALID"``. ``"SAME"``
  is XLA's: ``total = max((ceil(in / s) - 1) s + (k - 1) d + 1 - in, 0)``
  per dim, ``total // 2`` on the low side, the rest on the high side, at
  any stride (torch's ``padding="same"`` refuses stride > 1, so every
  uneven padding is applied with ``F.pad`` before the convolution);
- the bias is added after the product has been rounded to the io type,
  as the reference's ``out + b`` is;
- the ops carry the reference's names (``conv2d``, ``conv2d_transpose``:
  AMP's white list), so under O1 they run in the low type.

The default ``data_format`` of ``conv2d`` is the reference's
``FLAGS_conv_data_format`` default, ``"NCHW"`` (kept here as
:data:`CONV_DATA_FORMAT`: the port has no flags module).
"""
from __future__ import annotations

import numbers

import torch.nn.functional as tF

from ..._core.dispatch import apply

CONV_DATA_FORMAT = "NCHW"  # the reference's FLAGS_conv_data_format default


def _pair(v, n=2):
    if isinstance(v, numbers.Integral):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _norm_padding(padding, n=2):
    """The reference's ``_norm_padding``: ``"SAME"``/``"VALID"`` or n
    (low, high) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, numbers.Integral):
        return tuple((int(padding), int(padding)) for _ in range(n))
    padding = list(padding)
    if len(padding) == n and all(
            isinstance(p, numbers.Integral) for p in padding):
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    return tuple(tuple(int(q) for q in p) for p in padding)


def _same_pads(in_sizes, ksize, stride, dilation):
    """XLA's ``SAME`` padding: (low, high) per spatial dim."""
    pads = []
    for size, k, s, d in zip(in_sizes, ksize, stride, dilation):
        total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _conv_pads(x, w, padding, stride, dilation, dims):
    if padding == "VALID":
        return ((0, 0),) * dims
    if padding == "SAME":
        return _same_pads(x.shape[2:], w.shape[2:], stride, dilation)
    return padding


def _to_nc(x, fmt):
    """Channels-last input as channels-first (the kernel's layout)."""
    return x if fmt.startswith("NC") else x.movedim(-1, 1)


def _from_nc(out, fmt):
    return out if fmt.startswith("NC") else out.movedim(1, -1)


def _padded(x, pads):
    """x with explicit (low, high) zero padding on its spatial dims, and
    the symmetric padding left to the convolution itself."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    return tF.pad(x, flat), (0,) * len(pads)


def _bias(out, b, dims):
    return out if b is None else out + b.reshape((1, -1) + (1,) * dims)


def _conv(x, w, b, stride, padding, dilation, groups, dims, fmt):
    x = _to_nc(x, fmt)
    pads = _conv_pads(x, w, padding, stride, dilation, dims)
    x, sym = _padded(x, pads)
    conv = tF.conv2d if dims == 2 else tF.conv1d
    out = conv(x, w, None, stride, sym, dilation, groups)
    return _from_nc(_bias(out, b, dims), fmt)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format=None, name=None):
    """2-D convolution, ``x`` NCHW or NHWC, weight ``[out, in / groups,
    kh, kw]``."""
    return apply("conv2d", _conv, x, weight, bias, stride=_pair(stride),
                 padding=_norm_padding(padding), dilation=_pair(dilation),
                 groups=int(groups), dims=2,
                 fmt=data_format or CONV_DATA_FORMAT)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution, ``x`` NCL or NLC, weight ``[out, in / groups, k]``
    (the reference's op ``conv2d`` with one spatial dim)."""
    return apply("conv2d", _conv, x, weight, bias, stride=_pair(stride, 1),
                 padding=_norm_padding(padding, 1),
                 dilation=_pair(dilation, 1), groups=int(groups), dims=1,
                 fmt="NCHW" if data_format == "NCL" else "NHWC")


def _conv_transpose(x, w, b, stride, padding, output_padding, dilation,
                    groups, fmt):
    """The reference builds a fractionally strided convolution with the
    per-group in/out-swapped, spatially flipped weight, padded
    ``(k - 1 - lo, k - 1 - hi + output_padding)`` per dim (k dilated):
    the same function as a transposed convolution with (lo, hi) padding."""
    if isinstance(padding, str):
        raise ValueError("string padding unsupported for conv_transpose")
    x = _to_nc(x, fmt)
    # torch's transposed convolution takes paddle's [in, out / groups, k]
    # weight as it is but pads symmetrically: run it at min(lo, hi) per
    # dim, whose output holds the reference's, and cut the rest off each
    # side (output_padding extends the high side in both)
    sym = tuple(min(lo, hi) for lo, hi in padding)
    out = tF.conv_transpose2d(x, w, None, stride, sym, output_padding,
                              groups, dilation)
    cut = tuple(slice(lo - p, out.shape[2 + i] - (hi - p))
                for i, ((lo, hi), p) in enumerate(zip(padding, sym)))
    return _from_nc(_bias(out[(Ellipsis,) + cut], b, 2), fmt)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    """Transposed 2-D convolution, weight ``[in, out / groups, kh, kw]``;
    ``output_size`` is taken and ignored, as in the reference."""
    return apply("conv2d_transpose", _conv_transpose, x, weight, bias,
                 stride=_pair(stride), padding=_norm_padding(padding),
                 output_padding=_pair(output_padding),
                 dilation=_pair(dilation), groups=int(groups),
                 fmt=data_format)
