"""Pooling: the counterpart of ``paddle_tpu/nn/functional/pooling.py``.

The reference pools with ``lax.reduce_window``, plain XLA and no Pallas
kernel; the port pools with PyTorch's own pooling ops on an input it pads
itself, so that every rule is the reference's:

- max pooling pads with -inf; ``return_mask`` gives the flat index of
  each window's first maximum in the unpadded ``H * W`` plane (int32);
- ``ceil_mode`` extends the high side so that the last partial window is
  kept, and drops a window that would start in the right padding
  (``_pool_geometry``, copied from the reference);
- average pooling defaults to ``exclusive=True`` (only real cells count,
  torch's ``count_include_pad=False``); with ``exclusive=False`` the
  symmetric padding counts and the ``ceil_mode`` extension does not (as
  torch's ``count_include_pad=True`` counts them; padding here is
  explicit because the reference also takes (low, high) pairs, which
  torch's pooling does not); ``divisor_override`` divides every window's
  sum by one number;
- the adaptive pools' bins are ``floor(i H / o) .. ceil((i + 1) H / o)``,
  the same bins as PyTorch's adaptive pools, which compute them;
- the op names are the reference's (``max_pool_nd``, ``avg_pool_nd``,
  ``adaptive_avg_pool2d``, ``adaptive_max_pool2d``): on neither AMP list,
  so a pool keeps its input's type.
"""
from __future__ import annotations

import numbers

import torch
import torch.nn.functional as tF

from ..._core.dispatch import apply
from ...ops.manipulation import squeeze, unsqueeze
from .conv import _pair


def _pool_pads(padding, n=2):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, numbers.Integral):
        return tuple((int(padding), int(padding)) for _ in range(n))
    padding = list(padding)
    if len(padding) == n and all(
            isinstance(p, numbers.Integral) for p in padding):
        return tuple((int(p), int(p)) for p in padding)
    return tuple(tuple(int(q) for q in p) for p in padding)


def _resolve_pads(padding, in_sizes, ksize, stride):
    if isinstance(padding, str):
        if padding == "VALID":
            return tuple((0, 0) for _ in ksize)
        pads = []  # SAME
        for size, k, s in zip(in_sizes, ksize, stride):
            o = -(-size // s)
            tot = max(0, (o - 1) * s + k - size)
            pads.append((tot // 2, tot - tot // 2))
        return tuple(pads)
    return padding


def _pool_geometry(in_sizes, ksize, stride, pads, ceil_mode):
    """Output sizes and the extra high-side padding that implements
    ``ceil_mode`` (the reference's own rule)."""
    outs, extras = [], []
    for size, k, s, (pl, ph) in zip(in_sizes, ksize, stride, pads):
        eff = size + pl + ph - k
        o = (-(-eff // s) if ceil_mode else eff // s) + 1
        if ceil_mode and (o - 1) * s >= size + pl:
            # windows starting in the right padding are dropped
            o -= 1
        extras.append(max(0, (o - 1) * s + k - (size + pl + ph)))
        outs.append(o)
    return outs, extras


def _nchw(x, fmt):
    return x if fmt.startswith("NC") else x.movedim(-1, 1)


def _undo(x, fmt):
    return x if fmt.startswith("NC") else x.movedim(1, -1)


def _spatial_pad(x, pads, value):
    """(low, high) per spatial dim of a [N, C, H, W] tensor."""
    flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
    return tF.pad(x, flat, value=value) if any(flat) else x


def _windows(x, ksize, stride, padding, ceil_mode):
    padding = _resolve_pads(padding, x.shape[2:], ksize, stride)
    _, extras = _pool_geometry(x.shape[2:], ksize, stride, padding,
                               ceil_mode)
    full = tuple((pl, ph + e) for (pl, ph), e in zip(padding, extras))
    return padding, extras, full


def _max_pool_nd(x, ksize, stride, padding, ceil_mode, fmt, with_index):
    x = _nchw(x, fmt)
    _, _, full = _windows(x, ksize, stride, padding, ceil_mode)
    neg = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    xp = _spatial_pad(x, full, neg)
    if not with_index:
        return _undo(tF.max_pool2d(xp, ksize, stride), fmt)
    out, idx = tF.max_pool2d(xp, ksize, stride, return_indices=True)
    # an index into the padded plane -> into the unpadded H x W plane
    h, w = x.shape[2:]
    wp = xp.shape[3]
    row = torch.clamp(idx // wp - full[0][0], 0, h - 1)
    col = torch.clamp(idx % wp - full[1][0], 0, w - 1)
    flat = (row * w + col).to(torch.int32)
    return _undo(out, fmt), _undo(flat, fmt)


def _avg_pool_nd(x, ksize, stride, padding, ceil_mode, fmt, exclusive,
                 divisor):
    x = _nchw(x, fmt)
    padding, extras, full = _windows(x, ksize, stride, padding, ceil_mode)
    # window sums: divisor_override=1 sums without dividing
    summed = tF.avg_pool2d(_spatial_pad(x, full, 0.0), ksize, stride,
                           divisor_override=1)
    if divisor is not None:
        return _undo(summed / divisor, fmt)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if exclusive:  # only real cells count
        onesp = _spatial_pad(ones, full, 0.0)
    else:  # real and symmetric-pad cells count, the ceil extension not
        onesp = _spatial_pad(_spatial_pad(ones, padding, 1.0),
                             tuple((0, e) for e in extras), 0.0)
    counts = tF.avg_pool2d(onesp, ksize, stride, divisor_override=1)
    return _undo(summed / torch.clamp(counts, min=1), fmt)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    ksize = _pair(kernel_size)
    stride = ksize if stride is None else _pair(stride)
    op = "max_pool_nd_index" if return_mask else "max_pool_nd"
    return apply(op, _max_pool_nd, x, ksize=ksize, stride=stride,
                 padding=_pool_pads(padding), ceil_mode=bool(ceil_mode),
                 fmt=data_format, with_index=bool(return_mask))


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    ksize = _pair(kernel_size)
    stride = ksize if stride is None else _pair(stride)
    return apply("avg_pool_nd", _avg_pool_nd, x, ksize=ksize, stride=stride,
                 padding=_pool_pads(padding), ceil_mode=bool(ceil_mode),
                 fmt=data_format, exclusive=bool(exclusive),
                 divisor=divisor_override)


def _lift_1d(kernel_size, stride, padding):
    """A 1-D pool as a 2-D one over ``[N, C, L, 1]``, as the reference
    runs it."""
    ksize = (_pair(kernel_size, 1)[0], 1)
    stride = ksize if stride is None else (_pair(stride, 1)[0], 1)
    pad = _pool_pads(padding, 1)
    if not isinstance(pad, str):
        pad = (pad[0], (0, 0))
    return ksize, stride, pad


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, name=None):
    ksize, stride, pad = _lift_1d(kernel_size, stride, padding)
    op = "max_pool_nd_index" if return_mask else "max_pool_nd"
    out = apply(op, _max_pool_nd, unsqueeze(x, 3), ksize=ksize,
                stride=stride, padding=pad, ceil_mode=bool(ceil_mode),
                fmt="NCHW", with_index=bool(return_mask))
    if return_mask:
        return squeeze(out[0], 3), squeeze(out[1], 3)
    return squeeze(out, 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, name=None):
    ksize, stride, pad = _lift_1d(kernel_size, stride, padding)
    out = apply("avg_pool_nd", _avg_pool_nd, unsqueeze(x, 3), ksize=ksize,
                stride=stride, padding=pad, ceil_mode=bool(ceil_mode),
                fmt="NCHW", exclusive=bool(exclusive), divisor=None)
    return squeeze(out, 3)


def _adaptive(pool):
    def run(x, out_hw, fmt):
        return _undo(pool(_nchw(x, fmt), out_hw), fmt)
    return run


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return apply("adaptive_avg_pool2d", _adaptive(tF.adaptive_avg_pool2d),
                 x, out_hw=_pair(output_size), fmt=data_format)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """The maxima alone: ``return_mask`` is taken and ignored, as in the
    reference."""
    return apply("adaptive_max_pool2d", _adaptive(tF.adaptive_max_pool2d),
                 x, out_hw=_pair(output_size), fmt="NCHW")


def adaptive_avg_pool1d(x, output_size, name=None):
    out = adaptive_avg_pool2d(unsqueeze(x, 3), (int(output_size), 1))
    return squeeze(out, 3)
