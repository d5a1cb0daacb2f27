"""The long-tail functionals: the counterpart of
``paddle_tpu/nn/functional/extended.py`` (sampling, rearrangement, the
3-D pools and transposed convolution, folds and the extra losses), in
plain PyTorch from the reference's formulas and under its op names.

Conventions the reference fixes and the port keeps:

- ``grid_sample``: ``x`` NCHW, ``grid`` ``[N, Ho, Wo, 2]`` in ``[-1, 1]``
  (x then y); ``align_corners`` maps -1 and 1 to the corner pixels'
  centres, otherwise to their outer edges; ``nearest`` rounds half to
  even; ``zeros`` padding zeroes each tap outside the input, ``border``
  clamps the coordinate, ``reflection`` folds it (about the centres with
  ``align_corners``, about the edges otherwise, then clamps);
- ``ctc_loss`` takes raw logits ``[T, N, C]`` (log-softmaxed inside), runs
  the forward recursion in log space with -1e30 for an impossible state,
  and its ``mean`` divides each sequence's loss by its label length
  before averaging;
- ``rrelu`` draws its slopes from the device's generator in training,
  and ``sequence_mask`` reads the longest length on the host when
  ``maxlen`` is None (the output's shape depends on it).

Options the reference takes and ignores are refused here:
``ctc_loss(norm_by_times=True)`` and ``hsigmoid_loss``'s custom tree
(``path_table`` / ``path_code``) and ``is_sparse``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from ..._core import dtype as dtypes
from ..._core import random as rnd
from ..._core.dispatch import apply, unwrap
from ..._core.op_registry import register_op
from ..._core.tensor import Tensor
from .conv import _conv_transpose, _pair
from .loss import _reduce
from .pooling import avg_pool2d, _avg_pool_nd, _max_pool_nd, \
    _max_pool_nd_index

__all__ = [
    "grid_sample", "affine_grid", "fold", "pixel_shuffle",
    "pixel_unshuffle", "channel_shuffle", "temporal_shift",
    "sequence_mask", "maxout", "rrelu", "lp_pool2d", "avg_pool3d",
    "max_pool3d", "conv3d_transpose", "max_unpool2d", "huber_loss",
    "hinge_loss", "log_loss", "square_error_cost", "dice_loss",
    "npair_loss", "ctc_loss", "gaussian_nll_loss", "poisson_nll_loss",
    "triplet_margin_loss", "triplet_margin_with_distance_loss",
    "multi_label_soft_margin_loss", "soft_margin_loss",
    "adaptive_log_softmax_with_loss", "hsigmoid_loss", "pairwise_distance",
    "zeropad2d",
]


def _rewrap(x, t):
    """``t`` as a ``Tensor`` when ``x`` was one."""
    return Tensor(t) if isinstance(x, Tensor) else t


# -------------------------------------------------------------- sampling
def _reflect(p, lo, hi):
    """A triangle wave between lo and hi."""
    span = max(hi - lo, 1e-6)
    g = torch.remainder(p - lo, 2 * span)
    return lo + span - (g - span).abs()


@register_op("grid_sample_k")
def _grid_sample(x, grid, mode, padding_mode, align_corners):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * 0.5 * (w - 1)
        fy = (gy + 1) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1) * w - 1) * 0.5
        fy = ((gy + 1) * h - 1) * 0.5
    if padding_mode == "border":
        fx = torch.clamp(fx, 0, w - 1)
        fy = torch.clamp(fy, 0, h - 1)
    elif padding_mode == "reflection":
        if align_corners:
            fx = _reflect(fx, 0.0, w - 1.0)
            fy = _reflect(fy, 0.0, h - 1.0)
        else:
            fx = torch.clamp(_reflect(fx, -0.5, w - 0.5), 0, w - 1)
            fy = torch.clamp(_reflect(fy, -0.5, h - 0.5), 0, h - 1)
    xl = x.permute(0, 2, 3, 1)  # [N, H, W, C]
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        vals = xl[batch, torch.clamp(iy, 0, h - 1), torch.clamp(ix, 0, w - 1)]
        if padding_mode == "zeros":
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            vals = torch.where(inside[..., None], vals, vals.new_zeros(()))
        return vals

    if mode == "nearest":
        out = sample(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        wx = (fx - x0)[..., None]
        wy = (fy - y0)[..., None]
        out = (sample(x0, y0) * (1 - wx) * (1 - wy)
               + sample(x0 + 1, y0) * wx * (1 - wy)
               + sample(x0, y0 + 1) * (1 - wx) * wy
               + sample(x0 + 1, y0 + 1) * wx * wy)
    return out.permute(0, 3, 1, 2)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return apply("grid_sample_k", _grid_sample, x, grid, mode=mode,
                 padding_mode=padding_mode,
                 align_corners=bool(align_corners))


@register_op("affine_grid_k")
def _affine_grid(theta, oshape, align_corners):
    _, _, h, w = oshape

    def coords(size):
        f64 = dict(dtype=torch.float64, device=theta.device)
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, **f64)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, **f64)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    # the reference's linspace is float64 (x64 on), and so is its grid
    return torch.einsum("hwk,nck->nhwc", base, theta.double())


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The sampling grid ``[N, H, W, 2]`` of the affine maps ``theta``
    ``[N, 2, 3]`` over a 4-D ``out_shape``."""
    if isinstance(out_shape, Tensor):
        out_shape = out_shape.tolist()
    return apply("affine_grid_k", _affine_grid, theta,
                 oshape=tuple(int(v) for v in out_shape),
                 align_corners=bool(align_corners))


# ------------------------------------------------------ shuffles / shifts
def _require_nchw(data_format, what):
    if not data_format.startswith("NC"):
        raise ValueError(f"{what}: only NCHW data_format is implemented, "
                         f"got '{data_format}'")


@register_op("pixel_shuffle_k")
def _pixel_shuffle(x, r):
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


@register_op("pixel_unshuffle_k")
def _pixel_unshuffle(x, r):
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


@register_op("channel_shuffle_k")
def _channel_shuffle(x, g):
    n, c, h, w = x.shape
    return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    _require_nchw(data_format, "pixel_shuffle")
    return apply("pixel_shuffle_k", _pixel_shuffle, x, r=int(upscale_factor))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    _require_nchw(data_format, "pixel_unshuffle")
    return apply("pixel_unshuffle_k", _pixel_unshuffle, x,
                 r=int(downscale_factor))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    _require_nchw(data_format, "channel_shuffle")
    return apply("channel_shuffle_k", _channel_shuffle, x, g=int(groups))


@register_op("temporal_shift_k")
def _temporal_shift(x, seg_num, shift_ratio):
    nt, c, h, w = x.shape
    x = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold_ = int(c * shift_ratio)
    left = torch.cat([x[:, 1:, :fold_],
                      torch.zeros_like(x[:, :1, :fold_])], 1)
    right = torch.cat([torch.zeros_like(x[:, :1, fold_:2 * fold_]),
                       x[:, :-1, fold_:2 * fold_]], 1)
    return torch.cat([left, right, x[:, :, 2 * fold_:]], 2).reshape(
        nt, c, h, w)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """The first ``c * shift_ratio`` channels one segment back, the next
    as many one forward, zeros shifted in."""
    _require_nchw(data_format, "temporal_shift")
    return apply("temporal_shift_k", _temporal_shift, x,
                 seg_num=int(seg_num), shift_ratio=float(shift_ratio))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` over ``maxlen`` (the longest length,
    read on the host, when None); no gradient."""
    lens = unwrap(x)
    m = int(maxlen) if maxlen is not None else int(lens.max())
    mask = torch.arange(m, device=lens.device) < lens.unsqueeze(-1)
    return _rewrap(x, mask.to(dtypes.to_torch(dtype)))


# -------------------------------------------------- activations / pooling
@register_op("maxout_k")
def _maxout(x, groups, axis):
    axis = axis % x.dim()
    shape = list(x.shape)
    new = shape[:axis] + [shape[axis] // groups, groups] + shape[axis + 1:]
    return x.reshape(new).amax(axis + 1)


def maxout(x, groups, axis=1, name=None):
    return apply("maxout_k", _maxout, x, groups=int(groups), axis=int(axis))


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """``x`` where >= 0, ``a x`` elsewhere: ``a`` uniform in [lower,
    upper) per element in training, their mean otherwise."""
    t = unwrap(x)
    if training:
        a = torch.empty(t.shape, device=t.device).uniform_(
            lower, upper, generator=rnd.generator(t.device)).to(t.dtype)
    else:
        a = (lower + upper) / 2.0
    return _rewrap(x, torch.where(t >= 0, t, a * t))


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """``(sum over the window of x^p)^(1/p)``."""
    p = float(norm_type)
    pooled = avg_pool2d(x ** p, kernel_size, stride=stride, padding=padding,
                        ceil_mode=ceil_mode, data_format=data_format)
    ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
        else (kernel_size, kernel_size)
    return (pooled * (ks[0] * ks[1])) ** (1.0 / p)


def _triple(v):
    return _pair(v, 3)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    ksize = _triple(kernel_size)
    stride = _triple(stride if stride is not None else kernel_size)
    return apply("avg_pool_nd", _avg_pool_nd, x, ksize=ksize, stride=stride,
                 padding=tuple((p, p) for p in _triple(padding)),
                 ceil_mode=bool(ceil_mode), fmt=data_format,
                 exclusive=bool(exclusive), divisor=divisor_override)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    ksize = _triple(kernel_size)
    stride = _triple(stride if stride is not None else kernel_size)
    op = "max_pool_nd_index" if return_mask else "max_pool_nd"
    body = _max_pool_nd_index if return_mask else _max_pool_nd
    return apply(op, body, x, ksize=ksize, stride=stride,
                 padding=tuple((p, p) for p in _triple(padding)),
                 ceil_mode=bool(ceil_mode), fmt=data_format,
                 with_index=bool(return_mask))


@register_op("conv3d_transpose_k")
def _conv3d_transpose(x, w, b, stride, padding, output_padding, dilation,
                      groups):
    return _conv_transpose(x, w, b, stride, padding, output_padding,
                           dilation, groups, 3, "NCDHW")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    """Transposed 3-D convolution, weight ``[in, out / groups, kd, kh,
    kw]``; ``output_size`` picks the output padding that reaches it."""
    _require_nchw(data_format, "conv3d_transpose")
    s, d, p = _triple(stride), _triple(dilation), _triple(padding)
    op_ = _triple(output_padding)
    if output_size is not None:
        spatial = list(output_size)[-3:]
        op_ = []
        for i in range(3):
            k = (weight.shape[2 + i] - 1) * d[i] + 1
            default = (x.shape[2 + i] - 1) * s[i] - 2 * p[i] + k
            extra = int(spatial[i]) - default
            if not 0 <= extra < s[i]:
                raise ValueError(
                    f"conv3d_transpose: output_size[{i}]={spatial[i]} "
                    f"unreachable (default {default}, stride {s[i]})")
            op_.append(extra)
        op_ = tuple(op_)
    return apply("conv3d_transpose_k", _conv3d_transpose, x, weight, bias,
                 stride=s, padding=tuple((q, q) for q in p),
                 output_padding=op_, dilation=d, groups=int(groups))


@register_op("max_unpool2d_k")
def _max_unpool2d(x, indices, oh, ow):
    n, c = x.shape[0], x.shape[1]
    out = x.new_zeros(n, c, oh * ow).scatter(
        2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return out.reshape(n, c, oh, ow)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """The inverse of ``max_pool2d(return_mask=True)``: each value back at
    its argmax, zeros elsewhere."""
    _require_nchw(data_format, "max_unpool2d")
    ks = kernel_size if isinstance(kernel_size, (list, tuple)) else \
        (kernel_size, kernel_size)
    st = stride if stride is not None else ks
    st = st if isinstance(st, (list, tuple)) else (st, st)
    pad = padding if isinstance(padding, (list, tuple)) \
        else (padding, padding)
    h, w = x.shape[2], x.shape[3]
    oh = (h - 1) * st[0] - 2 * pad[0] + ks[0]
    ow = (w - 1) * st[1] - 2 * pad[1] + ks[1]
    if output_size is not None:
        oh, ow = output_size[-2], output_size[-1]
    return apply("max_unpool2d_k", _max_unpool2d, x, indices, oh=int(oh),
                 ow=int(ow))


# ------------------------------------------------------------------ fold
@register_op("fold_k")
def _fold(x, oshape, ksizes, strides, pads, dilations):
    return tF.fold(x, tuple(oshape), tuple(ksizes), dilation=tuple(dilations),
                   padding=tuple(pads), stride=tuple(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1, name=None):
    """col2im, the inverse of ``unfold``: ``[N, C kh kw, L]`` to ``[N, C,
    H, W]``, overlapping cells summed."""
    return apply("fold_k", _fold, x, oshape=_pair(output_sizes),
                 ksizes=_pair(kernel_sizes), strides=_pair(strides),
                 pads=_pair(paddings), dilations=_pair(dilations))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    from .common import pad
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# ---------------------------------------------------------------- losses
@register_op("huber_loss_k")
def _huber(x, y, delta, reduction):
    d = (x - y).abs()
    return _reduce(torch.where(d <= delta, 0.5 * (x - y) ** 2,
                               delta * (d - 0.5 * delta)), reduction)


@register_op("hinge_loss_k")
def _hinge(logit, label):
    return torch.clamp(1.0 - (2.0 * label - 1.0) * logit, min=0.0)


@register_op("log_loss_k")
def _log_loss(input, label, epsilon):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


@register_op("square_error_cost_k")
def _square_error(input, label):
    return (input - label) ** 2


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    return apply("huber_loss_k", _huber, input, label, delta=float(delta),
                 reduction=reduction)


def hinge_loss(input, label, name=None):
    return apply("hinge_loss_k", _hinge, input, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply("log_loss_k", _log_loss, input, label,
                 epsilon=float(epsilon))


def square_error_cost(input, label):
    return apply("square_error_cost_k", _square_error, input, label)


@register_op("dice_loss_k")
def _dice(input, label, epsilon):
    dims = tuple(range(1, input.dim()))
    inse = (input * label).sum(dims)
    denom = input.sum(dims) + label.sum(dims)
    return (1.0 - 2.0 * inse / (denom + epsilon)).mean()


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - 2 |x y| / (|x| + |y| + epsilon))`` per sample; integer
    labels are class ids, one-hot over the input's last axis."""
    lbl = unwrap(label)
    inp = unwrap(input)
    if not (lbl.is_floating_point() or lbl.is_complex()):
        if lbl.dim() and lbl.shape[-1] == 1:
            lbl = lbl.squeeze(-1)
        lbl = tF.one_hot(lbl.long(), inp.shape[-1]).to(inp.dtype)
    lbl = lbl.expand(inp.shape)
    return apply("dice_loss_k", _dice, input, _rewrap(input, lbl),
                 epsilon=float(epsilon))


@register_op("npair_loss_k")
def _npair(a, p, lbl, l2_reg):
    sim = a @ p.T
    lbl = lbl.reshape(-1)
    same = (lbl[:, None] == lbl[None, :]).to(a.dtype)
    same = same / same.sum(1, keepdim=True)
    xent = -(same * torch.log_softmax(sim, 1)).sum(1)
    reg = 0.25 * l2_reg * ((a * a).sum() + (p * p).sum()) / a.shape[0]
    return xent.mean() + reg


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    return apply("npair_loss_k", _npair, anchor, positive, labels,
                 l2_reg=float(l2_reg))


@register_op("pairwise_distance_k")
def _pairwise_distance(x, y, p, epsilon, keepdim):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` over the last axis."""
    return apply("pairwise_distance_k", _pairwise_distance, x, y, p=float(p),
                 epsilon=float(epsilon), keepdim=bool(keepdim))


@register_op("soft_margin_loss_k")
def _soft_margin(x, y, reduction):
    return _reduce(torch.log1p(torch.exp(-y * x)), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply("soft_margin_loss_k", _soft_margin, input, label,
                 reduction=reduction)


@register_op("multi_label_soft_margin_loss_k")
def _mlsm(x, y, w, reduction):
    loss = -(y * tF.logsigmoid(x) + (1 - y) * tF.logsigmoid(-x)).mean(-1)
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    return apply("multi_label_soft_margin_loss_k", _mlsm, input, label,
                 weight, reduction=reduction)


@register_op("triplet_margin_loss_k")
def _triplet(x, pos_, neg, margin, p, epsilon, swap, reduction):
    def dist(a, b):
        return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1)
    dp, dn = dist(x, pos_), dist(x, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos_, neg))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    return apply("triplet_margin_loss_k", _triplet, input, positive,
                 negative, margin=float(margin), p=float(p),
                 epsilon=float(epsilon), swap=bool(swap), reduction=reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet loss over ``distance_function`` (the p=2 distance when
    None)."""
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    from ...ops.math import maximum, minimum
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = minimum(dn, distance_function(positive, negative))
    return _reduce(maximum(dp - dn + margin, dp * 0.0), reduction)


@register_op("gaussian_nll_loss_k")
def _gaussian_nll(x, y, var, full, epsilon, reduction):
    var = torch.clamp(var, min=epsilon)
    loss = 0.5 * (torch.log(var) + (x - y) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    return apply("gaussian_nll_loss_k", _gaussian_nll, input, label,
                 variance, full=bool(full), epsilon=float(epsilon),
                 reduction=reduction)


@register_op("poisson_nll_loss_k")
def _poisson_nll(x, y, log_input, full, epsilon, reduction):
    loss = torch.exp(x) - y * x if log_input \
        else x - y * torch.log(x + epsilon)
    if full:
        stirling = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
        loss = loss + torch.where(y > 1, stirling, torch.zeros_like(y))
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    return apply("poisson_nll_loss_k", _poisson_nll, input, label,
                 log_input=bool(log_input), full=bool(full),
                 epsilon=float(epsilon), reduction=reduction)


def _lae(a, b):
    """log(exp(a) + exp(b)) as the reference writes it (-1e30 + log 2
    for two impossible states)."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


@register_op("ctc_loss_k")
def _ctc_loss(log_probs, labels, input_lengths, label_lengths, blank,
              reduction):
    lp = torch.log_softmax(log_probs, -1)
    t_len, n, _ = lp.shape
    s = labels.shape[1]
    lbl = labels.long()
    ext = torch.full((n, 2 * s + 1), blank, dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = lbl
    neg = torch.full((), -1e30, dtype=lp.dtype, device=lp.device)
    col = torch.arange(2 * s + 1, device=lp.device)
    first = lp[0, :, blank][:, None]
    second = torch.gather(lp[0], 1, ext[:, 1:2]) if s > 0 else neg
    alpha = torch.where(col == 0, first, torch.where(col == 1, second, neg))
    repeat = torch.cat([torch.ones(n, 2, dtype=torch.bool, device=lp.device),
                        ext[:, 2:] == ext[:, :-2]], 1)
    lens = input_lengths.long()[:, None]
    for t in range(1, t_len):
        shift1 = torch.cat([neg.expand(n, 1), alpha[:, :-1]], 1)
        shift2 = torch.cat([neg.expand(n, 2), alpha[:, :-2]], 1)
        shift2 = torch.where(repeat, neg, shift2)
        new = _lae(_lae(alpha, shift1), shift2) + torch.gather(lp[t], 1, ext)
        alpha = torch.where(t < lens, new, alpha)
    last = (2 * label_lengths.long())[:, None]
    ll = _lae(torch.gather(alpha, 1, last)[:, 0],
              torch.gather(alpha, 1, torch.clamp(last - 1, min=0))[:, 0])
    loss = -ll
    if reduction == "mean":
        return (loss / label_lengths.to(lp.dtype)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss of raw logits ``log_probs`` ``[T, N, C]`` (log-softmaxed
    inside) against ``labels`` ``[N, S]``; ``mean`` divides each loss by
    its label length, then averages. ``norm_by_times`` (which the
    reference takes and ignores) is refused."""
    if norm_by_times:
        raise NotImplementedError(
            "ctc_loss: norm_by_times is not computed by the reference")
    return apply("ctc_loss_k", _ctc_loss, log_probs, labels, input_lengths,
                 label_lengths, blank=int(blank), reduction=reduction)


@register_op("hsigmoid_loss_k")
def _hsigmoid(x, lbl_in, w, bias, num_classes):
    lbl = lbl_in.reshape(-1).long()
    code_len = int(np.ceil(np.log2(max(num_classes, 2)))) + 1
    # the default tree: leaves num_classes .. 2 num_classes - 1, internal
    # nodes 1 .. num_classes - 1; a term counts until the walk passes the
    # root
    loss = x.new_zeros(x.shape[0])
    cur = lbl + num_classes
    for _ in range(code_len):
        valid = (cur >= 2).to(x.dtype)
        code = (cur % 2).to(x.dtype)
        parent = cur // 2
        node = torch.clamp(parent - 1, min=0)
        logit = (x * w[node]).sum(-1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[node]
        term = -(code * tF.logsigmoid(logit)
                 + (1 - code) * tF.logsigmoid(-logit))
        loss = loss + valid * term
        cur = parent
    return loss.reshape(-1, 1)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The hierarchical sigmoid loss over the default complete binary
    tree of ``num_classes`` leaves, per sample ``[N, 1]``."""
    if path_table is not None or path_code is not None or is_sparse:
        raise NotImplementedError(
            "hsigmoid_loss: a custom tree (path_table / path_code) and "
            "is_sparse are not computed by the reference")
    return apply("hsigmoid_loss_k", _hsigmoid, input, label, weight, bias,
                 num_classes=int(num_classes))


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Refused, as in the reference."""
    raise NotImplementedError(
        "adaptive_log_softmax_with_loss: use nn.AdaptiveLogSoftmaxWithLoss")
