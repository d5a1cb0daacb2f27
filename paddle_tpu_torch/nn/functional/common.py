"""``linear``, the dropouts, ``interpolate`` and the other common
functionals: the counterpart of ``paddle_tpu/nn/functional/common.py``.
The dropouts draw their masks from the device's generator
(``_core/random.py``): the reference's law, not its numbers."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..._core import random as rnd
from ..._core.dispatch import apply, unwrap
from ..._core.op_registry import register_op
from ..._core.tensor import Tensor
from ...ops.creation import full_like
from ...ops.linalg import promote
from ...ops.manipulation import pad  # noqa: F401  (re-export)
from ...ops.search import where
from .conv import _pair


@register_op("linear")
def _linear(x, w, b):
    x, w = promote(x, w)
    out = torch.matmul(x, w)  # weight [in, out], as paddle lays it out
    return out if b is None else out + b


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias``; the product rounds to the io type before the
    bias is added, as the reference's ``matmul`` then ``+`` does."""
    return apply("linear", _linear, x, weight, bias)


@register_op("dropout_k")
def _dropout(x, p, axis, mode):
    shape = list(x.shape)
    if axis is not None:  # the mask broadcasts along the other axes
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in [a % x.dim() for a in axes] else 1
                 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=rnd.generator(x.device),
                      device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, x.new_zeros(()))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zeroes each element with probability ``p``, the mask drawn from the
    device's generator (``_core/random.py``)."""
    if p == 0.0:
        return x
    if not training:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    return apply("dropout_k", _dropout, x, p=float(p), axis=axis, mode=mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Zeroes whole channels (one draw per sample and channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: a dropped element takes ``-alpha * scale``, then
    ``a * y + b`` keeps the mean and the variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    t = unwrap(x)
    keep = torch.rand(t.shape, generator=rnd.generator(t.device),
                      device=t.device) < 1.0 - p
    y = where(Tensor(keep) if isinstance(x, Tensor) else keep, x,
              full_like(x, alpha_p))
    return y * a + b


@register_op("normalize_k")
def _normalize(x, p, axis, eps):
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=eps)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    return apply("normalize_k", _normalize, x, p=p, axis=int(axis),
                 eps=float(epsilon))


@register_op("cosine_similarity_k")
def _cosine_similarity(x, y, axis, eps):
    xn = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    yn = torch.linalg.vector_norm(y, dim=axis, keepdim=True)
    return (x * y).sum(axis) / torch.clamp(xn * yn, min=eps).squeeze(axis)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return apply("cosine_similarity_k", _cosine_similarity, x1, x2,
                 axis=int(axis), eps=float(eps))


# ------------------------------------------------------------ interpolate
#
# The reference resizes with jax.image.resize unless align_corners:
# half-pixel sampling (src = (i + 0.5) in / out - 0.5), a triangle
# ("bilinear", "area") or Keys cubic kernel with a = -0.5 ("bicubic"),
# widened by in / out when downsampling (antialiasing), the taps that
# fall outside the input dropped and the rest renormalised; "nearest" is
# src = floor((i + 0.5) in / out) in float32. With align_corners it
# samples src = i (in - 1) / (out - 1) itself: linear taps, or Keys cubic
# taps with a = -0.75 clamped to the edge. Here each axis is one weight
# matrix built by those formulas (in float32, as there), applied as a
# contraction.


def _triangle(d):
    return torch.clamp(1 - d.abs(), min=0)


def _keys(d, a):
    near = ((a + 2) * d - (a + 3)) * d * d + 1
    far = a * (((d - 5) * d + 8) * d - 4)
    return torch.where(d >= 2, torch.zeros_like(d),
                       torch.where(d >= 1, far, near))


def _half_pixel_weights(n_in, n_out, cubic, device):
    """jax.image.compute_weight_mat: [n_in, n_out]."""
    f32 = torch.float32
    inv = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * inv - 0.5
    d = (sample[None, :] - torch.arange(n_in, dtype=f32,
                                        device=device)[:, None]).abs() \
        / max(inv, 1.0)
    w = _keys(d, -0.5) if cubic else _triangle(d)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920928955078125e-07,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _align_corners_weights(n_in, n_out, cubic, device):
    """The reference's _lin_1d_align / _cubic_1d_align as [n_in, n_out]."""
    w = torch.zeros(n_in, n_out, dtype=torch.float32, device=device)
    cols = torch.arange(n_out, device=device)
    if n_out == 1 or n_in == 1:
        w[0] = 1.0
        return w
    pos = torch.linspace(0.0, n_in - 1.0, n_out, dtype=torch.float32,
                         device=device)
    base = torch.floor(pos)
    f = pos - base
    base = base.long()
    if cubic:
        taps = ((-1, _keys(1 + f, -0.75)), (0, _keys(f, -0.75)),
                (1, _keys(1 - f, -0.75)), (2, _keys(2 - f, -0.75)))
    else:
        taps = ((0, 1 - f), (1, f))
    for off, tw in taps:
        rows = torch.clamp(base + off, 0, n_in - 1)
        w.index_put_((rows, cols), tw, accumulate=True)
    return w


def _nearest_index(n_in, n_out, device):
    off = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(off).long()


@register_op("interpolate_k")
def _interpolate(x, size, mode, align_corners, data_format):
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    _, h, w, _ = x.shape
    oh, ow = size
    if mode == "nearest":
        out = x[:, _nearest_index(h, oh, x.device)] if oh != h else x
        out = out[:, :, _nearest_index(w, ow, x.device)] if ow != w \
            else out
    else:
        cubic = mode == "bicubic"
        make = _align_corners_weights if align_corners \
            else _half_pixel_weights
        out = x
        if oh != h or align_corners:
            out = torch.einsum("nhwc,ho->nowc", out,
                               make(h, oh, cubic, x.device).to(x.dtype))
        if ow != w or align_corners:
            out = torch.einsum("nhwc,wo->nhoc", out,
                               make(w, ow, cubic, x.device).to(x.dtype))
    return out.permute(0, 3, 1, 2) if data_format == "NCHW" else out


_INTERP_MODES = ("nearest", "bilinear", "bicubic", "area")


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resizes the two spatial axes of a 4-D ``x`` (NCHW or NHWC) by the
    reference's rules (above). The reference computes ``align_mode=0``
    only (half-pixel sampling) and resizes 4-D inputs only: the port
    refuses the rest rather than compute something else."""
    mode = mode.lower()
    if align_corners and mode in ("nearest", "area"):
        raise ValueError(
            f"align_corners=True is incompatible with mode='{mode}'")
    if mode not in _INTERP_MODES and not (
            align_corners and mode in ("linear", "trilinear")):
        raise ValueError(f"interpolate: mode '{mode}' is not supported")
    if align_mode != 0 and not align_corners and mode != "nearest":
        raise NotImplementedError(
            "interpolate: align_mode=1 (src = i * in / out) is not "
            "computed by the reference, which samples half-pixel")
    if len(x.shape) != 4:
        raise ValueError(f"interpolate: a 4-D input is supported, got "
                         f"{len(x.shape)}-D")
    if size is None:
        h, w = (x.shape[2], x.shape[3]) if data_format == "NCHW" \
            else (x.shape[1], x.shape[2])
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor, scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    if isinstance(size, Tensor):
        size = size.tolist()
    return apply("interpolate_k", _interpolate, x,
                 size=tuple(int(s) for s in size), mode=mode,
                 align_corners=bool(align_corners), data_format=data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``label (1 - epsilon) + epsilon / k`` (k the last axis), or
    ``+ epsilon * prior_dist``."""
    if prior_dist is not None:
        return label * (1 - epsilon) + epsilon * prior_dist
    return label * (1 - epsilon) + epsilon / label.shape[-1]


@register_op("bilinear_k")
def _bilinear(x1, x2, w, b):
    out = torch.einsum("bi,oij,bj->bo", x1, w, x2)
    return out if b is None else out + b


def bilinear(x1, x2, weight, bias=None, name=None):
    """``x1^T W_o x2 + b_o`` for each output o; weight ``[out, in1,
    in2]``."""
    return apply("bilinear_k", _bilinear, x1, x2, weight, bias)


@register_op("unfold_k")
def _unfold(x, ks, st, pd, dl):
    return tF.unfold(x, tuple(ks), dilation=tuple(dl), padding=tuple(pd),
                     stride=tuple(st))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` to ``[N, C kh kw, L]``, channel first."""
    return apply("unfold_k", _unfold, x, ks=_pair(kernel_sizes),
                 st=_pair(strides), pd=_pair(paddings), dl=_pair(dilations))
