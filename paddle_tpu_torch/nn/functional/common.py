"""``linear`` and ``dropout``: the counterpart of
``paddle_tpu/nn/functional/common.py``."""
from __future__ import annotations

import torch

from ..._core import random as rnd
from ..._core.dispatch import apply
from ..._core.op_registry import register_op
from ...ops.linalg import promote


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
