"""Activations: the counterpart of
``paddle_tpu/nn/functional/activation.py`` (its op names, so that AMP's
lists apply as there: ``log_softmax`` and ``softmax`` are on the black
list, the rest on neither). The one-input activations are registered ops
(``def_unary``) and ``Tensor`` methods, as the reference's are."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..._core.dispatch import apply
from ..._core.op_registry import register_op
from ...ops._helper import def_unary
from ...ops.manipulation import cast


@register_op("gelu")
def _gelu(x, approximate):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return apply("gelu", _gelu, x, approximate=bool(approximate))


relu = def_unary("relu", torch.relu)
relu6 = def_unary("relu6", lambda t: torch.clamp(t, 0.0, 6.0))
sigmoid = def_unary("sigmoid_f", torch.sigmoid)
_tanh = def_unary("tanh_f", torch.tanh)
silu = def_unary("silu", tF.silu)
swish = silu
softsign = def_unary("softsign", tF.softsign)
tanhshrink = def_unary("tanhshrink", lambda t: t - torch.tanh(t))


def tanh(x, name=None):
    return _tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply("leaky_relu", tF.leaky_relu, x,
                 negative_slope=float(negative_slope))


def elu(x, alpha=1.0, name=None):
    return apply("elu", tF.elu, x, alpha=float(alpha))


hardswish = def_unary("hardswish", tF.hardswish)
hardsigmoid = def_unary("hardsigmoid",
                        lambda t: torch.clamp(t / 6.0 + 0.5, 0.0, 1.0))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply("softplus", tF.softplus, x, beta=float(beta),
                 threshold=float(threshold))


mish = def_unary("mish", tF.mish)


@register_op("softmax")
def _softmax(x, axis):
    return torch.softmax(x, axis)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    return apply("softmax", _softmax, x, axis=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    return apply("log_softmax", lambda t: torch.log_softmax(t, int(axis)),
                 x)
