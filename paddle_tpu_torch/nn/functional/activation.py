"""Activations: the counterpart of
``paddle_tpu/nn/functional/activation.py`` (its op names, so that AMP's
lists apply as there: ``log_softmax`` and ``softmax`` are on the black
list, the rest on neither)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..._core.dispatch import apply
from ...ops.manipulation import cast


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return apply("gelu", lambda t: tF.gelu(t, approximate=mode), x)


def relu(x, name=None):
    return apply("relu", torch.relu, x)


def relu6(x, name=None):
    return apply("relu6", lambda t: torch.clamp(t, 0.0, 6.0), x)


def sigmoid(x, name=None):
    return apply("sigmoid_f", torch.sigmoid, x)


def tanh(x, name=None):
    return apply("tanh_f", torch.tanh, x)


def silu(x, name=None):
    return apply("silu", tF.silu, x)


swish = silu


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply("leaky_relu", tF.leaky_relu, x,
                 negative_slope=float(negative_slope))


def elu(x, alpha=1.0, name=None):
    return apply("elu", tF.elu, x, alpha=float(alpha))


def hardswish(x, name=None):
    return apply("hardswish", tF.hardswish, x)


def hardsigmoid(x, name=None):
    return apply("hardsigmoid",
                 lambda t: torch.clamp(t / 6.0 + 0.5, 0.0, 1.0), x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply("softplus", tF.softplus, x, beta=float(beta),
                 threshold=float(threshold))


def mish(x, name=None):
    return apply("mish", tF.mish, x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    return apply("softmax", lambda t: torch.softmax(t, int(axis)), x)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    return apply("log_softmax", lambda t: torch.log_softmax(t, int(axis)),
                 x)
