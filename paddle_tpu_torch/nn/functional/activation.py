"""Activations: the counterpart of
``paddle_tpu/nn/functional/activation.py`` (its op names)."""
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


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    return apply("softmax", lambda t: torch.softmax(t, int(axis)), x)
