"""Weight initializers: the counterpart of ``paddle_tpu/nn/initializer.py``.

Each initializer returns a ``torch.Tensor`` of the given shape and type on
the current device, drawn in float32 from that device's generator
(``_core/random.py``) and then cast. The distributions are the
reference's; the numbers are not (``jax.random`` against torch's
generators), so tests carry weights across through numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._core import dtype as dtypes
from .._core import random as rnd
from .._core.device import default_device


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))  # conv [out, in, kh, kw]
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype="float32") -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _draw(kind, shape, dtype, a, b) -> torch.Tensor:
        """``kind`` ("normal_": mean a, std b; "uniform_": [a, b))."""
        dev = default_device()
        out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        getattr(out, kind)(a, b, generator=rnd.generator(dev))
        return out.to(dtypes.to_torch(dtype))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.to_torch(dtype),
                          device=default_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        return self._draw("normal_", shape, dtype, self.mean, self.std)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return self._draw("normal_", shape, dtype, 0.0, std)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._draw("uniform_", shape, dtype, -limit, limit)


class KaimingNormal(Initializer):
    """Normal with std ``gain / sqrt(fan_in)``, gain sqrt(2) for ReLU."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi = self._fan_in if self._fan_in is not None \
            else _fan_in_out(shape)[0]
        gain = math.sqrt(2.0) if self.nonlinearity == "relu" else \
            math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return self._draw("normal_", shape, dtype, 0.0, gain / math.sqrt(fi))
