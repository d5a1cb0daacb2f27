"""Activations: the counterpart of
``paddle_tpu/nn/functional/activation.py`` (its op names, so that AMP's
lists apply as there: ``log_softmax`` and ``softmax`` are on the black
list, the rest on neither). The one-input activations are registered ops
(``def_unary``) and ``Tensor`` methods, as the reference's are; the rest
are registered bodies called through the dispatch by name.

``gumbel_softmax`` draws its noise from the device's generator
(``_core/random.py``), as ``dropout`` does: the same law as the
reference's ``jax.random.gumbel``, not the same numbers."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..._core import random as rnd
from ..._core.dispatch import apply
from ..._core.op_registry import register_op
from ..._core.tensor import Tensor
from ...ops._helper import def_unary
from ...ops.manipulation import cast, reshape


@register_op("gelu")
def _gelu(x, approximate):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return apply("gelu", _gelu, x, approximate=bool(approximate))


relu = def_unary("relu", torch.relu)
relu6 = def_unary("relu6", lambda t: torch.clamp(t, 0.0, 6.0))
sigmoid = def_unary("sigmoid_f", torch.sigmoid)
tanh_ = def_unary("tanh_f", torch.tanh)
silu = def_unary("silu", tF.silu)
swish = silu
softsign = def_unary("softsign", tF.softsign)
tanhshrink = def_unary("tanhshrink", lambda t: t - torch.tanh(t))


def tanh(x, name=None):
    return tanh_(x)


@register_op("leaky_relu")
def _leaky_relu(x, negative_slope):
    return tF.leaky_relu(x, negative_slope)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply("leaky_relu", _leaky_relu, x,
                 negative_slope=float(negative_slope))


@register_op("elu")
def _elu(x, alpha):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def elu(x, alpha=1.0, name=None):
    return apply("elu", _elu, x, alpha=float(alpha))


@register_op("celu")
def _celu(x, alpha):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def celu(x, alpha=1.0, name=None):
    return apply("celu", _celu, x, alpha=float(alpha))


@register_op("selu")
def _selu(x, scale, alpha):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply("selu", _selu, x, scale=float(scale), alpha=float(alpha))


@register_op("hardtanh")
def _hardtanh(x, mn, mx):
    return torch.clamp(x, mn, mx)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply("hardtanh", _hardtanh, x, mn=float(min), mx=float(max))


def _like(x, v):
    """``v`` in x's type, as the reference's weakly typed scalars are: a
    Python float beside a bf16 tensor rounds to bf16 first (torch's CUDA
    kernels would compute with the float itself)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


@register_op("hardshrink")
def _hardshrink(x, threshold):
    return torch.where(x.abs() > _like(x, threshold), x, x.new_zeros(()))


def hardshrink(x, threshold=0.5, name=None):
    return apply("hardshrink", _hardshrink, x, threshold=float(threshold))


@register_op("softshrink")
def _softshrink(x, threshold):
    t = _like(x, threshold)
    return torch.where(x > t, x - t, torch.where(x < -t, x + t,
                                                 x.new_zeros(())))


def softshrink(x, threshold=0.5, name=None):
    return apply("softshrink", _softshrink, x, threshold=float(threshold))


@register_op("thresholded_relu")
def _thresholded_relu(x, threshold, value):
    return torch.where(x > _like(x, threshold), x, _like(x, value))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply("thresholded_relu", _thresholded_relu, x,
                 threshold=float(threshold), value=float(value))


hardswish = def_unary("hardswish", tF.hardswish)
hardsigmoid = def_unary("hardsigmoid",
                        lambda t: torch.clamp(t / 6.0 + 0.5, 0.0, 1.0))


@register_op("softplus")
def _softplus(x, beta, threshold):
    # the reference's form: log(1 + exp(beta x)) / beta as logaddexp
    bx = x * beta
    return torch.where(bx > threshold, x,
                       torch.logaddexp(bx, bx.new_zeros(())) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply("softplus", _softplus, x, beta=float(beta),
                 threshold=float(threshold))


mish = def_unary("mish", tF.mish)


@register_op("softmax")
def _softmax(x, axis):
    return torch.softmax(x, axis)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    return apply("softmax", _softmax, x, axis=int(axis))


@register_op("log_softmax")
def _log_softmax(x, axis):
    return torch.log_softmax(x, axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = cast(x, dtype)
    return apply("log_softmax", _log_softmax, x, axis=int(axis))


@register_op("prelu_k")
def _prelu(x, w):
    return torch.where(x >= 0, x, w * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where it is >= 0, ``weight * x`` elsewhere; a weight of more
    than one element is per channel (axis 1 for NC.., the last axis
    otherwise)."""
    w = weight
    n = w.size if isinstance(w, Tensor) else w.numel()
    if n > 1:
        ndim = x.ndim if isinstance(x, Tensor) else x.dim()
        shape = [1, n] + [1] * (ndim - 2) if data_format.startswith("NC") \
            else [1] * (ndim - 1) + [n]
        w = reshape(w, shape)
    return apply("prelu_k", _prelu, x, w)


@register_op("glu_k")
def _glu(x, axis):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def glu(x, axis=-1, name=None):
    return apply("glu_k", _glu, x, axis=int(axis))


@register_op("log_sigmoid")
def _log_sigmoid(x):
    return tF.logsigmoid(x)


def log_sigmoid(x, name=None):
    return apply("log_sigmoid", _log_sigmoid, x)


def silu_(x):
    """The reference's ``silu_``: ``silu`` (not in place)."""
    return silu(x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise g drawn from
    the device's generator; ``hard`` returns the one-hot of the argmax
    with the soft gradient (straight through)."""
    t = x._t if isinstance(x, Tensor) else x
    e = torch.empty(t.shape, dtype=t.dtype, device=t.device).exponential_(
        generator=rnd.generator(t.device))
    g = Tensor(-torch.log(e)) if isinstance(x, Tensor) else -torch.log(e)
    y = softmax((x + g) / temperature, axis=axis)
    if hard:
        yt = y._t if isinstance(y, Tensor) else y
        idx = yt.argmax(dim=axis, keepdim=True)
        hard_y = torch.zeros_like(yt).scatter_(axis, idx, 1.0)
        out = (hard_y - yt).detach() + yt
        return Tensor(out) if isinstance(y, Tensor) else out
    return y
