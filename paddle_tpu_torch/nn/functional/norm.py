"""Normalisation functionals in plain PyTorch.

Counterpart of ``layer_norm`` and ``rms_norm`` in
``paddle_tpu/nn/functional/norm.py`` (``_ln_kernel``, ``_rms_norm_kernel``),
which are plain jnp in the reference. Each rounds where its reference does:

- ``layer_norm`` works in x's own type throughout;
- ``rms_norm`` takes fp32 statistics, rounds ``x / sqrt(var + eps)`` to x's
  type, then multiplies by the weight and adds the bias in that type.

The RMSNorm kernel (``ops/cuda/fused.py`` ``rms_norm``, the reference's
``ops.pallas.rms_norm``) rounds once, after the weight, and LLaMA's own
``_rms`` (``models/llama.py``) rounds before the weight: three RMSNorms,
kept apart as the reference keeps them. Both go through the dispatch
under the reference's op names (``layer_norm``, ``rms_norm``: AMP's black
list), so they take the eager API's ``Tensor``s as well as torch tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..._core.dispatch import apply


def layer_norm(x, normalized_shape: Union[int, Sequence[int]], weight=None,
               bias=None, epsilon: float = 1e-05, name=None):
    """Normalises the trailing ``len(normalized_shape)`` axes of x."""
    norm_ndim = 1 if isinstance(normalized_shape, int) \
        else len(tuple(normalized_shape))
    return apply("layer_norm", _layer_norm, x, weight, bias,
                 norm_ndim=norm_ndim, epsilon=float(epsilon))


def _layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], norm_ndim: int,
                epsilon: float) -> torch.Tensor:
    axes = tuple(range(x.dim() - norm_ndim, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = ((x - mean) ** 2).mean(axes, keepdim=True)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, bias=None, epsilon: float = 1e-6, name=None):
    """RMSNorm over the last axis: fp32 statistics, the normalised value
    rounded to x's type before ``* weight + bias``."""
    return apply("rms_norm", _rms_norm, x, weight, bias,
                 epsilon=float(epsilon))


def _rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], epsilon: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = (xf / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
