"""Normalisation functionals in plain PyTorch.

Counterpart of ``paddle_tpu/nn/functional/norm.py`` (``batch_norm``,
``layer_norm``, ``rms_norm``, ``group_norm``, ``instance_norm``,
``local_response_norm``), which is
plain jnp in the reference. Each rounds where its reference does:

- ``layer_norm`` works in x's own type throughout;
- ``rms_norm`` takes fp32 statistics, rounds ``x / sqrt(var + eps)`` to x's
  type, then multiplies by the weight and adds the bias in that type;
- ``batch_norm`` is two ops, as there: ``bn_stats`` (the batch mean and
  the *biased* variance, differentiable) and ``bn_apply``
  (``(x - mean) * (1 / sqrt(var + eps)) * w + b``), both on AMP's black
  list, so under O1 batch norm runs in float32. Its running buffers take
  ``m * running + (1 - m) * batch`` with the biased batch variance, m =
  0.9 by default: torch's own running update is not that one (it takes
  the unbiased variance and weighs the new batch by its momentum), so the
  update is written out here, on the card, with no read on the host.

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

from ..._core import lazy
from ..._core.dispatch import apply
from ..._core.op_registry import register_op


def layer_norm(x, normalized_shape: Union[int, Sequence[int]], weight=None,
               bias=None, epsilon: float = 1e-05, name=None):
    """Normalises the trailing ``len(normalized_shape)`` axes of x."""
    norm_ndim = 1 if isinstance(normalized_shape, int) \
        else len(tuple(normalized_shape))
    return apply("layer_norm", _layer_norm, x, weight, bias,
                 norm_ndim=norm_ndim, eps=float(epsilon))


@register_op("layer_norm")
def _layer_norm(x: torch.Tensor, w: Optional[torch.Tensor],
                b: Optional[torch.Tensor], eps: float,
                norm_ndim: int) -> torch.Tensor:
    axes = tuple(range(x.dim() - norm_ndim, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = ((x - mean) ** 2).mean(axes, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


def rms_norm(x, weight=None, bias=None, epsilon: float = 1e-6, name=None):
    """RMSNorm over the last axis: fp32 statistics, the normalised value
    rounded to x's type before ``* weight + bias``."""
    return apply("rms_norm", _rms_norm, x, weight, bias,
                 eps=float(epsilon))


@register_op("rms_norm")
def _rms_norm(x: torch.Tensor, w: Optional[torch.Tensor],
              b: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = (xf / torch.sqrt(var + eps)).to(x.dtype)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


def _channel_axis(x: torch.Tensor, fmt: str) -> int:
    return 1 if fmt.startswith("NC") and x.dim() > 1 else x.dim() - 1


@register_op("bn_stats", multi_output=True)
def _bn_stats(x: torch.Tensor, fmt: str):
    """The batch mean and biased variance over every axis but the
    channel's."""
    c = 1 if fmt.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c)
    var, mean = torch.var_mean(x, axes, correction=0)
    return mean, var


@register_op("bn_apply")
def _bn_apply(x, mean, var, w, b, eps: float, fmt: str):
    shape = [1] * x.dim()
    shape[_channel_axis(x, fmt)] = x.shape[_channel_axis(x, fmt)]
    inv = (1.0 / torch.sqrt(var + eps)).reshape(shape)
    out = (x - mean.reshape(shape)) * inv
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over the channel axis of ``data_format``. In training
    (and unless ``use_global_stats``) the batch's statistics normalise x
    and ``running_mean`` / ``running_var`` (``Tensor``s or torch tensors)
    are updated in place; otherwise the running statistics normalise."""
    if training and not use_global_stats:
        mean, var = apply("bn_stats", _bn_stats, x, fmt=data_format)
        m = float(momentum)
        # the running statistics are written in place: a pending segment
        # that reads them runs first (this lands the batch's statistics)
        lazy.flush_active("inplace_write")
        with torch.no_grad():
            for run, stat in ((running_mean, mean), (running_var, var)):
                run_t = run._t if hasattr(run, "_t") else run
                stat_t = stat._t if hasattr(stat, "_t") else stat
                run_t.copy_(m * run_t + (1.0 - m) * stat_t)
    else:
        mean, var = running_mean, running_var
    return apply("bn_apply", _bn_apply, x, mean, var, weight, bias,
                 eps=float(epsilon), fmt=data_format)


@register_op("group_norm")
def _group_norm(x, w, b, groups: int, eps: float, fmt: str):
    if fmt == "NHWC":
        x = x.movedim(-1, 1)
    n, c = x.shape[0], x.shape[1]
    spatial = x.shape[2:]
    xg = x.reshape(n, groups, c // groups, *spatial)
    axes = tuple(range(2, xg.dim()))
    var, mean = torch.var_mean(xg, axes, correction=0, keepdim=True)
    out = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = [1, c] + [1] * len(spatial)
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    return out.movedim(1, -1) if fmt == "NHWC" else out


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalises each of ``num_groups`` channel groups of each sample."""
    return apply("group_norm", _group_norm, x, weight, bias,
                 groups=int(num_groups), eps=float(epsilon),
                 fmt=data_format)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Group norm with one group per channel, as the reference computes
    it (the running statistics are taken and not used)."""
    c = x.shape[-1] if data_format == "NHWC" else x.shape[1]
    return apply("group_norm", _group_norm, x, weight, bias,
                 groups=int(c), eps=float(eps), fmt=data_format)


@register_op("local_response_norm_k")
def _local_response_norm(x, size, alpha, beta, k, fmt):
    """``x / (k + alpha * mean(x^2 over the channel window))^beta``, the
    window padded ``size // 2`` before and ``(size - 1) // 2`` after."""
    ax = 1 if fmt.startswith("NC") else x.dim() - 1
    sq = (x * x).movedim(ax, -1)
    sq = torch.nn.functional.pad(sq, (size // 2, (size - 1) // 2))
    ssum = sq.unfold(-1, size, 1).sum(-1).movedim(-1, ax)
    return x / (k + alpha * ssum / size) ** beta


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return apply("local_response_norm_k", _local_response_norm, x,
                 size=int(size), alpha=float(alpha), beta=float(beta),
                 k=float(k), fmt=data_format)
