"""Gradient clipping: the counterpart of ``paddle_tpu/nn/clip.py``.

A clip takes ``(parameter, gradient)`` pairs and returns new pairs, as the
reference's do; the optimizers call it on every gradient before the
update. Norms are taken in float32 and the scale is applied in float32,
then cast back to the gradient's type. Nothing is read on the host: the
scale ``min(clip_norm / max(norm, 1e-12), 1)`` stays a tensor on the
gradients' device.
"""
from __future__ import annotations

import torch

from .._core.device import default_device
from .._core.tensor import Tensor

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _payload(g):
    return g._t if isinstance(g, Tensor) else g


def _sum_squares(grads) -> torch.Tensor:
    """The sum over every gradient of its float32 squares."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(_sum_squares(grads))


def _scaled(params_grads, scale: torch.Tensor):
    """Each gradient times ``scale`` in float32, back in its own type; a
    parameter with ``need_clip`` False keeps its gradient."""
    out = []
    for p, g in params_grads:
        if g is None or not getattr(p, "need_clip", True):
            out.append((p, g))
            continue
        t = _payload(g)
        out.append((p, Tensor((t.float() * scale).to(t.dtype))))
    return out


def _scale(clip_norm: float, norm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element clipped to ``[min, max]`` (min = -max by
    default)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, g if g is None else Tensor(torch.clamp(
            _payload(g), self.min, self.max))) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            g32 = _payload(g).float()
            scale = _scale(self.clip_norm, torch.sqrt(torch.sum(
                torch.square(g32))))
            out.append((p, Tensor((g32 * scale).to(_payload(g).dtype))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by one factor, so that their joint L2 norm
    is at most ``clip_norm``; a parameter with ``need_clip`` False keeps
    its gradient (its norm still counts)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def __call__(self, params_grads):
        grads = [_payload(g) for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        return _scaled(params_grads,
                       _scale(self.clip_norm, _global_norm(grads)))


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scales the gradients of ``parameters`` in place to a joint L2 norm
    of at most ``max_norm``; returns that norm before clipping."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return Tensor(torch.zeros((), device=default_device()))
    grads = [p._t.grad for p in params]
    gnorm = _global_norm(grads)
    scale = _scale(float(max_norm), gnorm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return Tensor(gnorm)
