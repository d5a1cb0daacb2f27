"""Autograd switches and ``paddle.grad``: the counterpart of
``paddle_tpu/_core/autograd.py`` and ``paddle_tpu/autograd.py``, over
torch's autograd.

The engine is torch's: a ``Tensor``'s payload carries its graph, and
``.grad`` of a leaf accumulates across ``backward`` calls until
``clear_grad``, as the reference's does. ``backward`` tries the lazy
window's fused forward+backward first (``lazy.try_fused_backward``); after
either, the callbacks of ``register_post_backward_callback`` run (the
``DataParallel`` reducer). The reference's in-degree walk (its engine's
``discover``) has no counterpart: torch's engine orders the backward.
With ``FLAGS_observability`` on, each ``backward`` counts
``autograd.fused_steps`` or ``autograd.engine_runs``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import lazy
from ..observability import _state as _OBS
from .dispatch import unwrap, wrap


class no_grad(torch.no_grad):
    """``paddle.no_grad``: a context manager and a decorator."""


class enable_grad(torch.enable_grad):
    """``paddle.enable_grad``."""


class set_grad_enabled(torch.set_grad_enabled):
    """``paddle.set_grad_enabled(mode)``."""


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _seeds(tensors, grad_tensors):
    """Payloads of the roots and their seed gradients: ones where none is
    given, as the reference seeds a non-scalar root."""
    roots = [unwrap(t) for t in tensors]
    grads = _as_list(grad_tensors) if grad_tensors is not None \
        else [None] * len(roots)
    return roots, [torch.ones_like(r) if g is None else unwrap(g)
                   for r, g in zip(roots, grads)]


_post_backward_callbacks = []


def register_post_backward_callback(fn):
    """Runs ``fn()`` after every completed ``backward()``, fused or not: the
    hook the ``DataParallel`` reducer averages gradients from. Returns a
    function that removes it."""
    _post_backward_callbacks.append(fn)

    def _remove():
        try:
            _post_backward_callbacks.remove(fn)
        except ValueError:
            pass
    return _remove


def backward(tensors, grad_tensors=None, retain_graph: bool = False) -> None:
    """``paddle.autograd.backward``: gradients of ``tensors`` into the
    ``.grad`` of the leaves they depend on. A scalar root still pending in
    the lazy window takes the fused path first (``lazy.try_fused_backward``:
    the segment's forward and this backward as one runner call), as the
    reference's engine does."""
    tensors = _as_list(tensors)
    if not retain_graph and lazy.try_fused_backward(
            tensors, None if grad_tensors is None
            else _as_list(grad_tensors)):
        if _OBS.METRICS:
            from ..observability import metrics
            metrics.inc("autograd.fused_steps")
    else:
        # the engine's walk (a rising engine_runs/fused_steps ratio says a
        # loop fell off the fused path)
        if _OBS.METRICS:
            from ..observability import metrics
            metrics.inc("autograd.engine_runs")
        roots, grads = _seeds(tensors, grad_tensors)
        torch.autograd.backward(roots, grads, retain_graph=retain_graph)
    for cb in list(_post_backward_callbacks):
        cb()


def grad(outputs, inputs, grad_outputs=None,
         retain_graph: Optional[bool] = None, create_graph: bool = False,
         allow_unused: bool = False) -> Sequence:
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, as a list (None for an unused input when
    ``allow_unused``); ``.grad`` is left as it is."""
    roots, grads = _seeds(_as_list(outputs), grad_outputs)
    got = torch.autograd.grad(
        roots, [unwrap(t) for t in _as_list(inputs)], grads,
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=allow_unused)
    return [None if g is None else wrap(g) for g in got]
