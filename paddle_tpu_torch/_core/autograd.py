"""Autograd switches and ``paddle.grad``: the counterpart of
``paddle_tpu/_core/autograd.py`` and ``paddle_tpu/autograd.py``, over
torch's autograd.

The engine is torch's: a ``Tensor``'s payload carries its graph, and
``.grad`` of a leaf accumulates across ``backward`` calls until
``clear_grad``, as the reference's does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

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


def backward(tensors, grad_tensors=None, retain_graph: bool = False) -> None:
    """``paddle.autograd.backward``: gradients of ``tensors`` into the
    ``.grad`` of the leaves they depend on."""
    roots, grads = _seeds(_as_list(tensors), grad_tensors)
    torch.autograd.backward(roots, grads, retain_graph=retain_graph)


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
