"""``paddle.autograd``: the counterpart of ``paddle_tpu/autograd.py``.

``PyLayer`` is a user-defined forward and backward in Python. The
reference wires it into its own graph engine as a node; here it runs
inside a ``torch.autograd.Function``, with the reference's rules:

- only the positional ``Tensor`` arguments are edges (a ``Tensor`` passed
  by keyword is a constant);
- ``forward`` runs without a graph;
- ``backward`` gets one gradient for each ``Tensor`` output that was not
  marked non-differentiable, and may return fewer gradients than there
  are edges (the rest are None);
- only floating outputs get a gradient; a non-differentiable output has
  ``stop_gradient`` set.
"""
from __future__ import annotations

from typing import List

import torch

from ._core.autograd import backward, grad, is_grad_enabled, \
    no_grad  # noqa: F401
from ._core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "backward", "grad", "no_grad"]

run_backward = backward  # the reference's engine entry, by its name
GradNode = torch.autograd.graph.Node  # a node of the graph the engine runs


class PyLayerContext:
    """The ``ctx`` a ``PyLayer``'s forward and backward share."""

    def __init__(self):
        self._saved: List[Tensor] = []
        self._non_diff: List[Tensor] = []
        self.materialize_grads = True
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved

    def mark_not_inplace(self, *args):
        self.not_inplace_tensors = args

    def mark_non_differentiable(self, *args):
        self._non_diff = self._non_diff + list(args)
        for t in args:
            t.stop_gradient = True

    def set_materialize_grads(self, value):
        self.materialize_grads = bool(value)


class PyLayerMeta(type):
    """The metaclass of ``PyLayer`` (the reference's has no behaviour of
    its own either)."""


def _flat(outs):
    single = not isinstance(outs, (tuple, list))
    return single, [outs] if single else list(outs)


class _Function(torch.autograd.Function):
    """Runs ``layer.forward`` on the edges' payloads and hands
    ``layer.backward`` the output gradients as ``Tensor``s."""

    @staticmethod
    def forward(tctx, layer, ctx, args, kwargs, spots, out, *payloads):
        args = list(args)
        for i, p in zip(spots, payloads):
            args[i] = Tensor(p)
        outs = layer.forward(ctx, *args, **kwargs)
        single, items = _flat(outs)
        non_diff = {id(t) for t in ctx._non_diff}
        out["single"], out["items"] = single, items
        out["kind"] = type(outs)
        tensors = [o for o in items if isinstance(o, Tensor)]
        # the payloads a backward gets a gradient for
        out["diff"] = [id(o) not in non_diff for o in tensors]
        results = [o._t for o in tensors]
        tctx.mark_non_differentiable(*[
            r for r, d in zip(results, out["diff"])
            if not d or not (r.is_floating_point() or r.is_complex())])
        tctx.set_materialize_grads(ctx.materialize_grads)
        tctx.layer, tctx.ctx, tctx.n_edges = layer, ctx, len(payloads)
        tctx.diff = out["diff"]
        return tuple(results)

    @staticmethod
    def backward(tctx, *grads):
        gts = [None if g is None else Tensor(g)
               for g, d in zip(grads, tctx.diff) if d]
        with torch.no_grad():
            res = tctx.layer.backward(tctx.ctx, *gts)
        res = [res] if isinstance(res, Tensor) or res is None else list(res)
        res = res + [None] * (tctx.n_edges - len(res))
        return (None,) * 6 + tuple(
            None if r is None else r._t for r in res[:tctx.n_edges])


class PyLayer(metaclass=PyLayerMeta):
    """Subclass with static ``forward(ctx, *args, **kwargs)`` and
    ``backward(ctx, *grads)``; call ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        spots = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        out = {}
        results = _Function.apply(cls, ctx, args, kwargs, spots, out,
                                  *[args[i]._t for i in spots])
        results = iter(results)
        wrapped = [Tensor(next(results)) if isinstance(o, Tensor) else o
                   for o in out["items"]]
        if out["single"]:
            return wrapped[0]
        return out["kind"](wrapped) if out["kind"] in (tuple, list) \
            else tuple(wrapped)


class LegacyPyLayer(PyLayer):
    pass
