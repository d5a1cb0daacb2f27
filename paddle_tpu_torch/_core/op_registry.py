"""The op registry: the counterpart of ``paddle_tpu/_core/op_registry.py``.

An op is a name and a body: a plain function over ``torch.Tensor``
payloads, ``body(*tensors, **attrs)``, returning a tensor or (for a
``multi_output`` op) a tuple of them. ``register_op`` records it; ``call``
runs it by name through the port's one dispatch path
(``dispatch.apply(name, body, ...)``), so AMP's per-name rules apply to a
call by name as they do to a direct ``apply``. Autograd is torch's, unless
the op was registered with a ``bwd``: then ``call`` runs the body inside
a ``torch.autograd.Function`` whose backward is
``bwd(saved_inputs, gouts, **attrs)``, as the reference's dispatcher runs
it in place of autodiff.

The schema of record is the port's own ``ops/yaml/ops.yaml``: an op that
is not declared there cannot be registered, except through the escape
hatch ``custom=True`` (out-of-tree ops, tests). ``ops/yaml/gen.py`` checks
the other direction.
"""
from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional

import torch

from .dispatch import apply


class OpDef:
    """One registered op: ``fn`` its body, ``bwd`` its gradient where it
    replaces autodiff (``bwd(saved_inputs, gouts, **attrs)`` -> a tuple of
    input gradients, None allowed), ``multi_output`` whether it returns a
    tuple, ``spmd_rule`` the reference's sharding rule (stored; the port
    has no SPMD use for it yet), ``custom`` whether it was registered
    outside the schema."""

    __slots__ = ("name", "fn", "bwd", "multi_output", "spmd_rule", "custom")

    def __init__(self, name: str, fn: Callable, bwd: Optional[Callable] = None,
                 multi_output: bool = False, spmd_rule=None,
                 custom: bool = False):
        self.name = name
        self.fn = fn
        self.bwd = bwd
        self.multi_output = multi_output
        self.spmd_rule = spmd_rule
        self.custom = custom


_OPS: Dict[str, OpDef] = {}
_SCHEMA_NAMES = None
SCHEMA = os.path.join(os.path.dirname(__file__), os.pardir, "ops", "yaml",
                      "ops.yaml")


def schema_names():
    """The op names ``ops.yaml`` declares (read line by line, so the
    registry needs nothing of the generator)."""
    global _SCHEMA_NAMES
    if _SCHEMA_NAMES is None:
        with open(SCHEMA) as f:
            _SCHEMA_NAMES = {m.group(1) for m in (
                re.match(r"-\s*op\s*:\s*(\w+)", line.strip()) for line in f)
                if m}
    return _SCHEMA_NAMES


def register_op(name: str, fn: Callable = None, *, bwd: Callable = None,
                multi_output=False, spmd_rule=None, custom=False):
    """Registers ``fn`` as op ``name`` (also as a decorator), with ``bwd``
    and ``spmd_rule`` as the reference's ``register_op`` takes them. A
    framework op needs an ``ops.yaml`` entry; ``custom=True`` registers one
    without. Returns ``fn``, so that a decorated body stays a function
    (the reference returns the ``OpDef``; ``get_op`` gives it here)."""
    def _do(f):
        if name in _OPS:
            raise ValueError(f"op '{name}' already registered")
        if not custom and name not in schema_names():
            raise ValueError(
                f"op '{name}' has no ops.yaml entry: the schema "
                f"(paddle_tpu_torch/ops/yaml/ops.yaml) is the system of "
                f"record; add an entry or register with custom=True")
        _OPS[name] = OpDef(name, f, bwd=bwd, multi_output=multi_output,
                           spmd_rule=spmd_rule, custom=custom)
        return f
    return _do if fn is None else _do(fn)


def get_op(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"op '{name}' is not registered") from None


def all_ops() -> Dict[str, OpDef]:
    return dict(_OPS)


_SAVED = object()  # an input kept by save_for_backward


class _CustomGrad(torch.autograd.Function):
    """An op whose gradient is its ``bwd``: the body runs without a graph,
    the inputs are kept, and the backward hands ``bwd`` the inputs and the
    output gradients (zeros for outputs that got none)."""

    @staticmethod
    def forward(ctx, op, attrs, *args):
        ctx.op, ctx.attrs = op, attrs
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*tensors)
        ctx.args = [_SAVED if isinstance(a, torch.Tensor) else a for a in args]
        return op.fn(*args, **attrs)

    @staticmethod
    def backward(ctx, *gouts):
        saved = iter(ctx.saved_tensors)
        inputs = tuple(next(saved) if a is _SAVED else a for a in ctx.args)
        grads = tuple(ctx.op.bwd(inputs, gouts, **ctx.attrs))
        grads = grads + (None,) * (len(inputs) - len(grads))
        return (None, None, *(g if isinstance(x, torch.Tensor) else None
                              for g, x in zip(grads, inputs)))


def call(name: str, *inputs, **attrs):
    """Runs the registered op ``name`` on ``inputs`` (``Tensor``s, torch
    tensors or other values) with ``attrs``; through its ``bwd`` where it
    has one."""
    op = get_op(name)
    if op.bwd is None:
        return apply(name, op.fn, *inputs, **attrs)
    return apply(name, lambda *args, **kw: _CustomGrad.apply(op, kw, *args),
                 *inputs, **attrs)
