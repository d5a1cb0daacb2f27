"""The op registry: the counterpart of ``paddle_tpu/_core/op_registry.py``.

An op is a name and a body: a plain function over ``torch.Tensor``
payloads, ``body(*tensors, **attrs)``, returning a tensor or (for a
``multi_output`` op) a tuple of them. ``register_op`` records it; ``call``
runs it by name through the port's one dispatch path
(``dispatch.apply(name, body, ...)``), so AMP's per-name rules apply to a
call by name as they do to a direct ``apply``. Autograd is torch's.

The schema of record is the port's own ``ops/yaml/ops.yaml``: an op that
is not declared there cannot be registered, except through the escape
hatch ``custom=True`` (out-of-tree ops, tests). ``ops/yaml/gen.py`` checks
the other direction.
"""
from __future__ import annotations

import os
import re
from typing import Callable, Dict

from .dispatch import apply


class OpDef:
    """One registered op: ``fn`` its body, ``multi_output`` whether it
    returns a tuple, ``custom`` whether it was registered outside the
    schema."""

    __slots__ = ("name", "fn", "multi_output", "custom")

    def __init__(self, name: str, fn: Callable, multi_output: bool = False,
                 custom: bool = False):
        self.name = name
        self.fn = fn
        self.multi_output = multi_output
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


def register_op(name: str, fn: Callable = None, *, multi_output=False,
                custom=False):
    """Registers ``fn`` as op ``name`` (also as a decorator). A framework
    op needs an ``ops.yaml`` entry; ``custom=True`` registers one without."""
    def _do(f):
        if name in _OPS:
            raise ValueError(f"op '{name}' already registered")
        if not custom and name not in schema_names():
            raise ValueError(
                f"op '{name}' has no ops.yaml entry: the schema "
                f"(paddle_tpu_torch/ops/yaml/ops.yaml) is the system of "
                f"record; add an entry or register with custom=True")
        _OPS[name] = OpDef(name, f, multi_output, custom)
        return f
    return _do if fn is None else _do(fn)


def get_op(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"op '{name}' is not registered") from None


def all_ops() -> Dict[str, OpDef]:
    return dict(_OPS)


def call(name: str, *inputs, **attrs):
    """Runs the registered op ``name`` on ``inputs`` (``Tensor``s, torch
    tensors or other values) with ``attrs``."""
    return apply(name, get_op(name).fn, *inputs, **attrs)
