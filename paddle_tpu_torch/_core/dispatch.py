"""One call path per op: the counterpart of ``paddle_tpu/_core/executor.py``
``apply`` (with ``dispatch.py`` and ``op_registry.py``).

``apply(name, fn, *inputs, **attrs)`` unwraps the eager ``Tensor``s among
the inputs to their ``torch.Tensor`` payloads, lets the AMP rule of the
op's name cast them (``amp/auto_cast.py`` installs it while a scope is
live), calls the torch function and wraps what it returns. Autograd is
torch's: the payloads carry it. Inputs that are ``torch.Tensor``s already
pass through, and a call that got no ``Tensor`` returns torch tensors, so
the functional trainers (``models/gpt.py``, ``models/llama.py``) call the
same functionals at no cost.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# (op name, list of inputs) -> list of inputs; set by amp.auto_cast while
# a scope is live, None otherwise (no per-op cost outside AMP)
AMP_HOOK: Optional[Callable] = None
# (op name, body, inputs, attrs) -> output placeholders; set by
# static.enable_static (the reference's set_static_recorder): the op is
# recorded into the current Program instead of running
STATIC_HOOK: Optional[Callable] = None


def unwrap(x):
    """A ``Tensor``'s payload; anything else as it is."""
    from .tensor import Tensor
    return x._t if isinstance(x, Tensor) else x


def wrap(out):
    """torch tensors (alone, in a tuple or a list) as ``Tensor``s."""
    from .tensor import Tensor
    if isinstance(out, torch.Tensor):
        return Tensor(out)
    if isinstance(out, (tuple, list)):
        return type(out)(wrap(o) for o in out)
    return out


def apply(name: str, fn: Callable, *inputs, **attrs):
    """Runs op ``name`` as ``fn(*payloads, **attrs)``."""
    from .tensor import Tensor
    if STATIC_HOOK is not None:
        return STATIC_HOOK(name, fn, list(inputs), attrs)
    eager = any(isinstance(x, Tensor) for x in inputs)
    args = [x._t if isinstance(x, Tensor) else x for x in inputs]
    if AMP_HOOK is not None:
        args = AMP_HOOK(name, args)
    out = fn(*args, **attrs)
    return wrap(out) if eager else out
