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

The hooks run in the reference's order: ``STATIC_HOOK`` first (the op goes
into the current static Program), then the lazy window (``_core/lazy.py``:
while a capture context is active on this thread and the call has eager
``Tensor`` inputs, the op is recorded, not run), then ``AMP_HOOK``. Calls
that carry only raw ``torch.Tensor``s never record: the compiled trainers,
``make_fx`` tracing inside ``to_static`` and ``static``'s recorder stay
out of any window.

While the lazy window's whole-step driver is armed (``DRIVE_CELL``), one
native call records each op before any of the above.

``exec_count()`` counts executions: one for each eager op run outside a
window and one for each segment run (a fused forward+backward is one, an
optimizer step is one); not kernel launches, of which one segment run
makes many.
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
# whether a lazy window may be open in some thread, and the function that
# answers the calling thread's context (both kept by _core/lazy.py)
LAZY_GATE = False
LAZY_CONTEXT: Optional[Callable] = None

# the whole-step driver of the lazy window (_core/lazy.py): the armed
# _DriveState or None, and the native call that records one op of it
DRIVE_CELL: list = [None]
NC_DRIVE: Optional[Callable] = None

_EXECS = [0]
_Tensor = None


class _NotRecorded:
    """A window's answer when it could not record an op (run it eagerly)."""


NOT_RECORDED = _NotRecorded()


def exec_count() -> int:
    """Executions so far (see the module docstring)."""
    return _EXECS[0]


def bump_exec(n: int = 1) -> None:
    _EXECS[0] += n


def _tensor_cls():
    global _Tensor
    from .tensor import Tensor
    _Tensor = Tensor
    return Tensor


def unwrap(x):
    """A ``Tensor``'s payload; anything else as it is."""
    Tensor = _Tensor or _tensor_cls()
    return x._t if isinstance(x, Tensor) else x


def meta(x):
    """What metadata is read from: a ``Tensor``'s payload as it stands (a
    pending value of the lazy window answers shape, dtype and device
    without landing), anything else as it is."""
    Tensor = _Tensor or _tensor_cls()
    return x._payload if isinstance(x, Tensor) else x


def wrap(out):
    """torch tensors (alone, in a tuple or a list) as ``Tensor``s."""
    Tensor = _Tensor or _tensor_cls()
    if isinstance(out, torch.Tensor):
        return Tensor(out)
    if isinstance(out, (tuple, list)):
        return type(out)(wrap(o) for o in out)
    return out


def apply(name: str, fn: Callable, *inputs, **attrs):
    """Runs op ``name`` as ``fn(*payloads, **attrs)``."""
    d = DRIVE_CELL[0]
    if d is not None:
        # an armed step plan: one native call records the op, or retires
        # the driver (None) and the op takes the path below
        out = NC_DRIVE(d, name, fn, inputs, attrs)
        if out is not None:
            return out
    Tensor = _Tensor or _tensor_cls()
    if STATIC_HOOK is not None:
        return STATIC_HOOK(name, fn, list(inputs), attrs)
    eager = False
    for x in inputs:
        if isinstance(x, Tensor):
            eager = True
            break
    if eager:
        if LAZY_GATE:
            ctx = LAZY_CONTEXT()
            if ctx is not None:
                out = ctx.record(name, fn, inputs, attrs)
                if out is not NOT_RECORDED:
                    ctx.maybe_cap_flush()
                    return out
        _EXECS[0] += 1
    args = [x._t if isinstance(x, Tensor) else x for x in inputs]
    if AMP_HOOK is not None:
        args = AMP_HOOK(name, args)
    out = fn(*args, **attrs)
    return wrap(out) if eager else out
