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

While the NaN/Inf scan (``FLAGS_check_nan_inf``) or the profiler's per-op
hook (``set_profile_cb``, the reference's ``executor.set_profile_cb``) is
on, every op dispatches alone: a window open on the thread lands what it
holds (``per_op_mode``) and the op runs eagerly, inside the hook's scope,
its outputs scanned (``_check_nan_inf``: raise, or warn at
``FLAGS_check_nan_inf_level`` 1, naming the op and its ``file:line``).
With the memory plane on, eager outputs enter its census with the birth
site ``eager:<op>``; with the metrics plane on, each eager op counts
``eager.ops``.

``exec_count()`` counts executions: one for each eager op run outside a
window and one for each segment run (a fused forward+backward is one, an
optimizer step is one); not kernel launches, of which one segment run
makes many.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import flags as _flags
from ..observability import _state as _obs

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

# the profiler's per-op hook (op name -> context manager) and the gate
# apply reads: a hook installed or the NaN/Inf scan armed
_PROFILE_CB: Optional[Callable] = None
PER_OP_MODE = False


def _sync_per_op_mode(_value=None):
    global PER_OP_MODE
    PER_OP_MODE = _PROFILE_CB is not None or _flags.NAN_CHECK_ACTIVE
    if PER_OP_MODE:
        # an armed whole-step drive records without reaching the window's
        # per-op check: retire it
        DRIVE_CELL[0] = None


def set_profile_cb(fn: Optional[Callable]) -> None:
    """Install (or, with None, remove) the profiler's per-op hook."""
    global _PROFILE_CB
    _PROFILE_CB = fn
    _sync_per_op_mode()


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
                if PER_OP_MODE:
                    # per-op hooks see each op alone: land the window
                    # first, so events keep the execution order
                    ctx.flush("per_op_mode")
                else:
                    out = ctx.record(name, fn, inputs, attrs)
                    if out is not NOT_RECORDED:
                        ctx.maybe_cap_flush()
                        return out
        _EXECS[0] += 1
        if _obs.ACTIVE:
            if _obs.METRICS:
                from ..observability import metrics
                metrics.inc("eager.ops")
    args = [x._t if isinstance(x, Tensor) else x for x in inputs]
    if AMP_HOOK is not None:
        args = AMP_HOOK(name, args)
    if not eager:
        return fn(*args, **attrs)
    if PER_OP_MODE:
        if _PROFILE_CB is not None:
            with _PROFILE_CB(name):
                out = fn(*args, **attrs)
        else:
            out = fn(*args, **attrs)
        if _flags.NAN_CHECK_ACTIVE:
            _check_nan_inf(name, out if isinstance(out, (tuple, list))
                           else (out,), site=True)
    else:
        out = fn(*args, **attrs)
    if _obs.MEM:
        from ..observability import memory as _memtel
        _memtel.set_site("eager:" + name)
        try:
            return wrap(out)
        finally:
            _memtel.clear_site()
    return wrap(out)


def _check_nan_inf(name: str, outs, site: bool = False):
    """``FLAGS_check_nan_inf``'s scan (``nan_inf_utils.h:38``): a floating
    output holding a NaN or an Inf raises ``FloatingPointError`` naming
    the op (and, for the per-op eager scan, the user's ``file:line``), or
    warns at ``FLAGS_check_nan_inf_level`` 1. The goodput plane's NaN
    watch rides this scan. Reading the verdict synchronizes the device:
    the scan is a debugging aid."""
    for i, o in enumerate(outs):
        if isinstance(o, torch.Tensor) and (o.is_floating_point()
                                            or o.is_complex()):
            if o.device.type == "meta" or not o.numel():
                continue
            if bool(torch.isfinite(o).all()):
                continue
            msg = f"NaN/Inf detected in output {i} of op '{name}'"
            if site:
                from ..analysis.hooks import call_site
                src = call_site()
                if src:
                    msg += f" @ {src}"
            if _obs.GOODPUT:
                from ..observability import goodput
                goodput.note_nan(name)
            if _flags.flag_value("FLAGS_check_nan_inf_level") >= 1:
                import warnings
                warnings.warn(msg)
            else:
                raise FloatingPointError(msg)


_flags.watch_flag("FLAGS_check_nan_inf", _sync_per_op_mode)
