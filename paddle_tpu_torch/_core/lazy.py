"""The lazy fusion window: the counterpart of ``paddle_tpu/_core/lazy.py``.

Eager ops are recorded instead of run while a capture context is active on
the calling thread (``lazy_guard()``, the ambient window of
``enable_eager_fusion(True)``, or SOT's capture), and run as one segment at
the next sync point: a value read (``Tensor._t``, ``numpy()``,
``float()``), ``backward()``, an optimizer step, the segment cap
(``FLAGS_lazy_max_segment_ops``) or the end of the guard.

- A segment is the recorded op list: each op's torch function, its attrs
  and constant arguments, its input wiring, and the grad mode and AMP state
  it was recorded under. Flushing runs those ops in order on the current
  stream (``_SegmentRunner``), re-entering each op's grad mode and casting
  its inputs by its recorded AMP rule, so random ops draw from the port's
  generators in eager order and a rerun never replays old numbers.
- ``_SEG_CACHE`` maps a segment's structural signature (``_signature``:
  op names, attrs, wiring, input metadata, live outputs) to the built
  runner: the slot plan that frees each intermediate after its last use.
  ``_FUSED_CACHE`` does the same for the fused forward+backward.
- Record-time metadata: each op runs once on ``device="meta"`` tensors
  (cached in ``_AVAL_CACHE`` by op, attrs, constants, input
  shapes/dtypes/devices/grad flags, grad mode and AMP state), so
  ``shape``, ``dtype``, ``place``, ``len()`` and ``stop_gradient`` of a
  pending value answer without flushing. An op that cannot run on meta
  tensors (a data-dependent shape, a host read) flushes the window and runs
  eagerly (``record_fallback``).
- Autograd is torch's: a segment run with grad enabled builds torch's
  ordinary graph, so gradients chain across segments. ``backward()`` on a
  root still pending runs the segment's forward and its backward as one
  runner call (``try_fused_backward``, one execution).
- The window is per thread (``_ThreadState``); ``note_inplace`` evicts a
  swapped payload from every open context.
- The record fast path (``FLAGS_record_fast_path``): once a sealed
  segment's signature memo proves its op stream repeats, later records
  match the retained skeleton position by position and reuse its cached
  metadata; after ``FLAGS_step_replay_after`` clean replays the seal skips
  the signature rebuild (a step plan, ``REPLAY_STEPS``). Shape drift,
  ``set_flags`` of a watched flag, an in-place swap mid-segment and a
  grad-mode flip demote it.
- Two prongs do that work. The Python prong (``_record_fast``, the
  ``_SIG_ENTRY_INTERN`` pool, ``_AVAL_CACHE``) stands alone. The native
  prong (``_native_core()``: ``paddle_tpu_torch/csrc/eager_core.cc``, built
  at first use by ``_core/native.py``) replays a skeleton record in one C
  call (``skel_record``), keeps the metadata cache and the attrs keys in C
  and interns signature entries into the same pool; once a shape has a step
  plan, the whole-step driver (``_DriveState`` in ``_DRIVE_CELL``) takes
  each later op of the segment in one C call from ``dispatch.apply``
  (``drive_record``) and retires itself at the plan's end, the segment cap,
  a generation bump (``_FAST_GEN_CELL``: a watched ``set_flags``), an
  in-place swap, a grad-mode flip, shape drift or any other mismatch. Both
  prongs give the same op list, the same ``FAST_OPS`` and ``REPLAY_STEPS``
  and the same executions; tests force one by setting ``_NC`` and
  ``_NC_TRIED`` (and ``_DRIVE_OK``).

``FLAGS_eager_fusion`` is off by default in the port (``ROADMAP.md`` §3):
on the card the stream already runs ahead of the host, and a window whose
segments run their ops in order only adds host time until steady segments
replay as CUDA graphs.

- ``MESH_EPOCH`` salts every segment and fused-step signature;
  ``bump_mesh_epoch`` (the adaptive trainer's, after a re-plan) re-keys
  them, so a window records anew on the new world and never replays a
  runner built around the old one.
- Fault sites, behind ``flags.FAULT_INJECT_ACTIVE``: ``segment::compile``
  where a segment's (or the fused step's) runner is built, ``exec::oom``
  before a runner executes, on each of the three execute paths (a
  synchronous flush, the async worker, the fused backward).
- The measurement plane, behind ``_OBS`` (``observability/_state.py``):
  the reference's counters (``segment.flushes``, ``segment.flush_reason.*``,
  ``fusion.window_breaks``, ``segment.ops``, ``record.fast_ops``,
  ``compiles.{segment,fused_step}``, ``segment.replay_steps``), spans
  (``segment::flush[<reason>]`` with a ``segment::compile`` (a runner
  build and its first execution), ``segment::execute`` or
  ``segment::replay_step`` child), the flight recorder's note of a failed
  flush, the compute plane's count of each runner built under it (at its
  first execution; ``COST_STALE`` marks runners built without one) and
  its ``<op>[<file>:<line>]`` op scopes (while it is on, every
  record names its call site, and the native prong is passed over:
  it records none), the memory plane's runner notes
  and census of segment outputs. An out-of-memory error on any execute
  path (a card's ``OutOfMemoryError`` or the ``exec::oom`` drill's
  ``ResourceExhausted``) becomes ``ResourceExhaustedError`` with the
  memory postmortem; the async path raises it at the sync point.
  ``FLAGS_check_nan_inf`` scans every live output of a flushed segment
  (and the fused step's gradients), naming the producing op and, where the
  compute plane captured it, its record-time ``file:line``.

Left out: ``PERF_OBSERVER`` and the sanitizer's checks (the analysis
plane, ``ROADMAP.md`` §1 item 9), ``SPMD`` (item 9.1) and donation of dead
inputs (torch frees them by reference count). A segment compiles nothing
here, so the persistent cache (``persist.py``) has nothing of the window's
to store.
"""
from __future__ import annotations

import struct
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import dispatch
from . import flags as _flags
from ..observability import _state as _OBS
from .cache import ExecCache
from .dtype import DType

_SEG_CACHE: Dict[Tuple, Any] = ExecCache(stat="segment")
_FUSED_CACHE: Dict[Tuple, Any] = ExecCache(stat="fused_step")
# record-time output metadata, LRU-bounded like the runner caches
_AVAL_CACHE: Dict[Tuple, Tuple] = ExecCache()

# ---- the record fast path (see the module docstring)
FAST_OPS = 0
REPLAY_STEPS = 0
_FAST_PATH = True
_FAST_GEN = 0
_STEP_REPLAY_AFTER = 3

# ---- the native prong (see the module docstring): the extension once
# resolved (None: the Python prong), the C mirror of _FAST_GEN, and the
# whole-step driver's cell (shared with dispatch.apply, which reads it
# first for every op)
_NC = None
_NC_TRIED = False
_DRIVE_OK = False
_FAST_GEN_CELL: list = [0]
_DRIVE_CELL: list = dispatch.DRIVE_CELL


# a salt of every segment and fused-step signature; bump_mesh_epoch re-keys
MESH_EPOCH = 0

# True when some runner was cached without the compute plane's count
# (built while FLAGS_compute_telemetry was off): entering the plane bumps
# MESH_EPOCH only while this is set
COST_STALE = False


def mark_cost_stale():
    global COST_STALE
    COST_STALE = True


def bump_mesh_epoch() -> int:
    """Re-key the segment and fused-step caches (the old entries age out
    of the LRU) and invalidate the armed record skeletons: after a
    re-plan the next window records anew."""
    global MESH_EPOCH
    MESH_EPOCH += 1
    invalidate_skeletons()
    return MESH_EPOCH


def _inject(site: str) -> None:
    """A runtime fault site; callers gate on ``_flags.FAULT_INJECT_ACTIVE``
    (the resilience package is imported only while a plan is armed)."""
    from ..distributed.resilience import faults
    faults.inject(site)


def _build(cache, key, build, fspan=None, n_ops=0, driven=False):
    """``(runner, exec span)``: the cached runner of ``key``, built (after
    the ``segment::compile`` site) on a miss. A runner built while the
    compute or memory plane is on is counted at its first execution
    (``_execute``); the span (under the flush span ``fspan``) is
    ``segment::compile`` for a build, else ``segment::execute`` or, for a
    whole-step replay, ``segment::replay_step``."""
    runner = cache.get(key)
    if runner is not None:
        return runner, (_obs_exec_span(False, n_ops, driven)
                        if fspan is not None else None)
    if _flags.FAULT_INJECT_ACTIVE:
        _inject("segment::compile")
    xspan = _obs_exec_span(True, n_ops) if fspan is not None else None
    if _OBS.METRICS:
        from ..observability import metrics
        metrics.inc("compiles." + cache.stat)
    if not _OBS.COMPUTE:
        mark_cost_stale()
    runner = build()
    if _OBS.MEM or _OBS.COMPUTE:
        runner.todo = (_OBS.MEM, _OBS.COMPUTE)
    cache[key] = runner
    return runner, xspan


def _execute(cache, key, runner, pending, run_vals):
    """One execution of a cached runner; the first one of a runner built
    under the compute or memory plane is counted (``compute.analyze``,
    ``memory.analyze``) and the counts noted on the cache entry. Every
    execution under the compute plane is priced from the entry's count."""
    todo = runner.todo
    if todo is None:
        out = runner(pending, run_vals)
    else:
        runner.todo = None
        mem, comp = todo
        run = lambda: runner(pending, run_vals)  # noqa: E731
        if comp:
            from ..observability import compute as _comptel
            run0 = run

            def run():
                out, info = _comptel.analyze(run0)
                _comptel.note_executable(cache.stat, key, info)
                cache.note_cost(key, info)
                return out
        if mem:
            from ..observability import memory as _memtel
            out, minfo = _memtel.analyze(run, run_vals)
            _memtel.note_executable(cache.stat, key, minfo)
            cache.note_memory(key, minfo)
        else:
            out = run()
    if _OBS.COMPUTE:
        from ..observability import compute as _comptel
        _comptel.count_cached(cache, key, cache.stat)
    return out


# flush reasons that break the fusion window (each forfeits the step cache)
_WINDOW_BREAK_REASONS = frozenset(
    ("record_fallback", "segment_cap", "ambient_disable", "guard_error"))


def _obs_flush_span(reason: str, n_ops: int, n_inputs: int, n_live: int,
                    n_fast: int = 0):
    """Counters and the begun flush span (``donated`` stays 0: the port
    donates no input). Callers gate on ``_OBS.ACTIVE``."""
    if _OBS.METRICS:
        from ..observability import metrics
        metrics.inc("segment.flushes")
        # record_fallback:<op> collapses to one reason bucket
        head = reason.split(":", 1)[0]
        metrics.inc("segment.flush_reason." + head)
        if head in _WINDOW_BREAK_REASONS:
            metrics.inc("fusion.window_breaks")
            metrics.inc("fusion.window_breaks." + head)
        metrics.inc("segment.ops", n_ops)
        if n_fast:
            metrics.inc("record.fast_ops", n_fast)
    from ..observability.spans import span
    return span(f"segment::flush[{reason}]", hist="segment.flush_us",
                reason=reason, ops=n_ops, inputs=n_inputs,
                live=n_live, donated=0).begin()


def _obs_exec_span(compiled: bool, n_ops: int, driven: bool = False):
    """The build-vs-cached-execute split under a flush span; a whole-step
    replay takes its own ``segment::replay_step`` name (goodput prices it
    in the execute bucket)."""
    from ..observability.spans import span
    if driven and not compiled:
        return span("segment::replay_step",
                    hist="segment.replay_step_us", ops=n_ops).begin()
    return span("segment::compile" if compiled else "segment::execute",
                hist=("segment.compile_us" if compiled
                      else "segment.execute_us"), ops=n_ops).begin()


def _obs_flush_failed(reason: str, err: BaseException):
    """A failed flush: the flight recorder's post-mortem trigger."""
    if _OBS.FLIGHT:
        from ..observability import flight
        flight.on_error("flush_failed", f"reason={reason}: {err!r}")


def _oom_convert(e: BaseException, where: str, mem_info=None):
    """An out-of-memory error at an execute site becomes the typed
    ``base.core.ResourceExhaustedError`` carrying the memory postmortem;
    anything else passes through (the error path only)."""
    from ..observability import memory as _memtel
    if not _memtel.is_oom(e):
        return e
    return _memtel.on_oom(e, where, mem_info)


def _nan_scan_segment(pending, live, out_vals, kind, extra=None):
    """``FLAGS_check_nan_inf`` over a flushed segment's live outputs,
    naming the producing op with its record-time ``file:line``; ``extra``
    is an optional (label, values) pair swept after them (the fused step's
    gradients)."""
    for (j, _s), val in zip(live, out_vals):
        p = pending[j]
        src = getattr(p, "src", None)
        dispatch._check_nan_inf(
            f"{p.name} ({kind}" + (f" @ {src})" if src else ")"), (val,))
    if extra is not None:
        dispatch._check_nan_inf(extra[0], tuple(extra[1]))


def invalidate_skeletons(_value=None) -> int:
    """Bump the skeleton generation: every context drops its armed record
    skeleton at its next fast record (re-armed at the next memo-proven
    seal), and an armed whole-step drive retires at its next op."""
    global _FAST_GEN
    _FAST_GEN += 1
    _FAST_GEN_CELL[0] = _FAST_GEN
    return _FAST_GEN


def _sync_fast_path_gate(value):
    global _FAST_PATH
    _FAST_PATH = bool(value)
    invalidate_skeletons()


def _sync_step_replay_gate(value):
    global _STEP_REPLAY_AFTER
    _STEP_REPLAY_AFTER = int(value or 0)
    invalidate_skeletons()


# ---- hot-path flag gates, kept in step with set_flags by watchers
_LAZY_ENABLE = True
_EAGER_FUSION = False
_MAX_SEG_OPS = 256
ASYNC_FLUSH_ACTIVE = False
_GUARDS_OPEN = 0           # lazy_guards open in any thread
_GATE_LOCK = threading.Lock()


def _sync_gate():
    """dispatch.apply asks for a context only while a window may exist."""
    dispatch.LAZY_GATE = _LAZY_ENABLE and (_EAGER_FUSION or _GUARDS_OPEN > 0)


def _set_lazy_enable(v):
    global _LAZY_ENABLE
    _LAZY_ENABLE = bool(v)
    _drive_retire()
    _sync_gate()


def _set_eager_fusion(v):
    global _EAGER_FUSION
    _EAGER_FUSION = bool(v)
    _drive_retire()
    _sync_gate()
    if not _EAGER_FUSION:
        # land the calling thread's ambient segment now and retire it:
        # dispatch is strictly per-op again (other threads' ambient
        # values land at their first read)
        tls = _TLS
        ctx, tls.ambient = tls.ambient, None
        if ctx is not None:
            ctx.flush("ambient_disable")


def _set_max_seg_ops(v):
    global _MAX_SEG_OPS
    _MAX_SEG_OPS = int(v)
    invalidate_skeletons()


def _set_async(v):
    global ASYNC_FLUSH_ACTIVE
    ASYNC_FLUSH_ACTIVE = bool(v)


# flush reasons eligible for the async pipeline: seals where the recording
# thread runs ahead (the cap mid-record, the end of a guard)
_ASYNC_REASONS = frozenset(("segment_cap", "guard_exit"))
# set the first time a segment is flushed asynchronously; gates the
# pending-value resolution scans so the synchronous path never pays them
_ASYNC_SEEN = False


# --------------------------------------------------------------- keys

def _const_key(v, _depth=0):
    """A hashable, exact key for a constant argument or attr; None when
    there is none (the metadata of such a call is not cached). Floats key
    by their bits, so -0.0 and 0.0 (equal, same hash) stay apart."""
    t = type(v)
    if t is float:
        return ("f", struct.pack("<d", v))
    if v is None or t in (bool, int, str, bytes):
        return (t.__name__, v)
    if t in (tuple, list) and _depth < 4:
        parts = [_const_key(x, _depth + 1) for x in v]
        if any(p is None for p in parts):
            return None
        return (t.__name__, tuple(parts))
    if isinstance(v, torch.dtype):
        return ("dtype", v)
    if isinstance(v, torch.device):
        return ("device", str(v))
    if isinstance(v, slice):
        parts = (_const_key(v.start), _const_key(v.stop), _const_key(v.step))
        return None if any(p is None for p in parts) else ("slice", parts)
    if v is Ellipsis:
        return ("ellipsis",)
    if isinstance(v, np.ndarray) and v.size <= 4096:
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return ("np", np.dtype(type(v)).str, v.tobytes())
    if isinstance(v, dict) and _depth < 4:
        items = [(k, _const_key(x, _depth + 1)) for k, x in v.items()]
        if any(p is None for _, p in items):
            return None
        try:
            return ("dict", tuple(sorted(items)))
        except TypeError:
            return None
    if isinstance(v, DType):
        return ("DType", v.name)
    if callable(v) and getattr(v, "__closure__", None) is None:
        return ("fn", v)   # a module-level function or builtin, by identity
    return None


def _sig_const(v):
    """A constant's part of the structural signature: its exact key where
    it has one, else its type (the runner plan does not depend on it)."""
    k = _const_key(v)
    return ("obj", type(v).__name__) if k is None else k


# per-op signature entries interned by content: steady-state memo
# validation compares tuples of identical entry objects. Past 65536
# entries the pool is cleared: identity compares degrade to tuple
# equality until repopulation, never correctness.
_SIG_ENTRY_INTERN: Dict[Tuple, Tuple] = {}


def _native_core():
    """The native prong, resolved once (``_NC``; None: the Python prong):
    the extension's classes, pools and the driver's cells are bound here."""
    global _NC, _NC_TRIED, _DRIVE_OK
    _NC_TRIED = True
    from . import native
    ec = native.get_eager_core()
    if ec is None:
        return None
    from ..amp.auto_cast import _STATE, state_key
    from .tensor import Tensor
    ec.bind_types(LazyRef, Tensor, _PendingOp, torch.Tensor, torch.dtype,
                  torch.is_grad_enabled, _SIG_ENTRY_INTERN, dispatch,
                  _STATE, state_key, sys.modules[__name__])
    _DRIVE_OK = bool(ec.bind_drive(_DriveState, _FAST_GEN_CELL, _DRIVE_CELL))
    if _DRIVE_OK:
        dispatch.NC_DRIVE = ec.drive_record
    _NC = ec
    return ec


def _intern_sig_entry(entry: Tuple) -> Tuple:
    nc = _NC if _NC_TRIED else _native_core()
    if nc is not None:
        return nc.sig_entry(entry)
    e = _SIG_ENTRY_INTERN.setdefault(entry, entry)
    if len(_SIG_ENTRY_INTERN) > 65536:
        _SIG_ENTRY_INTERN.clear()
    return e


def _attrs_key(attrs):
    """The sorted (name, constant key) tuple of an op's attrs, or None."""
    nc = _NC if _NC_TRIED else _native_core()
    if nc is not None:
        akey = nc.attrs_key(attrs)
        if akey is not None:
            return akey
    try:
        return tuple(sorted((k, _const_key(v)) for k, v in attrs.items()))
    except TypeError:
        return None


def _meta_of(v) -> Tuple:
    """(shape, dtype, device, requires_grad) of a payload (a torch tensor
    or a deferred value)."""
    return (tuple(v.shape), v.dtype, v.device, bool(v.requires_grad))


def _in_signature(in_vals) -> Tuple:
    return tuple(_meta_of(v) for v in in_vals)


# --------------------------------------------------------------- values

class _Deferred:
    """A payload whose value is not there yet: the duck-typed metadata of
    a ``torch.Tensor`` (``shape``, ``dtype``, ``device``,
    ``requires_grad``, ...), answered from what was recorded, and
    ``materialize(tensor)``, which produces the value and binds it into
    ``tensor``. ``Tensor._t`` calls it; metadata reads never do."""

    __slots__ = ()

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def grad_fn(self):
        # an op's grad-requiring output is no leaf; the node itself exists
        # once the segment ran
        return _PENDING_NODE if self.requires_grad else None

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point


class _PendingNode:
    """``grad_fn`` of a pending grad-requiring value (not a leaf)."""

    def __repr__(self):
        return "<pending segment node>"


_PENDING_NODE = _PendingNode()


class LazyRef(_Deferred):
    """Placeholder payload for one output of one pending op."""

    _is_lazy_ref = True
    __slots__ = ("ctx", "op_idx", "slot", "shape", "dtype", "device",
                 "requires_grad", "trefs", "__weakref__")

    def __init__(self, ctx, op_idx, slot, meta):
        self.ctx = ctx
        self.op_idx = op_idx
        self.slot = slot
        self.shape, self.dtype, self.device, self.requires_grad = meta
        self.trefs: List = []         # weakrefs to Tensors aliasing this

    @property
    def meta(self) -> Tuple:
        return (self.shape, self.dtype, self.device, self.requires_grad)

    def add_tref(self, tensor):
        self.trefs.append(weakref.ref(tensor))

    def materialize(self, tensor):
        self.ctx.flush("materialize")
        p = tensor._payload
        if p is self:
            raise RuntimeError("lazy value was not bound by its segment")
        return p


# the deferred payload classes Tensor._t lands (async_flush adds its own)
DEFERRED = {LazyRef}


def _live_aliases(ref: LazyRef):
    """Tensors whose payload is still ``ref``: a tensor overwritten in
    place mid-segment no longer keeps its old pending output alive, and
    must not be clobbered when the segment's results are bound."""
    return [t for t in (r() for r in ref.trefs)
            if t is not None and t._payload is ref]


def _lazy_tensor(ref: LazyRef):
    from .tensor import Tensor
    t = Tensor.__new__(Tensor)
    t._payload = ref
    t.name = None
    t.persistable = False
    ref.add_tref(t)
    return t


class _PendingOp:
    # src: the record-time call site, captured while the compute plane is
    # on (unset on ops the native prong records)
    __slots__ = ("name", "fn", "attrs", "kvals", "wiring", "out_refs",
                 "n_outs", "multi", "grad", "amp", "amp_key", "req", "src")

    def __init__(self, name, fn, attrs, kvals, wiring, out_refs, multi,
                 grad, amp, amp_key, req, src=None):
        self.name = name
        self.fn = fn
        self.attrs = attrs
        self.kvals = kvals            # per input: the constant, or None
        # per input: ("in", i) | ("op", j, s) | None (a constant)
        self.wiring = wiring
        self.out_refs = out_refs
        self.n_outs = len(out_refs)
        self.multi = multi            # None: one tensor; tuple or list
        self.grad = grad              # grad mode at record time
        self.amp = amp                # AMP state at record time (or None)
        self.amp_key = amp_key
        self.req = req                # an input required grad, grad on
        self.src = src


def _record_src():
    """The call site of the op being recorded: the compute plane's op
    scope, and a NaN trip's message at the flush. Callers gate on
    ``_OBS.COMPUTE``. While the NaN scan is armed no op is recorded: each
    one dispatches alone (``dispatch.PER_OP_MODE``)."""
    from ..analysis.hooks import call_site
    return call_site()


class _ScopedOp:
    """A recorded op whose call runs inside its op scope, the compute
    plane's ``<op>[<file>:<line>]`` profiler range: what a runner built
    under the plane executes in place of the ``_PendingOp``."""

    __slots__ = ("name", "kvals", "amp", "grad", "attrs", "multi",
                 "n_outs", "fn")

    def __init__(self, pop, scope):
        self.name, self.kvals, self.amp = pop.name, pop.kvals, pop.amp
        self.grad, self.attrs = pop.grad, pop.attrs
        self.multi, self.n_outs = pop.multi, pop.n_outs
        fn = pop.fn

        def scoped(*args, **attrs):
            with torch.profiler.record_function(scope):
                return fn(*args, **attrs)
        self.fn = scoped


def _amp_now():
    """(state, key) of the calling thread's AMP scope, or (None, None)."""
    if dispatch.AMP_HOOK is None:
        return None, None
    from ..amp.auto_cast import _STATE, state_key
    state = getattr(_STATE, "amp", None)
    if state is None or state[0] == "O0":
        return None, None
    return state, state_key()


# --------------------------------------------------------------- runners

class _SegmentRunner:
    """The built runner of one segment shape: a slot plan over the
    recorded ops. ``__call__(pending, in_vals)`` runs the ops of
    ``pending`` (the segment being flushed: its functions, attrs and
    constants) in order and returns the live outputs. Each intermediate is
    dropped after its last use, as eager code drops it."""

    # todo: (memory, compute) counts owed at the first execution, or None;
    # scopes: the op scopes of a runner built under the compute plane
    __slots__ = ("steps", "n_slots", "live_slots", "todo", "scopes")

    def __init__(self, pending, live):
        base, n = [], 0
        for pop in pending:
            base.append(n)
            n += pop.n_outs
        last_use: Dict[int, int] = {}
        for j, pop in enumerate(pending):
            for w in pop.wiring:
                if w is not None and w[0] == "op":
                    last_use[base[w[1]] + w[2]] = j
        live_slots = tuple(base[j] + s for j, s in live)
        keep = set(live_slots)
        # each output not returned is dropped after its last use, or at
        # once when nothing reads it
        frees: Dict[int, List[int]] = {}
        for j, pop in enumerate(pending):
            for s in range(pop.n_outs):
                slot = base[j] + s
                if slot not in keep:
                    frees.setdefault(last_use.get(slot, j), []).append(slot)
        steps = []
        for j, pop in enumerate(pending):
            recipe = tuple(
                (2, k) if w is None else
                (0, w[1]) if w[0] == "in" else (1, base[w[1]] + w[2])
                for k, w in enumerate(pop.wiring))
            steps.append((recipe, base[j], tuple(frees.get(j, ()))))
        self.steps = tuple(steps)
        self.n_slots = n
        self.live_slots = live_slots
        self.todo = None
        self.scopes = None
        if _OBS.COMPUTE:
            from ..observability.compute import scope_name
            self.scopes = tuple(scope_name(pop.name, getattr(pop, "src",
                                                             None))
                                for pop in pending)

    def __call__(self, pending, in_vals):
        from ..amp.auto_cast import cast_with
        if self.scopes is not None and _OBS.COMPUTE:
            pending = [_ScopedOp(pop, scope)
                       for pop, scope in zip(pending, self.scopes)]
        vals: List[Any] = [None] * self.n_slots
        prev = torch.is_grad_enabled()
        cur = prev
        set_grad = torch._C._set_grad_enabled
        try:
            for pop, (recipe, base, frees) in zip(pending, self.steps):
                kv = pop.kvals
                args = [in_vals[i] if kind == 0 else
                        vals[i] if kind == 1 else kv[i]
                        for kind, i in recipe]
                if pop.amp is not None:
                    args = cast_with(pop.amp, pop.name, args)
                if pop.grad is not cur:
                    set_grad(pop.grad)
                    cur = pop.grad
                out = pop.fn(*args, **pop.attrs)
                if pop.multi is None:
                    vals[base] = out
                else:
                    vals[base:base + pop.n_outs] = out
                for s in frees:
                    vals[s] = None
        finally:
            if cur is not prev:
                set_grad(prev)
        return [vals[s] for s in self.live_slots]


def _build_segment_fn(pending, live):
    return _SegmentRunner(pending, live)


class _FusedRunner:
    """Forward of the segment and ``torch.autograd.backward`` of its
    scalar root, as one runner call (the reference's step cache)."""

    __slots__ = ("fwd", "root_k", "todo")

    def __init__(self, pending, live, root_k):
        self.fwd = _build_segment_fn(pending, live)
        self.root_k = root_k
        self.todo = None

    def __call__(self, pending, in_vals):
        outs = self.fwd(pending, in_vals)
        torch.autograd.backward([outs[self.root_k]])
        return outs


def _build_fused_fn(pending, live, root_k):
    return _FusedRunner(pending, live, root_k)


def _resolve(vals):
    from .async_flush import resolve_pending
    return resolve_pending(vals)


def _drain_async():
    """Wait for in-flight async segments before work that runs on this
    thread: a segment and eager code share the stream and the payloads
    written in place, so they must not interleave."""
    if _ASYNC_SEEN:
        from . import async_flush
        async_flush.quiesce()


# --------------------------------------------------------------- skeleton

class _SkelOp:
    """One retained op of a sealed segment's skeleton: what the fast path
    needs to admit a position-matching record without re-deriving it."""

    __slots__ = ("name", "fn", "attrs", "kvals", "ckey", "wiring",
                 "out_metas", "multi", "grad", "amp_key", "req", "entry",
                 "n_outs")


class _Skeleton:
    """One sealed segment shape's op skeleton (armed once the signature
    memo proved the stream repeats). ``in_sig`` is the sealed segment's
    external-input metadata; ``streak`` counts consecutive fully replayed
    seals, and at ``FLAGS_step_replay_after`` the shape gets a ``plan``
    (live tuple, signature) that lets the seal skip the signature
    rebuild."""

    __slots__ = ("ops", "ctups", "in_sig", "gen", "streak", "plan")


def _consts_equal(a, b) -> bool:
    """Constant arguments equal by value and type (a float -0.0 is not
    0.0); anything but primitives compares by identity."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is y:
            continue
        tx = type(x)
        if tx is not type(y):
            return False
        if tx is float:
            if struct.pack("<d", x) != struct.pack("<d", y):
                return False
        elif tx in (int, bool, str):
            if x != y:
                return False
        else:
            kx = _const_key(x)
            if kx is None or kx != _const_key(y):
                return False
    return True


# --------------------------------------------------------------- driver

class _DriveState:
    """What ``drive_record`` reads and moves for each op of an armed step
    plan: the plan's skeleton ops (``ctups``) and sealed input metadata,
    the context's current segment lists (the objects the context holds; the
    driver appends to them), the skeleton generation, the segment cap, the
    owning thread and the cursor. Each driven op also advances the
    context's ``_skel_pos``, ``_fast_ops`` and ``ops_recorded`` and
    ``FAST_OPS``, as a fast record does: none of them is stale while the
    driver is armed."""

    __slots__ = ("ctx", "ctups", "in_sig", "in_ids", "in_tensors",
                 "in_vals", "in_pins", "pending", "sig_ops", "pinned",
                 "pos", "gen", "cap", "tid")


def _arm_drive(ctx, sk):
    """Hand the rest of ``ctx``'s segment to the native driver: called
    after a native fast record of a skeleton that has a step plan."""
    d = _DriveState()
    d.ctx = ctx
    d.ctups = sk.ctups
    d.in_sig = sk.in_sig
    d.in_ids = ctx._in_ids
    d.in_tensors = ctx._in_tensors
    d.in_vals = ctx._in_vals
    d.in_pins = ctx._in_pins
    d.pending = ctx.pending
    d.sig_ops = ctx._sig_ops
    d.pinned = ctx.on_flush is not None
    d.pos = ctx._skel_pos
    d.gen = sk.gen
    cap = ctx._max_override
    d.cap = _MAX_SEG_OPS if cap is None else cap
    d.tid = threading.get_ident()
    _DRIVE_CELL[0] = d


def _drive_retire(ctx=None):
    """Retire an armed drive (``ctx``'s, or any): where the context
    replaces the lists the driver appends to or drops its skeleton (seal,
    reset, an in-place swap), and where what an op does changes (a guard
    opens or closes, the window is switched, tracing suspends it)."""
    d = _DRIVE_CELL[0]
    if d is not None and (ctx is None or d.ctx is ctx):
        _DRIVE_CELL[0] = None


# --------------------------------------------------------------- context

class CaptureContext:
    """One lazy trace. Ops recorded since the last flush form the current
    segment; ``flush()`` runs it as one runner call."""

    on_flush = None  # observer hook (jit/sot records the segment)

    def __init__(self, max_segment_ops: Optional[int] = None):
        self.pending: List[_PendingOp] = []
        # external inputs of the current segment: id(tensor) -> index,
        # valid while the tensor still holds the registered payload
        self._in_ids: Dict[int, int] = {}
        # weak refs to the input tensors (a tensor dying mid-segment is not
        # pinned; its payload snapshot in _in_vals is all the run needs);
        # _in_pins pins them under an on_flush observer (SOT rebinds them)
        self._in_tensors: List = []
        self._in_pins: List = []
        self._in_vals: List = []
        self._sig_ops: List[Tuple] = []
        self._max_override = max_segment_ops
        self._sig_memos: Dict[Any, Tuple] = {}
        self._skels: Dict[Any, Dict[Tuple, _Skeleton]] = {}
        self._skeleton: Optional[_Skeleton] = None
        self._skel_pos = 0
        self._skel_live = False
        self._fast_ops = 0
        self.segments_run = 0
        self.ops_recorded = 0
        self.breaks: List[str] = []
        self._driven = False

    # ---------------------------------------------------------- recording
    def _input_index(self, tensor, payload) -> int:
        idx = self._in_ids.get(id(tensor))
        if idx is not None and self._in_vals[idx] is payload \
                and self._in_tensors[idx]() is tensor:
            return idx
        idx = len(self._in_vals)
        self._in_ids[id(tensor)] = idx
        self._in_tensors.append(weakref.ref(tensor))
        if self.on_flush is not None:
            self._in_pins.append(tensor)
        self._in_vals.append(payload)
        return idx

    def note_inplace(self, tensor):
        """``tensor``'s payload is being swapped. Ops already recorded keep
        the registered snapshot (eager ordering); later records register
        the fresh payload. A swap mid-segment also drops the record
        skeleton: the input stream is re-keyed under the replay."""
        _drive_retire(self)
        self._in_ids.pop(id(tensor), None)
        if self.pending:
            sk = self._skeleton
            self._skeleton = None
            self._skel_live = False
            if sk is not None:
                for key in list(self._skels):
                    bucket = self._skels[key]
                    for k in [k for k, v in bucket.items() if v is sk]:
                        del bucket[k]
                    if not bucket:
                        del self._skels[key]

    def _select_skel(self, name):
        bucket = self._skels.get(name)
        while bucket:
            k = next(reversed(bucket))
            sk = bucket[k]
            if sk.gen == _FAST_GEN:
                self._skeleton = sk
                return sk
            del bucket[k]
        if bucket is not None:
            del self._skels[name]
        self._skel_live = False
        return None

    def _switch_skel(self, name):
        """The selected skeleton mismatched at the cursor: a sibling shape
        with the same leading op may continue the stream when its replayed
        prefix is exactly what this segment recorded."""
        sk = self._skeleton
        pos = self._skel_pos
        if sk is None or not sk.ops:
            return None
        bucket = self._skels.get(sk.ops[0].name)
        if not bucket:
            return None
        n_reg = len(self._in_vals)
        for k in list(reversed(bucket)):
            c = bucket[k]
            if c is sk or c.gen != _FAST_GEN or pos >= len(c.ops):
                continue
            if c.ops[pos].name != name:
                continue
            if c.in_sig[:n_reg] != sk.in_sig[:n_reg]:
                continue
            if any(c.ops[i].entry != sk.ops[i].entry
                   or c.ops[i].out_metas != sk.ops[i].out_metas
                   for i in range(pos)):
                continue
            del bucket[k]
            bucket[k] = c
            self._skeleton = c
            return c
        return None

    def _record_fast(self, name, fn, inputs, attrs):
        """Skeleton replay: admit this record by matching the armed
        skeleton position for position. Returns the outputs, or None on
        any mismatch (nothing mutated; the full record path runs)."""
        global FAST_OPS
        from .tensor import Tensor
        sk = self._skeleton
        if sk is None:
            sk = self._select_skel(name)
        pos = self._skel_pos
        if sk is None or sk.gen != _FAST_GEN or pos >= len(sk.ops):
            self._skel_live = False
            if sk is not None and sk.gen != _FAST_GEN:
                self._skeleton = None
            return None
        s = sk.ops[pos]
        if s.name != name or s.fn is not fn or len(inputs) != len(s.wiring):
            self._skel_live = False
            return None
        try:
            if attrs != s.attrs:
                self._skel_live = False
                return None
        except (ValueError, RuntimeError, TypeError):
            # an array attr where the armed shape held primitives: a plain
            # mismatch, not an uncapturable op
            self._skel_live = False
            return None
        grad = torch.is_grad_enabled()
        amp, amp_key = _amp_now()
        if grad is not s.grad or amp_key != s.amp_key:
            self._skel_live = False
            return None
        in_ids = self._in_ids
        in_vals = self._in_vals
        n_in = len(in_vals)
        in_sig = sk.in_sig
        new_ext = None
        kvals = []
        req = False
        for x, w in zip(inputs, s.wiring):
            if w is None:
                if isinstance(x, (Tensor, torch.Tensor)):
                    self._skel_live = False
                    return None
                kvals.append(x)
                continue
            kvals.append(None)
            if isinstance(x, Tensor):
                p = x._payload
                if type(p) is LazyRef:
                    if p.ctx is not self or w[0] != "op" \
                            or w[1] != p.op_idx or w[2] != p.slot:
                        self._skel_live = False
                        return None
                    req = req or p.requires_grad
                    continue
            elif isinstance(x, torch.Tensor):
                p = x
            else:
                self._skel_live = False
                return None
            if w[0] != "in":
                self._skel_live = False
                return None
            idx = in_ids.get(id(x))
            if idx is not None and in_vals[idx] is not p:
                idx = None
            if idx is None and new_ext is not None:
                for k, (t, q) in enumerate(new_ext):
                    if t is x and q is p:
                        idx = n_in + k
                        break
            if idx is None:
                idx = n_in + (0 if new_ext is None else len(new_ext))
                if idx >= len(in_sig) or _meta_of(p) != in_sig[idx]:
                    self._skel_live = False
                    return None
                if new_ext is None:
                    new_ext = []
                new_ext.append((x, p))
            if w[1] != idx:
                self._skel_live = False
                return None
            req = req or bool(p.requires_grad)
        if not _consts_equal(kvals, s.kvals):
            self._skel_live = False
            return None
        if (req and grad) != s.req:
            self._skel_live = False
            return None
        # ---- commit (nothing above mutated the context)
        if new_ext is not None:
            for x, p in new_ext:
                self._input_index(x, p)
        op_idx = len(self.pending)
        out_refs = [LazyRef(self, op_idx, k, m)
                    for k, m in enumerate(s.out_metas)]
        outs = [_lazy_tensor(r) for r in out_refs]
        self.pending.append(_PendingOp(
            name, fn, attrs, kvals, s.wiring, out_refs, s.multi, grad, amp,
            amp_key, s.req, _record_src() if _OBS.COMPUTE else None))
        self._sig_ops.append(s.entry)
        self._skel_pos = pos + 1
        self.ops_recorded += 1
        self._fast_ops += 1
        FAST_OPS += 1
        return outs[0] if s.multi is None else s.multi(outs)

    def _record_native(self, name, fn, inputs, attrs):
        """``_record_fast`` in one call of the native core; where C cannot
        judge an op (``NotImplemented``) the Python fast path does."""
        sk = self._skeleton
        if sk is None:
            sk = self._select_skel(name)
        if sk is None or sk.gen != _FAST_GEN or self._skel_pos >= len(sk.ops):
            self._skel_live = False
            if sk is not None and sk.gen != _FAST_GEN:
                self._skeleton = None
            return None
        outs = _NC.skel_record(self, sk.ctups, sk.in_sig, name, fn, inputs,
                               attrs)
        if outs is NotImplemented:
            return self._record_fast(name, fn, inputs, attrs)
        if outs is None:
            self._skel_live = False
        return outs

    def _build_skeleton(self, in_sig):
        ops = []
        for pop, entry in zip(self.pending, self._sig_ops):
            s = _SkelOp()
            s.name = pop.name
            s.fn = pop.fn
            s.attrs = pop.attrs
            s.kvals = pop.kvals
            s.wiring = pop.wiring
            s.out_metas = tuple(r.meta for r in pop.out_refs)
            s.multi = pop.multi
            s.grad = pop.grad
            s.amp_key = pop.amp_key
            s.req = pop.req
            s.entry = entry
            s.n_outs = pop.n_outs
            ops.append(s)
        sk = _Skeleton()
        sk.ops = ops
        sk.ctups = [(s.name, s.fn, s.attrs, tuple(s.kvals), s.wiring,
                     s.out_metas, s.multi, s.grad, s.amp_key, s.req, s.entry)
                    for s in ops]
        sk.in_sig = in_sig
        sk.gen = _FAST_GEN
        sk.streak = 0
        sk.plan = None
        self._skeleton = sk
        name0 = self.pending[0].name
        bucket = self._skels.get(name0)
        if bucket is None:
            if len(self._skels) > 8:
                self._skels.clear()
            bucket = self._skels[name0] = {}
        bkey = (len(ops), self._sig_ops[-1])
        bucket.pop(bkey, None)
        if len(bucket) > 4:
            bucket.clear()
        bucket[bkey] = sk

    def record(self, name, fn, inputs, attrs):
        """Record one op application; returns its lazy output(s), or
        ``dispatch.NOT_RECORDED`` when the op cannot be recorded (the
        window was flushed; the caller runs it eagerly)."""
        if self._skel_live and _FAST_PATH:
            nc = _NC if _NC_TRIED else _native_core()
            if _OBS.COMPUTE:
                # a call site is demanded for each op: the native prong
                # records none, so the Python one takes the fast path
                nc = None
            fast = self._record_fast if nc is None else self._record_native
            outs = fast(name, fn, inputs, attrs)
            if outs is None and self._skeleton is not None \
                    and self._switch_skel(name) is not None:
                self._skel_live = True
                outs = fast(name, fn, inputs, attrs)
            if outs is not None:
                sk = self._skeleton
                if nc is not None and _DRIVE_OK and sk.plan is not None \
                        and _DRIVE_CELL[0] is None \
                        and self._skel_pos < len(sk.ops):
                    _arm_drive(self, sk)
                return outs
        from .tensor import Tensor
        grad = torch.is_grad_enabled()
        amp, amp_key = _amp_now()

        # pass 1: resolve metadata without mutating the input record, so a
        # failing inference leaves no ghost inputs behind
        resolved = []
        metas = []
        kvals = []
        ckeys = []
        req = False
        for x in inputs:
            if isinstance(x, Tensor):
                p = x._payload
                if type(p) is LazyRef:
                    if p.ctx is self:
                        resolved.append(("op", p.op_idx, p.slot))
                        metas.append(p.meta)
                        kvals.append(None)
                        ckeys.append(None)
                        req = req or p.requires_grad
                        continue
                    p = x._t   # a lazy value of another context: land it
                resolved.append(("ext", x, p))
            elif isinstance(x, torch.Tensor):
                p = x
                resolved.append(("ext", x, p))
            else:
                resolved.append(None)
                metas.append(None)
                kvals.append(x)
                ckeys.append(_const_key(x))
                continue
            m = _meta_of(p)
            metas.append(m)
            kvals.append(None)
            ckeys.append(None)
            req = req or m[3]
        akey = _attrs_key(attrs)
        try:
            out_metas, multi = _out_metas(name, fn, attrs, akey, kvals,
                                          ckeys, metas, grad, amp, amp_key)
        except Exception:   # uncapturable: land the window, run eagerly
            self.flush("record_fallback:" + name)
            return dispatch.NOT_RECORDED

        # pass 2 (cannot fail): register external inputs, build the wiring
        wiring = []
        for r in resolved:
            if r is None:
                wiring.append(None)
            elif r[0] == "ext":
                wiring.append(("in", self._input_index(r[1], r[2])))
            else:
                wiring.append(r)
        wiring = tuple(wiring)
        op_idx = len(self.pending)
        out_refs = [LazyRef(self, op_idx, k, m)
                    for k, m in enumerate(out_metas)]
        outs = [_lazy_tensor(r) for r in out_refs]
        self.pending.append(_PendingOp(name, fn, dict(attrs), kvals, wiring,
                                       out_refs, multi, grad, amp, amp_key,
                                       req and grad,
                                       _record_src() if _OBS.COMPUTE
                                       else None))
        entry = _intern_sig_entry((
            name, akey if akey is not None else ("obj",),
            wiring, tuple(None if w is not None else
                          (c if c is not None else _sig_const(v))
                          for w, c, v in zip(wiring, ckeys, kvals)),
            len(out_refs), grad, amp_key))
        self._sig_ops.append(entry)
        self.ops_recorded += 1
        return outs[0] if multi is None else multi(outs)

    def maybe_cap_flush(self):
        cap = self._max_override
        if cap is None:
            cap = _MAX_SEG_OPS
        if len(self.pending) >= cap:
            self.flush("segment_cap")

    def _reset_segment(self):
        _drive_retire(self)
        self.pending = []
        self._in_ids = {}
        self._in_tensors = []
        self._in_pins = []
        self._in_vals = []
        self._sig_ops = []
        self._skel_pos = 0
        self._skeleton = None
        self._skel_live = bool(self._skels) and _FAST_PATH
        self._fast_ops = 0

    def _live_outputs(self, pending):
        live: List[Tuple[int, int]] = []
        live_refs: List[LazyRef] = []
        for j, pop in enumerate(pending):
            for ref in pop.out_refs:
                if _live_aliases(ref):
                    live.append((j, ref.slot))
                    live_refs.append(ref)
        return live, live_refs

    def _signature(self, in_vals, live) -> Tuple:
        ops_key = tuple(self._sig_ops)
        sk = self._skeleton
        full_replay = sk is not None and self._skel_live \
            and self._skel_pos == len(sk.ops) \
            and len(in_vals) == len(sk.in_sig)
        in_sig = sk.in_sig if full_replay else _in_signature(in_vals)
        live_t = tuple(live)
        key0 = (self._sig_ops[0], len(self._sig_ops), self._sig_ops[-1])
        memo = self._sig_memos.get(key0)
        if memo is not None and memo[0] == ops_key and memo[1] == in_sig \
                and memo[2] == live_t and memo[3][3] == MESH_EPOCH:
            # the memo just proved this segment shape repeats: arm (or
            # refresh) its skeleton, unless the segment fully replayed it;
            # a full clean replay advances the promotion streak
            if _FAST_PATH and (sk is None or sk.gen != _FAST_GEN
                               or not full_replay):
                self._build_skeleton(memo[1])
            elif sk is not None and sk.gen == _FAST_GEN and full_replay:
                sk.streak += 1
                if sk.plan is None and _STEP_REPLAY_AFTER \
                        and sk.streak >= _STEP_REPLAY_AFTER:
                    sk.plan = (memo[2], memo[3])
            return memo[3]
        # structural drift for this shape: drop its banked skeleton
        bucket = self._skels.get(self.pending[0].name)
        if bucket is not None:
            bucket.pop((len(self._sig_ops), self._sig_ops[-1]), None)
            if not bucket:
                del self._skels[self.pending[0].name]
        self._skeleton = None
        key = (ops_key, in_sig, live_t, MESH_EPOCH)
        if len(self._sig_memos) > 8:
            self._sig_memos.clear()
        memo = (ops_key, in_sig, live_t, key)
        self._sig_memos[key0] = memo
        return key

    def _step_plan_sig(self, live):
        """Whole-step replay admission at seal time: the signature of a
        fully replayed promoted shape whose live set matches its plan, or
        None (a live-set mismatch demotes the shape)."""
        global REPLAY_STEPS
        sk = self._skeleton
        if sk is None or sk.plan is None or not self._skel_live \
                or self._skel_pos != len(sk.ops) \
                or len(self._in_vals) != len(sk.in_sig):
            return None
        plan_live, plan_key = sk.plan
        if sk.gen != _FAST_GEN or tuple(live) != plan_live:
            sk.streak = 0
            sk.plan = None
            return None
        REPLAY_STEPS += 1
        if _OBS.METRICS:
            from ..observability import metrics
            metrics.inc("segment.replay_steps")
        return plan_key

    def _seal(self):
        """(pending, in_vals, in_tensors, live, live_refs, sig) of the
        current segment; ``_driven`` says whether a step plan gave the
        signature."""
        _drive_retire(self)
        pending = self.pending
        in_vals = self._in_vals
        in_tensors = [r() for r in self._in_tensors]
        live, live_refs = self._live_outputs(pending)
        sig = self._step_plan_sig(live)
        self._driven = sig is not None
        if sig is None:
            sig = self._signature(in_vals, live)
        return pending, in_vals, in_tensors, live, live_refs, sig

    # ------------------------------------------------------------- flush
    def flush(self, reason: str = "materialize"):
        if not self.pending:
            self._reset_segment()
            return
        n_fast = self._fast_ops
        pending, in_vals, in_tensors, live, live_refs, sig = self._seal()
        if ASYNC_FLUSH_ACTIVE and reason in _ASYNC_REASONS:
            self._flush_async(reason, pending, in_vals, in_tensors, live,
                              live_refs, sig)
            return
        _drain_async()
        fspan = _obs_flush_span(reason, len(pending), len(in_vals),
                                len(live), n_fast) \
            if _OBS.ACTIVE else None
        dispatch.bump_exec()
        xspan = None
        try:
            run_vals = _resolve(in_vals) if _ASYNC_SEEN else in_vals
            runner, xspan = _build(
                _SEG_CACHE, sig, lambda: _build_segment_fn(pending, live),
                fspan, len(pending), self._driven)
            if _flags.FAULT_INJECT_ACTIVE:
                _inject("exec::oom")
            out_vals = _execute(_SEG_CACHE, sig, runner, pending, run_vals)
            if xspan is not None:
                xspan.end()
        except BaseException as e:
            # a failed run must not pin inputs or poison later records:
            # drop the trace and surface the error (the outputs re-raise
            # on read). Spans end before the flight dump, so the report
            # holds the failing flush.
            self._reset_segment()
            if xspan is not None:
                xspan.end(error=e)
            if fspan is not None:
                fspan.end(error=e)
            _obs_flush_failed(reason, e)
            oe = _oom_convert(e, f"segment::flush[{reason}]",
                              _SEG_CACHE.memory_info(sig))
            if oe is not e:
                raise oe from e
            raise
        self._reset_segment()
        self.breaks.append(reason)
        self.segments_run += 1
        try:
            out_tensors = _bind(live_refs, out_vals)
            if _OBS.MEM:
                from ..observability import memory as _memtel
                _memtel.note_segment_outputs(pending, live, out_vals, sig)
            if _flags.NAN_CHECK_ACTIVE:
                _nan_scan_segment(pending, live, out_vals,
                                  "lazy segment output")
            if self.on_flush is not None:
                self.on_flush(self, reason, pending, live, live_refs,
                              in_tensors, in_vals, sig, out_tensors)
        except Exception as e:
            if fspan is not None:
                fspan.end(error=e)
            _obs_flush_failed(reason, e)
            raise
        if fspan is not None:
            fspan.end()

    def _flush_async(self, reason, pending, in_vals, in_tensors, live,
                     live_refs, sig):
        """Seal the segment and hand it to the flush executor: every live
        alias gets a ``PendingValue``; the worker runs the segment on the
        recording thread's device and stream and fills them."""
        global _ASYNC_SEEN
        from .async_flush import PendingValue, get_executor
        pvs = [PendingValue(ref.meta) for ref in live_refs]
        out_tensors = _bind(live_refs, pvs)
        stream = None
        dev = next((v.device for v in in_vals if v.device.type == "cuda"),
                   None) or next((r.device for r in live_refs
                                  if r.device.type == "cuda"), None)
        if dev is not None:
            stream = torch.cuda.current_stream(dev)

        def job(pending=pending, live=live, sig=sig, in_vals=in_vals):
            try:
                if stream is not None:
                    with torch.cuda.device(stream.device), \
                            torch.cuda.stream(stream):
                        out_vals = _run_job(pending, live, sig, in_vals,
                                            reason)
                else:
                    out_vals = _run_job(pending, live, sig, in_vals, reason)
            except BaseException as e:
                for pv in pvs:
                    pv._fail(e)
                raise
            for pv, val in zip(pvs, out_vals):
                pv._fill(val)
            if _OBS.MEM:
                from ..observability import memory as _memtel
                _memtel.note_segment_outputs(pending, live, out_vals, sig)

        dispatch.bump_exec()
        get_executor().submit(job)
        _ASYNC_SEEN = True
        self._reset_segment()
        self.breaks.append(reason)
        self.segments_run += 1
        if self.on_flush is not None:
            self.on_flush(self, reason, pending, live, live_refs,
                          in_tensors, in_vals, sig, out_tensors)


def _run_job(pending, live, sig, in_vals, reason="segment_cap"):
    """The async worker's flush: its spans land on the worker's lane (the
    goodput ledger keeps them off the partition) and an out-of-memory
    error is latched typed, so the sync point raises
    ``ResourceExhaustedError``."""
    fspan = _obs_flush_span(reason, len(pending), len(in_vals), len(live)) \
        if _OBS.ACTIVE else None
    xspan = None
    try:
        run_vals = _resolve(in_vals)
        runner, xspan = _build(
            _SEG_CACHE, sig, lambda: _build_segment_fn(pending, live),
            fspan, len(pending))
        if _flags.FAULT_INJECT_ACTIVE:
            _inject("exec::oom")
        out_vals = _execute(_SEG_CACHE, sig, runner, pending, run_vals)
    except BaseException as e:
        if xspan is not None:
            xspan.end(error=e)
        if fspan is not None:
            fspan.end(error=e)
        _obs_flush_failed(reason, e)
        oe = _oom_convert(e, f"segment::flush[{reason}] (async)",
                          _SEG_CACHE.memory_info(sig))
        if oe is not e:
            raise oe from e
        raise
    if xspan is not None:
        xspan.end()
    if fspan is not None:
        fspan.end()
    return out_vals


def _bind(live_refs, out_vals):
    """Binds each live output's value into its aliases; returns one alias
    per output (a grad-requiring one where there is one)."""
    out_tensors = []
    for ref, val in zip(live_refs, out_vals):
        ts = _live_aliases(ref)
        for t in ts:
            t._payload = val
        grad_ts = [t for t in ts if not t.stop_gradient]
        out_tensors.append(grad_ts[0] if grad_ts else (ts[0] if ts else None))
    return out_tensors


def _out_metas(name, fn, attrs, akey, kvals, ckeys, metas, grad, amp,
               amp_key):
    """Output metadata of one op call: ``((meta, ...), multi)`` from
    ``_AVAL_CACHE``, or by running ``fn`` once on meta tensors. The key
    holds ``fn`` by id and the entry a weak reference to it (checked on a
    hit), so a cached closure never keeps what it captured alive."""
    key = None
    nc = _NC if _NC_TRIED else _native_core()
    if akey is not None and all(c is not None for c, m in zip(ckeys, metas)
                                if m is None):
        try:
            key = (name, id(fn), akey, tuple(ckeys), tuple(metas), grad,
                   amp_key)
            if nc is not None:
                hit = nc.meta_get(name, fn, akey, key[3], key[4], grad,
                                  amp_key)
                if hit is not None:
                    return hit
            else:
                hash(key)
        except TypeError:
            key = None
    if key is not None and nc is None:
        hit = _AVAL_CACHE.get(key)
        if hit is not None and (hit[0] is None or hit[0]() is fn):
            return hit[1]
    dev = None
    args = []
    for v, m in zip(kvals, metas):
        if m is None:
            args.append(v)
            continue
        shape, dtype, device, rg = m
        if dev is None or (dev.type == "cpu" and device.type != "cpu"):
            dev = device
        t = torch.empty(shape, dtype=dtype, device="meta")
        if rg and (dtype.is_floating_point or dtype.is_complex):
            t.requires_grad_(True)
        args.append(t)
    if amp is not None:
        from ..amp.auto_cast import cast_with
        args = cast_with(amp, name, args)
    with torch.set_grad_enabled(grad):
        out = fn(*args, **attrs)
    if isinstance(out, torch.Tensor):
        outs, multi = (out,), None
    elif isinstance(out, (tuple, list)) and out and all(
            isinstance(o, torch.Tensor) for o in out):
        outs, multi = tuple(out), type(out)
    else:
        raise TypeError(f"op {name}: output {type(out).__name__} is not "
                        "a tensor or a sequence of tensors")
    metas_out = []
    for o in outs:
        if o.device.type != "meta":
            raise TypeError(f"op {name} made a tensor on {o.device} "
                            "at record time")
        metas_out.append((tuple(o.shape), o.dtype,
                          dev if dev is not None else torch.device("cpu"),
                          bool(o.requires_grad)))
    res = (tuple(metas_out), multi)
    if key is not None and nc is not None:
        nc.meta_put(name, fn, akey, key[3], key[4], grad, amp_key, res,
                    _flags.flag_value("FLAGS_executable_cache_capacity"))
    elif key is not None:
        try:
            fn_ref = weakref.ref(fn)
        except TypeError:   # a method descriptor: as long-lived as torch
            fn_ref = None
        _AVAL_CACHE[key] = (fn_ref, res)
    return res


# --------------------------------------------------------------- replay

class ReplayableSegment:
    """A captured segment that runs directly on fresh input tensors: the
    compiled body of SOT's guarded fast path. Its ops are traced once with
    ``make_fx`` and compiled by ``jit.api.compile_traced`` (inductor on the
    card, ``aot_eager`` on the CPU; the traced graph persists under
    ``FLAGS_executable_cache_dir``), so a kernel op stays one
    ``torch.library`` node of the graph; replay skips recording."""

    def __init__(self, pending, live, in_vals):
        self.pending = pending
        self.live = live
        self.in_metas = tuple((tuple(v.shape), v.dtype, v.device)
                              for v in in_vals)
        self._compiled = None
        self.graphs: List = []

    def _runner(self, in_vals):
        if self._compiled is None:
            from ..jit.api import compile_traced
            runner = _build_segment_fn(self.pending, self.live)
            pending = self.pending

            def body(*vals):
                return tuple(runner(pending, list(vals)))
            self._compiled = compile_traced(
                body, list(in_vals), None, self.graphs,
                persist_key=self._persist_key())
        return self._compiled

    def _persist_key(self):
        """The segment's ops and live outputs: what names its trace across
        processes (``_core/persist.py`` refuses one holding a value its
        repr does not show, such as an array an op body closes over)."""
        return ("sot", tuple((p.name, p.fn, p.attrs, tuple(p.kvals),
                              p.wiring, p.multi, p.grad, p.amp_key)
                             for p in self.pending), tuple(self.live))

    def run(self, in_tensors):
        from .tensor import Tensor
        in_vals = [t._t for t in in_tensors]
        got = tuple((tuple(v.shape), v.dtype, v.device) for v in in_vals)
        if got != self.in_metas:
            raise _ReplayMismatch("input metadata changed")
        built = self._compiled is None
        if built and _OBS.METRICS:
            from ..observability import metrics
            metrics.inc("compiles.segment")
        compiled = self._runner(in_vals)
        dispatch.bump_exec()
        xspan = _obs_exec_span(built, len(self.pending)) \
            if _OBS.ACTIVE else None
        try:
            out_vals = compiled(*in_vals)
        except Exception as e:
            if xspan is not None:
                xspan.end(error=e)
            raise
        if xspan is not None:
            xspan.end()
        if _flags.NAN_CHECK_ACTIVE:
            _nan_scan_segment(self.pending, self.live, out_vals,
                              "replayed segment output")
        if _OBS.MEM:
            from ..observability import memory as _memtel
            _memtel.note_segment_outputs(self.pending, self.live, out_vals)
        return [Tensor(v) for v in out_vals]


class _ReplayMismatch(Exception):
    pass


# --------------------------------------------------------------- threads
# Capture state is per thread: two threads recording at once must never
# interleave one segment's wiring (a loader thread slicing batches while
# the main thread records the model), as each thread has its own stream
# order in the reference.

class _ThreadState(threading.local):
    def __init__(self):
        self.active: List[CaptureContext] = []   # explicit lazy_guards
        self.ambient: Optional[CaptureContext] = None
        self.suspend = 0                          # open `suspended` blocks


_TLS = _ThreadState()

# every open context, across threads: note_inplace evicts a swapped
# payload from all of them
_ALL_CTXS = weakref.WeakSet()
_ALL_CTXS_LOCK = threading.Lock()


def _track_ctx(ctx: CaptureContext):
    with _ALL_CTXS_LOCK:
        _ALL_CTXS.add(ctx)


def current_context() -> Optional[CaptureContext]:
    tls = _TLS
    if not _LAZY_ENABLE or tls.suspend:
        return None
    if tls.active:
        return tls.active[-1]
    if _EAGER_FUSION:
        if tls.ambient is None:
            tls.ambient = CaptureContext()
            _track_ctx(tls.ambient)
        return tls.ambient
    if tls.ambient is not None:
        ctx, tls.ambient = tls.ambient, None
        ctx.flush("ambient_disable")
    return None


class suspended:
    """No window records on this thread inside the block: ``make_fx``
    tracing (``jit.api.compile_traced``) runs the eager API over fake
    tensors, and those calls must reach the tracer, not a segment."""

    def __enter__(self):
        _drive_retire()
        _TLS.suspend += 1

    def __exit__(self, *exc):
        _TLS.suspend -= 1
        return False


def flush_active(reason: str = "materialize"):
    """Land the calling thread's pending segment."""
    tls = _TLS
    for ctx in ([tls.ambient] if tls.ambient is not None else []) \
            + tls.active:
        ctx.flush(reason)


def enable_eager_fusion(enable: bool = True) -> Optional[CaptureContext]:
    """Toggle the ambient fusion window (``FLAGS_eager_fusion``, off by
    default in the port). With it on, plain dygraph code records into an
    ambient segment that runs at the next sync point; turning it off
    flushes what is pending and restores per-op dispatch. Returns the
    calling thread's ambient context when enabling."""
    _flags.set_flags({"FLAGS_eager_fusion": enable})
    return current_context() if not _TLS.active else _TLS.ambient


def eager_fusion_enabled() -> bool:
    return bool(_flags.flag_value("FLAGS_eager_fusion"))


def note_inplace(tensor):
    """Evict ``tensor``'s input registration from every open context, any
    thread (``Tensor``'s payload setter calls it)."""
    with _ALL_CTXS_LOCK:
        ctxs = list(_ALL_CTXS)
    for ctx in ctxs:
        ctx.note_inplace(tensor)


def try_fused_backward(tensors, grad_tensors) -> bool:
    """Whole-step fusion: ``backward()`` on a scalar root still pending in
    the calling thread's window runs the segment's forward and its
    backward as one runner call (``_FUSED_CACHE``, one execution). Returns
    False, leaving everything as it was, when the generic path must run:
    several roots or a seed gradient, another grad-requiring output still
    alive, or gradients that flow beyond the segment (an input that
    requires grad and is no leaf, or has hooks)."""
    from .tensor import Tensor
    ctx = current_context()
    if ctx is None or not ctx.pending or ctx.on_flush is not None:
        return False
    if len(tensors) != 1 or not isinstance(tensors[0], Tensor):
        return False
    if grad_tensors and any(g is not None for g in grad_tensors):
        return False
    root = tensors[0]
    p = root._payload
    if type(p) is not LazyRef or p.ctx is not ctx or not p.requires_grad \
            or p.numel() != 1:
        return False
    live, live_refs = ctx._live_outputs(ctx.pending)
    root_k = None
    for k, ref in enumerate(live_refs):
        if ref is p:
            root_k = k
        elif ref.requires_grad:
            return False
    if root_k is None:
        return False
    any_leaf = False
    for v in ctx._in_vals:
        if not v.requires_grad:
            continue
        if isinstance(v, _Deferred) or v.grad_fn is not None \
                or getattr(v, "_backward_hooks", None):
            return False
        any_leaf = True
    if not any_leaf:
        return False
    n_fast = ctx._fast_ops
    pending, in_vals, _, live, live_refs, sig = ctx._seal()
    key = (sig, root_k)
    _drain_async()
    fspan = _obs_flush_span("backward_fused", len(pending), len(in_vals),
                            len(live), n_fast) \
        if _OBS.ACTIVE else None
    dispatch.bump_exec()
    xspan = None
    try:
        run_vals = _resolve(in_vals) if _ASYNC_SEEN else in_vals
        runner, xspan = _build(
            _FUSED_CACHE, key, lambda: _build_fused_fn(pending, live, root_k),
            fspan, len(pending), ctx._driven)
        if _flags.FAULT_INJECT_ACTIVE:
            _inject("exec::oom")
        out_vals = _execute(_FUSED_CACHE, key, runner, pending, run_vals)
        if xspan is not None:
            xspan.end()
        if _flags.NAN_CHECK_ACTIVE:
            _nan_scan_segment(
                pending, live, out_vals, "fused-step output",
                extra=("fused-step gradients",
                       [v.grad for v in in_vals
                        if v.requires_grad and v.grad is not None]))
    except BaseException as e:
        ctx._reset_segment()
        if xspan is not None:
            xspan.end(error=e)
        if fspan is not None:
            fspan.end(error=e)
        _obs_flush_failed("backward_fused", e)
        oe = _oom_convert(e, "backward_fused", _FUSED_CACHE.memory_info(key))
        if oe is not e:
            raise oe from e
        raise
    ctx._reset_segment()
    ctx.breaks.append("backward_fused")
    ctx.segments_run += 1
    _bind(live_refs, out_vals)
    if _OBS.MEM:
        from ..observability import memory as _memtel
        _memtel.note_segment_outputs(pending, live, out_vals, sig)
        for v in in_vals:
            if v.requires_grad and v.grad is not None:
                _memtel.note_buffer(v.grad, "fused_step.grad")
    if fspan is not None:
        fspan.end()
    return True


class lazy_guard:
    """Context manager enabling the lazy fusion window::

        with paddle.framework.lazy_guard() as ctx:
            ... eager code; ops record into segments ...
        # leaving flushes everything pending
    """

    def __init__(self, max_segment_ops: Optional[int] = None):
        self._max = max_segment_ops
        self.ctx: Optional[CaptureContext] = None
        self._active = False

    def __enter__(self) -> CaptureContext:
        global _GUARDS_OPEN
        _drive_retire()
        self.ctx = CaptureContext(self._max)
        if _flags.flag_value("FLAGS_lazy_enable"):
            _TLS.active.append(self.ctx)
            _track_ctx(self.ctx)
            with _GATE_LOCK:
                _GUARDS_OPEN += 1
                _sync_gate()
            self._active = True
        return self.ctx

    def __exit__(self, et, ev, tb):
        global _GUARDS_OPEN
        if not self._active:
            return False
        _drive_retire()
        _TLS.active.pop()
        with _GATE_LOCK:
            _GUARDS_OPEN -= 1
            _sync_gate()
        if et is None:
            self.ctx.flush("guard_exit")
        else:
            # error path: still land what was recorded (eager would have
            # those values); a secondary failure is not raised over the
            # user's error
            try:
                self.ctx.flush("guard_error")
            except Exception:
                self.ctx._reset_segment()
        return False


def segment_cache_size() -> int:
    return len(_SEG_CACHE)


def metadata_cache_size() -> int:
    """Entries of the record-time metadata cache of the prong in use."""
    if _NC is not None:
        return _NC.intern_sizes()["meta_cache"]
    return len(_AVAL_CACHE)


def clear_segment_cache():
    _SEG_CACHE.clear()
    _FUSED_CACHE.clear()
    _AVAL_CACHE.clear()
    if _NC is not None:
        _NC.meta_clear()


_flags.watch_flag("FLAGS_lazy_enable", _set_lazy_enable)
_flags.watch_flag("FLAGS_eager_fusion", _set_eager_fusion)
_flags.watch_flag("FLAGS_lazy_max_segment_ops", _set_max_seg_ops)
_flags.watch_flag("FLAGS_async_flush", _set_async)
_flags.watch_flag("FLAGS_record_fast_path", _sync_fast_path_gate)
_flags.watch_flag("FLAGS_step_replay_after", _sync_step_replay_gate)
dispatch.LAZY_CONTEXT = current_context
