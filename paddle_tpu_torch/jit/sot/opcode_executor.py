"""Symbolic bytecode executor: the counterpart of
``paddle_tpu/jit/sot/opcode_executor.py`` (the reference Paddle's
opcode_executor.py:1880).

CPython 3.12 bytecode is interpreted instruction by instruction against
tracked values:

- the port's Tensors flow through untouched: their ops are recorded by
  the lazy window (``_core/lazy.py``) the executor runs under;
- guardable Python primitives read from the call's roots are wrapped in
  ``Tracked`` so every value the capture specialized on gets a guard;
- other objects reached from the roots ride in ``TrackedObj`` so
  attribute chains (self.linear, cfg.n_heads) stay re-fetchable;
- calls are inlined (recursive symbolic execution) for plain user
  functions, and run natively for framework, torch and builtin
  callables: native execution still records tensor ops, so an
  un-inlinable call is not a graph break, just an untracked region;
- unsupported constructs found by a static prescan (generators,
  try/except, ``with``, closures that create cells) raise ``SotFallback``
  before any side effect, and the caller runs the frame natively under
  the same capture. A fallback met while running (the step budget, an
  unsupported operator) is taken only while the session has written
  nothing outside the frame (an attribute, a global or an item of an
  outside container): the native run would write it again. The step
  budget is not enforced after such a write (the frame runs on in the
  interpreter, as it would natively), and any other fallback after it
  raises ``SotSideEffectError``.

The session's product: a ``GuardSet`` and the capture's segment
structure, from which ``SotFunction`` builds a guarded fast path when the
capture was clean (one segment, no tensor-data branch, no external
mutation): ``lazy.ReplayableSegment``, the segment traced with ``make_fx``
and compiled by ``jit.api.compile_traced`` (inductor on the card,
``aot_eager`` on the CPU, each kernel one ``torch.library`` node).

Only the 3.12 dialect is ported (the card's machine and the CPU tests
both run 3.12): on another Python version every frame falls back to
native execution under the capture. The reference's 3.10 dialect
(``CALL_FUNCTION*``, ``LOAD_METHOD``, per-op ``BINARY_*``, ``ROT_*``) is
left out, as is its sanitizer sweep of installed entries. While a
telemetry plane is on, the guard evaluation runs in a ``sot::guard_eval``
span, and ``sot.fast_hits``, ``sot.replay_mismatches``,
``sot.guard_misses`` and ``sot.captures`` are counted, as the reference
counts them.
"""
from __future__ import annotations

import dis
import functools
import inspect
import operator
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

# the one bytecode dialect interpreted (see the module docstring)
_PY312 = sys.version_info[:2] == (3, 12)

from ..._core import lazy
from ..._core import random as _rng
from ..._core.dtype import DType
from ..._core.tensor import Tensor
from ...amp.auto_cast import state_key as amp_state_key
from ...observability import _state as _OBS
from .guards import Guard, GuardSet, Source, is_guardable_value


class SotFallback(Exception):
    """Frame cannot be symbolically executed; run it natively."""


class SotSideEffectError(RuntimeError):
    """A frame fell back after writing outside state: running it natively
    would repeat the write."""


class _ReplayMismatch(Exception):
    pass


_NULL = object()          # CPython's NULL stack sentinel
_UNBOUND = object()       # LOAD_FAST_AND_CLEAR's empty slot


class Tracked:
    """A guardable Python primitive + the root sources it derives from."""
    __slots__ = ("value", "leaves")

    def __init__(self, value, leaves: frozenset):
        self.value = value
        self.leaves = leaves

    def __repr__(self):
        return f"Tracked({self.value!r})"


class TrackedObj:
    """A non-primitive object reachable from the roots via one source."""
    __slots__ = ("value", "source")

    def __init__(self, value, source: Source):
        self.value = value
        self.source = source

    def __repr__(self):
        return f"TrackedObj({type(self.value).__name__}@{self.source!r})"


def uv(x):
    """Unwrap a stack value to the real Python object."""
    if isinstance(x, (Tracked, TrackedObj)):
        return x.value
    return x


def _leaves(*xs) -> frozenset:
    out = frozenset()
    for x in xs:
        if isinstance(x, Tracked):
            out |= x.leaves
    return out


# --------------------------------------------------------------- prescan

_SUPPORTED = {
    "RESUME", "NOP", "CACHE", "EXTENDED_ARG", "COPY_FREE_VARS",
    "PUSH_NULL", "POP_TOP",
    "COPY", "SWAP", "LOAD_CONST", "LOAD_FAST", "LOAD_FAST_CHECK",
    "LOAD_FAST_AND_CLEAR", "STORE_FAST", "DELETE_FAST", "LOAD_GLOBAL",
    "STORE_GLOBAL", "LOAD_DEREF", "LOAD_ATTR", "STORE_ATTR",
    "BINARY_OP", "COMPARE_OP", "IS_OP", "CONTAINS_OP", "UNARY_NOT",
    "UNARY_NEGATIVE", "UNARY_INVERT", "CALL_INTRINSIC_1",
    "BINARY_SUBSCR", "STORE_SUBSCR", "DELETE_SUBSCR", "BINARY_SLICE",
    "STORE_SLICE", "BUILD_SLICE", "BUILD_TUPLE", "BUILD_LIST",
    "BUILD_MAP", "BUILD_SET", "BUILD_CONST_KEY_MAP", "BUILD_STRING",
    "LIST_EXTEND", "LIST_APPEND", "SET_ADD", "SET_UPDATE", "MAP_ADD",
    "DICT_UPDATE", "DICT_MERGE", "UNPACK_SEQUENCE", "UNPACK_EX",
    "FORMAT_VALUE", "GET_ITER", "FOR_ITER", "END_FOR", "GET_LEN",
    "JUMP_FORWARD", "JUMP_BACKWARD", "JUMP_BACKWARD_NO_INTERRUPT",
    "POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE", "POP_JUMP_IF_NONE",
    "POP_JUMP_IF_NOT_NONE", "RETURN_VALUE", "RETURN_CONST",
    "CALL", "KW_NAMES", "CALL_FUNCTION_EX", "MAKE_FUNCTION",
    "IMPORT_NAME", "IMPORT_FROM", "RAISE_VARARGS",
    "LOAD_ASSERTION_ERROR",
    # NOT supported (prescan must reject BEFORE any side effect runs):
    # LOAD_SUPER_ATTR, LOAD_BUILD_CLASS, exception handling, generators
}

# CALL_INTRINSIC_1 operands we can emulate
_INTRINSIC_1 = {}
try:
    for _i, _d in enumerate(dis._intrinsic_1_descs):
        if _d == "INTRINSIC_UNARY_POSITIVE":
            _INTRINSIC_1[_i] = operator.pos
        elif _d == "INTRINSIC_LIST_TO_TUPLE":
            _INTRINSIC_1[_i] = tuple
except Exception:
    pass

_NB_TABLE = []
for _name, _sym in getattr(dis, "_nb_ops", []):
    key = _name[3:].lower()          # NB_ADD -> add
    inplace = key.startswith("inplace_")
    base = key[8:] if inplace else key
    fn = {
        "add": operator.add, "and": operator.and_,
        "floor_divide": operator.floordiv, "lshift": operator.lshift,
        "matrix_multiply": operator.matmul, "multiply": operator.mul,
        "remainder": operator.mod, "or": operator.or_,
        "power": operator.pow, "rshift": operator.rshift,
        "subtract": operator.sub, "true_divide": operator.truediv,
        "xor": operator.xor,
    }.get(base)
    ifn = {
        "add": operator.iadd, "and": operator.iand,
        "floor_divide": operator.ifloordiv, "lshift": operator.ilshift,
        "matrix_multiply": operator.imatmul, "multiply": operator.imul,
        "remainder": operator.imod, "or": operator.ior,
        "power": operator.ipow, "rshift": operator.irshift,
        "subtract": operator.isub, "true_divide": operator.itruediv,
        "xor": operator.ixor,
    }.get(base)
    _NB_TABLE.append(ifn if inplace else fn)


_NO_FALLTHROUGH = {"RETURN_VALUE", "RETURN_CONST", "RAISE_VARARGS",
                   "RERAISE", "JUMP_FORWARD", "JUMP_BACKWARD",
                   "JUMP_BACKWARD_NO_INTERRUPT"}
_JUMPS = {"JUMP_FORWARD", "JUMP_BACKWARD", "JUMP_BACKWARD_NO_INTERRUPT",
          "POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE", "POP_JUMP_IF_NONE",
          "POP_JUMP_IF_NOT_NONE", "FOR_ITER"}


def _reachable(instructions, off2idx):
    """Instruction indices reachable via NORMAL control flow (exception
    edges excluded — handler code is dead to this interpreter, which
    propagates exceptions instead of dispatching them)."""
    seen = set()
    work = [0]
    while work:
        i = work.pop()
        if i in seen or i >= len(instructions):
            continue
        seen.add(i)
        ins = instructions[i]
        if ins.opname in _JUMPS:
            work.append(off2idx[ins.argval])
        if ins.opname not in _NO_FALLTHROUGH:
            work.append(i + 1)
    return seen


def prescan(code) -> Optional[str]:
    """Return a fallback reason, or None if the code is interpretable."""
    if not _PY312:
        return "bytecode dialect of Python %d.%d not ported" \
            % sys.version_info[:2]
    if code.co_flags & (inspect.CO_GENERATOR | inspect.CO_COROUTINE |
                        inspect.CO_ASYNC_GENERATOR):
        return "generator/coroutine"
    if "__class__" in code.co_freevars:
        # zero-arg super() needs the real frame's __class__ cell, which
        # a symbolic frame cannot provide (3.12 also rejects this via
        # the LOAD_SUPER_ATTR opcode)
        return "zero-arg super"
    if code.co_cellvars:
        # the cell machinery (MAKE_CELL/COPY_FREE_VARS rebinding) is not
        # emulated
        return "creates closure cells"
    instructions = list(dis.get_instructions(code))
    off2idx = {ins.offset: i for i, ins in enumerate(instructions)}
    # a handler that CATCHES (PUSH_EXC_INFO) needs exception dispatch we
    # don't do; cleanup-only handlers (PEP 709 comprehensions) just
    # re-raise, and propagating past them is equivalent
    _parse_table = getattr(dis, "_parse_exception_table", None)
    if _parse_table is not None:
        try:
            for entry in _parse_table(code):
                tgt = instructions[off2idx[entry.target]]
                if tgt.opname == "PUSH_EXC_INFO":
                    return "try/except handler"
        except Exception:
            return "unparseable exception table"
    live = _reachable(instructions, off2idx)
    for i in sorted(live):
        ins = instructions[i]
        if ins.opname not in _SUPPORTED:
            return f"unsupported opcode {ins.opname}"
        if ins.opname == "MAKE_FUNCTION" and ins.arg and \
                (ins.arg & 0x08):
            return "MAKE_FUNCTION with closure"
        if ins.opname == "CALL_INTRINSIC_1" and \
                ins.arg not in _INTRINSIC_1:
            return f"intrinsic {ins.argrepr}"
        if ins.opname == "RAISE_VARARGS" and ins.arg == 0:
            return "bare raise"
    return None


# keyed by the code OBJECT (hashable, compared by value): id() keys
# could be reused after GC and hand a stale verdict to new code
_PRESCAN_CACHE: Dict[Any, Optional[str]] = {}


def prescan_cached(code) -> Optional[str]:
    if code not in _PRESCAN_CACHE:
        _PRESCAN_CACHE[code] = prescan(code)
    return _PRESCAN_CACHE[code]


# --------------------------------------------------------------- session

_NEVER_INLINE_PREFIXES = ("paddle_tpu_torch", "numpy", "builtins",
                          "functools", "typing", "collections", "torch")


class SotSession:
    """State shared across the frames of one capture."""

    def __init__(self, root_fn):
        self.root_fn = root_fn
        self.guards = GuardSet()
        self.tensor_sources: Dict[int, Source] = {}
        self.tensor_refs: Dict[int, Any] = {}   # id -> Tensor (strong)
        self.tensor_branch = False
        self.writes = 0     # writes to state outside the frames
        self.unguardable: Optional[str] = None
        self.fallback: Optional[str] = None
        self.created_ids = set()
        # one-element tensors built by a call into the port from guarded
        # values only, with no draw: the fast path may bind them as
        # constants
        self.guarded_scalars: Dict[int, Tensor] = {}
        # immutable values pushed by LOAD_CONST, and the values that came
        # out of a native call or were computed from one (these win where
        # an interned small int or a bool is both), by id; kept alive
        self.consts: Dict[int, Any] = {}
        self.opaque: Dict[int, Any] = {}
        self.flushes: List[Tuple] = []
        self.inlined = 0

    @property
    def mutated(self) -> bool:
        return self.writes > 0

    def guarded(self, x) -> bool:
        """Whether a stack value follows from the entry's guards and the
        frames' constants alone."""
        if id(x) in self.opaque:
            return False
        if isinstance(x, Tracked) or x is None:
            return True
        if isinstance(x, TrackedObj):
            if isinstance(x.value, _DTYPES):
                self.guards.add(x.source, "id", id(x.value))
                return True
            return False
        if isinstance(x, Tensor):
            return id(x) in self.guarded_scalars
        if isinstance(x, (list, tuple)):
            return all(self.guarded(v) for v in x)
        if isinstance(x, dict):
            return all(self.guarded(v) for v in x.values())
        return isinstance(x, _DTYPES) or id(x) in self.consts

    def taint(self, result, *operands):
        """Marks ``result`` opaque when an operand is."""
        if any(id(o) in self.opaque for o in operands):
            self.opaque[id(result)] = result
        return result

    def fallback_after_writes(self, since: int, err: SotFallback):
        """Raises ``SotSideEffectError`` if the session wrote outside
        state after its ``since``-th write: a native rerun of the frame
        would write again."""
        if self.writes > since:
            raise SotSideEffectError(
                f"SOT fell back ({err}) after the frame wrote outside "
                f"state; running it natively would repeat the write") \
                from err

    # lazy.CaptureContext on_flush observer. Accepts PENDING out
    # tensors: with FLAGS_async_flush on, guard-exit (and cap) seals
    # ride the async pipeline and the observed out/in payloads may be
    # in-flight PendingValues — _build_entry reads only avals and
    # payload identity, never concrete values, so entry construction
    # needs no sync point.
    def note_flush(self, ctx, reason, pending, live, live_refs,
                   in_tensors, in_vals, sig, out_tensors):
        self.flushes.append((reason, pending, live, live_refs,
                             in_tensors, in_vals, sig, out_tensors))

    def track_tensor(self, t: Tensor, source: Source):
        if id(t) not in self.tensor_sources:
            self.tensor_sources[id(t)] = source
            self.tensor_refs[id(t)] = t
            self.guards.add(source, "tensor_meta",
                            (tuple(t.shape), str(t.dtype),
                             t.stop_gradient))

    def wrap(self, value, source: Source):
        """Wrap a freshly-read root value per the tracking policy."""
        if isinstance(value, Tensor):
            self.track_tensor(value, source)
            return value
        if is_guardable_value(value):
            return Tracked(value, frozenset([source]))
        return TrackedObj(value, source)

    def guard_tracked(self, tr: Tracked):
        for src in tr.leaves:
            self.guards.add_value(src, src.evaluate(
                self.root_fn, self._root_args, self._root_kwargs))

    def deep_unwrap(self, x, guard=True):
        """Unwrap for native consumption; guard what specialization we
        bake in."""
        if isinstance(x, Tracked):
            if guard:
                self.guard_tracked(x)
            return x.value
        if isinstance(x, TrackedObj):
            return x.value
        if isinstance(x, list):
            return [self.deep_unwrap(v, guard) for v in x]
        if isinstance(x, tuple):
            return tuple(self.deep_unwrap(v, guard) for v in x)
        if isinstance(x, dict):
            return {k: self.deep_unwrap(v, guard) for k, v in x.items()}
        return x


# -------------------------------------------------------------- executor

class _Frame:
    __slots__ = ("code", "instructions", "off2idx", "stack", "locals",
                 "fn_for_globals", "fn_source", "kw_names")

    def __init__(self, code, local_vals, fn_for_globals, fn_source):
        self.code = code
        self.instructions = list(dis.get_instructions(code))
        self.off2idx = {ins.offset: i
                        for i, ins in enumerate(self.instructions)}
        self.stack: List[Any] = []
        self.locals: Dict[str, Any] = local_vals
        self.fn_for_globals = fn_for_globals
        self.fn_source = fn_source   # None for the root frame
        self.kw_names: Tuple[str, ...] = ()


def _flag(name):
    from ..._core.flags import flag_value
    return flag_value(name)


class OpcodeExecutor:
    def __init__(self, fn, args, kwargs, session: SotSession, depth=0):
        self.session = session
        self.depth = depth
        code = fn.__code__
        reason = prescan_cached(code)
        if reason is not None:
            raise SotFallback(reason)

        if depth == 0:
            session._root_args = args
            session._root_kwargs = kwargs
            # wrap root inputs with arg/kwarg sources
            wrapped_args = [session.wrap(a, Source("arg", None, i))
                            for i, a in enumerate(args)]
            wrapped_kwargs = {k: session.wrap(v, Source("kwarg", None, k))
                              for k, v in kwargs.items()}
            local_vals = inspect.getcallargs(fn, *wrapped_args,
                                             **wrapped_kwargs)
        else:
            local_vals = inspect.getcallargs(fn, *args, **kwargs)
        self.frame = _Frame(code, local_vals, fn, None)
        self.fn = fn

    # ------------------------------------------------------------ helpers
    def _global_source(self, name) -> Source:
        src = self.frame.fn_source
        if src is None:
            return Source("global", None, name)
        return Source("global2", src, name)

    def _deref_source(self, name) -> Source:
        src = self.frame.fn_source
        if src is None:
            return Source("closure", None, name)
        return Source("closure2", src, name)

    def _load_global(self, name):
        g = self.fn.__globals__
        if name in g:
            val = g[name]
        else:
            b = g.get("__builtins__", __builtins__)
            bd = b if isinstance(b, dict) else vars(b)
            if name not in bd:
                raise NameError(name)
            val = bd[name]
        return self.session.wrap(val, self._global_source(name))

    # --------------------------------------------------------------- run
    def run(self):
        f = self.frame
        s = self.session
        idx = 0
        steps = 0
        push = f.stack.append
        pop = f.stack.pop
        step_budget = _flag("FLAGS_sot_step_budget")

        while True:
            steps += 1
            # after a write outside the frame, a fallback would run the
            # write again natively: the frame then runs to its end here
            if steps > step_budget and not s.writes:
                raise SotFallback("step budget exceeded")
            ins = f.instructions[idx]
            op = ins.opname
            idx += 1

            if op in ("RESUME", "NOP", "CACHE", "EXTENDED_ARG",
                      "COPY_FREE_VARS"):
                continue

            elif op == "LOAD_CONST":
                v = ins.argval
                if isinstance(v, _CONST_TYPES):
                    s.consts[id(v)] = v
                push(v)
            elif op == "RETURN_CONST":
                return ins.argval
            elif op == "RETURN_VALUE":
                return pop()

            elif op in ("LOAD_FAST", "LOAD_FAST_CHECK"):
                name = ins.argval
                if name not in f.locals:
                    raise UnboundLocalError(name)
                push(f.locals[name])
            elif op == "LOAD_FAST_AND_CLEAR":
                push(f.locals.pop(ins.argval, _UNBOUND))
            elif op == "STORE_FAST":
                v = pop()
                if v is _UNBOUND:
                    f.locals.pop(ins.argval, None)
                else:
                    f.locals[ins.argval] = v
            elif op == "DELETE_FAST":
                f.locals.pop(ins.argval, None)

            elif op == "LOAD_GLOBAL":
                if ins.arg & 1:     # push NULL first
                    push(_NULL)
                push(self._load_global(ins.argval))
            elif op == "STORE_GLOBAL":
                self.fn.__globals__[ins.argval] = uv(pop())
                s.writes += 1
            elif op == "LOAD_DEREF":
                name = ins.argval
                if name in f.locals:
                    push(f.locals[name])
                else:
                    i = f.code.co_freevars.index(name)
                    val = self.fn.__closure__[i].cell_contents
                    push(s.wrap(val, self._deref_source(name)))

            elif op == "PUSH_NULL":
                push(_NULL)
            elif op == "POP_TOP":
                pop()
            elif op == "COPY":
                push(f.stack[-ins.arg])
            elif op == "SWAP":
                f.stack[-1], f.stack[-ins.arg] = \
                    f.stack[-ins.arg], f.stack[-1]

            elif op == "LOAD_ATTR":
                self._load_attr(ins)
            elif op == "STORE_ATTR":
                obj = pop()
                val = pop()
                real = uv(obj)
                setattr(real, ins.argval, s.deep_unwrap(val))
                if id(real) not in s.created_ids:
                    s.writes += 1

            elif op == "BINARY_OP":
                b = pop()
                a = pop()
                fn = _NB_TABLE[ins.arg]
                if fn is None:
                    raise SotFallback(f"binary op {ins.argrepr}")
                r = fn(uv(a), uv(b))
                push(self._rewrap(r, a, b))
            elif op == "COMPARE_OP":
                b = pop()
                a = pop()
                r = _COMPARES[ins.argval](uv(a), uv(b))
                push(self._rewrap(r, a, b))
            elif op == "IS_OP":
                b = pop()
                a = pop()
                r = (uv(a) is uv(b)) ^ bool(ins.arg)
                # `x is None` on a tracked value: record the None-ness,
                # not the exact value; identity tests on tracked OBJECTS
                # specialize on the object -> id guard
                for t in (a, b):
                    if isinstance(t, Tracked):
                        for src in t.leaves:
                            s.guards.add(src, "none", t.value is None)
                    elif isinstance(t, TrackedObj):
                        s.guards.add(t.source, "id", id(t.value))
                push(s.taint(r, a, b))
            elif op == "CONTAINS_OP":
                b = pop()
                a = pop()
                r = (uv(a) in uv(b)) ^ bool(ins.arg)
                push(self._rewrap(r, a, b))
            elif op == "UNARY_NOT":
                a = pop()
                push(self._rewrap(not uv(a), a))
            elif op == "UNARY_NEGATIVE":
                a = pop()
                push(self._rewrap(operator.neg(uv(a)), a))
            elif op == "UNARY_INVERT":
                a = pop()
                push(self._rewrap(operator.invert(uv(a)), a))
            elif op == "CALL_INTRINSIC_1":
                a = pop()
                push(_INTRINSIC_1[ins.arg](uv(a)))

            elif op == "BINARY_SUBSCR":
                k = pop()
                c = pop()
                push(self._subscr(c, k))
            elif op == "BINARY_SLICE":
                end = pop()
                start = pop()
                c = pop()
                push(uv(c)[slice(uv(start), uv(end))])
            elif op == "STORE_SLICE":
                end = pop()
                start = pop()
                c = pop()
                v = pop()
                real = uv(c)
                real[slice(uv(start), uv(end))] = s.deep_unwrap(v)
                if id(real) not in s.created_ids:
                    s.writes += 1
            elif op == "STORE_SUBSCR":
                k = pop()
                c = pop()
                v = pop()
                real = uv(c)
                if id(real) in s.created_ids:
                    real[uv(k)] = v       # frame-local container: keep
                else:                     # wrappers inside
                    real[uv(k)] = s.deep_unwrap(v)
                    s.writes += 1
            elif op == "DELETE_SUBSCR":
                k = pop()
                c = pop()
                real = uv(c)
                del real[uv(k)]
                if id(real) not in s.created_ids:
                    s.writes += 1

            elif op == "BUILD_SLICE":
                if ins.arg == 3:
                    step = pop()
                    stop = pop()
                    start = pop()
                    push(slice(uv(start), uv(stop), uv(step)))
                else:
                    stop = pop()
                    start = pop()
                    push(slice(uv(start), uv(stop)))
            elif op == "BUILD_TUPLE":
                vals = self._popn(ins.arg)
                push(tuple(vals))
            elif op == "BUILD_LIST":
                vals = self._popn(ins.arg)
                lst = list(vals)
                s.created_ids.add(id(lst))
                push(lst)
            elif op == "BUILD_SET":
                vals = self._popn(ins.arg)
                st = set(uv(v) for v in vals)
                s.created_ids.add(id(st))
                push(st)
            elif op == "BUILD_MAP":
                vals = self._popn(2 * ins.arg)
                d = {uv(vals[2 * i]): vals[2 * i + 1]
                     for i in range(ins.arg)}
                s.created_ids.add(id(d))
                push(d)
            elif op == "BUILD_CONST_KEY_MAP":
                keys = pop()
                vals = self._popn(ins.arg)
                d = dict(zip(keys, vals))
                s.created_ids.add(id(d))
                push(d)
            elif op == "BUILD_STRING":
                vals = self._popn(ins.arg)
                push("".join(uv(v) for v in vals))
            elif op == "FORMAT_VALUE":
                fmt = ""
                if ins.arg & 0x04:
                    fmt = uv(pop())
                v = uv(pop())
                conv = ins.arg & 0x03
                if conv == 1:
                    v = str(v)
                elif conv == 2:
                    v = repr(v)
                elif conv == 3:
                    v = ascii(v)
                push(format(v, fmt))
            elif op == "LIST_EXTEND":
                seq = pop()
                f.stack[-ins.arg].extend(
                    seq if not isinstance(seq, (Tracked, TrackedObj))
                    else uv(seq))
            elif op == "LIST_APPEND":
                v = pop()
                f.stack[-ins.arg].append(v)
            elif op == "SET_ADD":
                v = pop()
                f.stack[-ins.arg].add(uv(v))
            elif op == "SET_UPDATE":
                seq = pop()
                f.stack[-ins.arg].update(uv(seq))
            elif op == "MAP_ADD":
                v = pop()
                k = pop()
                f.stack[-ins.arg][uv(k)] = v
            elif op in ("DICT_UPDATE", "DICT_MERGE"):
                d = pop()
                f.stack[-ins.arg].update(uv(d))

            elif op == "UNPACK_SEQUENCE":
                seq = uv(pop())
                items = list(seq)
                if len(items) != ins.arg:
                    raise ValueError("unpack length mismatch")
                for item in reversed(items):
                    push(item)
            elif op == "UNPACK_EX":
                before = ins.arg & 0xFF
                after = ins.arg >> 8
                items = list(uv(pop()))
                starred = items[before:len(items) - after]
                rest = items[len(items) - after:]
                for item in reversed(rest):
                    push(item)
                push(starred)
                for item in reversed(items[:before]):
                    push(item)
            elif op == "GET_LEN":
                push(len(uv(f.stack[-1])))

            elif op == "GET_ITER":
                push(self._get_iter(pop()))
            elif op == "FOR_ITER":
                it = f.stack[-1]
                try:
                    push(next(it))
                except StopIteration:
                    push(_NULL)       # END_FOR pops the pair
                    idx = f.off2idx[ins.argval]
            elif op == "END_FOR":
                pop()
                pop()

            elif op == "JUMP_FORWARD" or op == "JUMP_BACKWARD" \
                    or op == "JUMP_BACKWARD_NO_INTERRUPT":
                idx = f.off2idx[ins.argval]
            elif op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE"):
                v = pop()
                cond = self._branch_bool(v)
                if cond == (op == "POP_JUMP_IF_TRUE"):
                    idx = f.off2idx[ins.argval]
            elif op in ("POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE"):
                v = pop()
                if isinstance(v, Tracked):
                    for src in v.leaves:
                        s.guards.add(src, "none", v.value is None)
                isnone = uv(v) is None
                if isnone == (op == "POP_JUMP_IF_NONE"):
                    idx = f.off2idx[ins.argval]

            elif op == "KW_NAMES":
                f.kw_names = ins.argval
            elif op == "CALL":
                self._call(ins.arg)
            elif op == "CALL_FUNCTION_EX":
                kw = uv(pop()) if ins.arg & 1 else {}
                posargs = uv(pop())
                callee = pop()
                # a NULL (or the bound self) sits under the callable
                if callee is _NULL:
                    callee = pop()
                else:
                    null = pop()
                    if null is not _NULL:
                        posargs = [null] + list(posargs)
                push(self._dispatch_call(callee, list(posargs), dict(kw)))
            elif op == "MAKE_FUNCTION":
                code = pop()
                closure = None      # closures are refused by the prescan
                if ins.arg & 0x04:
                    pop()                        # annotations
                kwdefaults = uv(pop()) if ins.arg & 0x02 else None
                defaults = uv(pop()) if ins.arg & 0x01 else None
                fnobj = types.FunctionType(
                    code, self.fn.__globals__, code.co_name,
                    tuple(self.session.deep_unwrap(defaults))
                    if defaults else None, closure)
                if kwdefaults:
                    fnobj.__kwdefaults__ = dict(kwdefaults)
                s.created_ids.add(id(fnobj))
                push(fnobj)

            elif op == "IMPORT_NAME":
                fromlist = uv(pop())
                level = uv(pop())
                push(__import__(ins.argval, self.fn.__globals__, None,
                               fromlist, level))
            elif op == "IMPORT_FROM":
                push(getattr(uv(f.stack[-1]), ins.argval))

            elif op == "LOAD_ASSERTION_ERROR":
                push(AssertionError)
            elif op == "RAISE_VARARGS":
                if ins.arg == 2:
                    cause = uv(pop())
                    exc = uv(pop())
                    raise exc from cause
                exc = uv(pop())
                raise exc if not isinstance(exc, type) else exc()

            else:
                raise SotFallback(f"unhandled opcode {op}")

    # ------------------------------------------------------ sub-handlers
    def _popn(self, n):
        if n == 0:
            return []
        f = self.frame
        vals = f.stack[-n:]
        del f.stack[-n:]
        return vals

    def _rewrap(self, result, *operands):
        # a tracked primitive flowing into tensor arithmetic becomes a
        # scalar graph input — specialize (guard) it, dynamo-style
        if any(isinstance(o, Tensor) for o in operands):
            for o in operands:
                if isinstance(o, Tracked):
                    self.session.guard_tracked(o)
        if is_guardable_value(result):
            lv = _leaves(*operands)
            if lv:
                result = Tracked(result, lv)
        return self.session.taint(result, *operands)

    def _subscr(self, c, k):
        s = self.session
        kr = uv(k)
        if isinstance(c, TrackedObj) and is_guardable_value(kr) \
                and not isinstance(kr, slice):
            try:
                val = c.value[kr]
            except Exception:
                raise
            if isinstance(k, Tracked):
                s.guard_tracked(k)
            return s.wrap(val, Source("item", c.source, kr))
        if isinstance(c, Tracked):
            s.guard_tracked(c)
        if isinstance(uv(c), Tensor) and isinstance(k, Tracked):
            s.guard_tracked(k)      # index specializes the gather
        return uv(c)[kr]

    def _load_attr(self, ins):
        f = self.frame
        s = self.session
        obj = f.stack.pop()
        name = ins.argval
        real = uv(obj)
        if ins.arg & 1:
            # method-call form: push (callable, self) or (NULL, attr)
            attr = getattr(real, name)
            if inspect.ismethod(attr) and attr.__self__ is real:
                f.stack.append(attr.__func__)
                f.stack.append(obj)
            else:
                f.stack.append(_NULL)
                f.stack.append(self._wrap_attr(obj, real, name, attr))
            return
        attr = getattr(real, name)
        f.stack.append(self._wrap_attr(obj, real, name, attr))

    def _wrap_attr(self, obj, real, name, attr):
        s = self.session
        if isinstance(obj, TrackedObj):
            return s.wrap(attr, Source("attr", obj.source, name))
        if isinstance(obj, Tracked):
            s.guard_tracked(obj)
        return attr

    def _get_iter(self, v):
        s = self.session
        real = uv(v)
        if isinstance(v, TrackedObj):
            if hasattr(real, "__getitem__") and hasattr(real, "__len__"):
                src = v.source
                # the unroll specializes on the length: guard it, or an
                # appended element would be silently skipped on replay
                s.guards.add(src, "len", len(real))
                return iter([s.wrap(real[i], Source("item", src, i))
                             for i in range(len(real))])
            s.unguardable = f"iterating {type(real).__name__}"
        if isinstance(v, Tracked):
            s.guard_tracked(v)
        return iter(real)

    def _branch_bool(self, v) -> bool:
        s = self.session
        if isinstance(v, Tensor):
            s.tensor_branch = True     # data-dependent: graph break
            return bool(v)
        if isinstance(v, Tracked):
            s.guard_tracked(v)
            return bool(v.value)
        if isinstance(v, TrackedObj):
            # object truthiness (len, custom __bool__) cannot be guarded
            # re-fetchably — refuse the fast path rather than replay a
            # stale branch direction
            s.unguardable = (f"truthiness of tracked "
                             f"{type(v.value).__name__}")
            return bool(v.value)
        return bool(v)

    def _call(self, argc):
        f = self.frame
        kw_names = f.kw_names
        f.kw_names = ()
        args = self._popn(argc)
        c1 = f.stack.pop()
        c2 = f.stack.pop()
        if c2 is _NULL:
            callee = c1
        else:
            callee = c2
            args = [c1] + args
        kwargs = {}
        if kw_names:
            n = len(kw_names)
            kwvals = args[-n:]
            args = args[:-n]
            kwargs = dict(zip(kw_names, kwvals))
        f.stack.append(self._dispatch_call(callee, args, kwargs))

    def _dispatch_call(self, callee, args, kwargs):
        s = self.session
        real = uv(callee)
        if isinstance(callee, TrackedObj):
            s.guards.add(callee.source, "id", id(real))
        if isinstance(callee, Tracked):
            s.guard_tracked(callee)

        target = real
        self_arg = None
        if inspect.ismethod(real):
            target = real.__func__
            self_arg = real.__self__

        writes = s.writes
        if isinstance(target, types.FunctionType) \
                and self.depth < _flag("FLAGS_sot_inline_depth") \
                and not str(getattr(target, "__module__", "") or "") \
                .startswith(_NEVER_INLINE_PREFIXES) \
                and prescan_cached(target.__code__) is None:
            try:
                call_args = ([self_arg] if self_arg is not None else []) \
                    + list(args)
                sub = OpcodeExecutor.__new__(OpcodeExecutor)
                sub.session = s
                sub.depth = self.depth + 1
                sub.fn = target
                local_vals = inspect.getcallargs(target, *call_args,
                                                 **kwargs)
                src = callee.source if isinstance(callee, TrackedObj) \
                    else None
                sub.frame = _Frame(target.__code__, local_vals, target,
                                   src)
                s.inlined += 1
                return sub.run()
            except SotFallback as e:
                s.fallback_after_writes(writes, e)
                # fall through to a native call

        a = [s.deep_unwrap(x) for x in args]
        kw = {k: s.deep_unwrap(v) for k, v in kwargs.items()}
        handed_out = _rng.handed_out()
        out = real(*a, **kw)
        if isinstance(out, _CONST_TYPES + _DTYPES):
            s.opaque[id(out)] = out
        elif isinstance(out, Tensor) and _is_scalar_const(out) \
                and _rng.handed_out() == handed_out \
                and str(getattr(target, "__module__", None) or "") \
                .startswith("paddle_tpu_torch"):
            operands = [*args, *kwargs.values()]
            if self_arg is not None:
                operands.append(self_arg)
            if operands and all(s.guarded(x) for x in operands):
                # the port built it from guarded values alone, drawing
                # nothing: a constant under the entry's guards
                s.guarded_scalars[id(out)] = out
        return out


_COMPARES = {
    "<": operator.lt, "<=": operator.le, "==": operator.eq,
    "!=": operator.ne, ">": operator.gt, ">=": operator.ge,
}


# ------------------------------------------------- guarded compiled entry

class _CacheEntry:
    """One guarded capture: either a compiled fast path (runner) or a
    marker that this function must be re-interpreted per call."""

    __slots__ = ("guards", "segment", "in_bindings", "grad_mask",
                 "out_tree", "out_specs", "hits", "grad_mode", "amp")

    def __init__(self, guards, segment, in_bindings, grad_mask,
                 out_tree, out_specs, grad_mode, amp):
        self.guards = guards
        self.segment = segment          # lazy.ReplayableSegment
        self.in_bindings = in_bindings  # ("source", src)|("tensor", t)
        self.grad_mask = grad_mask
        self.out_tree = out_tree
        self.out_specs = out_specs
        self.hits = 0
        # grad intent is baked into the compiled segment at capture; an
        # entry captured under no_grad must not serve a training call
        # (and vice versa) — the caller checks this like a guard
        self.grad_mode = grad_mode
        # so is the AMP rule (the casts are in the graph), as it is part
        # of to_static's cache key
        self.amp = amp

    def run(self, fn, args, kwargs):
        from ..._core.tensor import Tensor
        in_tensors = []
        for kind, val in self.in_bindings:
            if kind == "source":
                t = val.evaluate(fn, args, kwargs)
                if not isinstance(t, Tensor):
                    raise _ReplayMismatch("source no longer a tensor")
            else:
                t = val
            in_tensors.append(t)
        mask = tuple(t.stop_gradient for t in in_tensors)
        if mask != self.grad_mask:
            raise _ReplayMismatch("stop_gradient mask changed")
        outs = self.segment.run(in_tensors)
        leaves = []
        for kind, val in self.out_specs:
            if kind == "out":
                leaves.append(outs[val])
            elif kind == "in":
                leaves.append(in_tensors[val])
            elif kind == "src":
                leaves.append(val.evaluate(fn, args, kwargs))
            else:
                leaves.append(val)
        self.hits += 1
        return pytree.tree_unflatten(leaves, self.out_tree)


class SotFunction:
    """symbolic_translate(fn): guarded capture-and-replay wrapper."""

    def __init__(self, fn):
        self._callable = fn
        self._entries: List[_CacheEntry] = []
        self.stats = {"captures": 0, "fast_hits": 0, "fallbacks": [],
                      "breaks": [], "tensor_branches": 0, "inlined": 0}
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        fn = self._callable
        # sources address the FLAT call: for bound methods self is arg 0
        eval_args = (fn.__self__,) + args if inspect.ismethod(fn) \
            else args
        from ..._core.autograd import is_grad_enabled
        grad_now = is_grad_enabled()
        amp_now = amp_state_key()
        log = _flag("FLAGS_guard_log")
        gspan = None
        if _OBS.ACTIVE:
            from ...observability.spans import span
            gspan = span("sot::guard_eval", hist="sot.guard_eval_us",
                         fn=getattr(fn, "__name__", "?"),
                         entries=len(self._entries)).begin()
        guards_matched = False
        for entry in self._entries:
            if log:
                failed = [g for g in entry.guards
                          if not g.check(fn, eval_args, kwargs)]
                if failed:
                    print(f"[sot] {getattr(fn, '__name__', fn)}: "
                          f"guard miss {failed[:3]}")
            if entry.grad_mode == grad_now and entry.amp == amp_now \
                    and entry.guards.check_all(fn, eval_args, kwargs):
                guards_matched = True
                if gspan is not None:
                    gspan.end()
                try:
                    out = entry.run(fn, eval_args, kwargs)
                    self.stats["fast_hits"] += 1
                    if _OBS.METRICS:
                        from ...observability import metrics
                        metrics.inc("sot.fast_hits")
                    return out
                except (lazy._ReplayMismatch, _ReplayMismatch):
                    if _OBS.METRICS:
                        from ...observability import metrics
                        metrics.inc("sot.replay_mismatches")
                    continue
        if gspan is not None:
            gspan.end()
            if _OBS.METRICS:
                from ...observability import metrics
                # a replay mismatch after a guard pass is no guard miss
                if self._entries and not guards_matched:
                    metrics.inc("sot.guard_misses")
                metrics.inc("sot.captures")
        return self._capture(args, kwargs)

    # ------------------------------------------------------------ capture
    def _capture(self, args, kwargs):
        fn = self._callable
        session = SotSession(fn)
        session._root_args = args
        session._root_kwargs = kwargs

        target = fn
        call_args = args
        if inspect.ismethod(fn):
            target = fn.__func__
            call_args = (fn.__self__,) + args
        session.guards.add(Source("sig", None, None), "sig",
                           (len(call_args), tuple(sorted(kwargs))))

        with lazy.lazy_guard() as ctx:
            ctx.on_flush = session.note_flush
            try:
                if inspect.ismethod(fn):
                    # bind self as arg 0 with a re-fetchable source
                    session._root_args = call_args
                    ex = _executor_for_method(target, call_args, kwargs,
                                              session)
                else:
                    ex = OpcodeExecutor(target, call_args, kwargs,
                                        session)
                out = ex.run()
            except SotFallback as e:
                session.fallback_after_writes(0, e)
                session.fallback = str(e)
                out = fn(*args, **kwargs)
            else:
                # the interpreter's wrappers must not escape to the
                # caller; unwrapping GUARDS tracked python outputs so
                # the fast path can't replay a stale ("py", ...) value
                out = session.deep_unwrap(out)

        self.stats["captures"] += 1
        self.stats["inlined"] += session.inlined
        if session.fallback:
            self.stats["fallbacks"].append(session.fallback)
        if session.tensor_branch:
            self.stats["tensor_branches"] += 1
        self.stats["breaks"].append(
            [fl[0] for fl in session.flushes])

        entry = self._build_entry(session, out, args, kwargs)
        if entry is not None:
            cap = _flag("FLAGS_sot_cache_entries")
            while cap and len(self._entries) >= cap:  # 0 = unlimited
                self._entries.pop(0)
            self._entries.append(entry)
        return out

    def _build_entry(self, session, out, args, kwargs):
        if session.fallback or session.tensor_branch or session.mutated \
                or session.unguardable:
            return None
        if len(session.flushes) != 1:
            return None
        (reason, pending, live, live_refs, in_tensors, in_vals, sig,
         out_tensors) = session.flushes[0]
        if reason != "guard_exit" or not pending:
            return None
        if any(t is None for t in in_tensors):
            # an input tensor died during capture (lazy trace holds only
            # weakrefs) — there is nothing to rebind on replay
            return None

        # map materialized arrays back to segment slots / inputs
        out_ids = {}
        for k, t in enumerate(out_tensors):
            if t is not None:
                out_ids[id(t._payload)] = k
        in_arr_ids = {id(v): i for i, v in enumerate(in_vals)}

        leaves, tree = pytree.tree_flatten(out)
        specs = []
        for leaf in leaves:
            if isinstance(leaf, Tensor):
                pid = id(leaf._payload)
                if pid in out_ids:
                    specs.append(("out", out_ids[pid]))
                elif pid in in_arr_ids:
                    # passthrough of a graph input (identity/detach)
                    specs.append(("in", in_arr_ids[pid]))
                elif id(leaf) in session.tensor_sources:
                    # a root tensor returned without entering the graph
                    specs.append(("src", session.tensor_sources[id(leaf)]))
                else:
                    # unknown origin (e.g. host-constructed inside the
                    # call): replaying it as a constant would be unsound
                    return None
            else:
                specs.append(("py", uv(leaf)))

        bindings = []
        for t in in_tensors:
            src = session.tensor_sources.get(id(t))
            if src is not None:
                bindings.append(("source", src))
            elif t.persistable or id(t) in session.guarded_scalars:
                # long-lived state (params / persistable buffers) is
                # bound by object — .step() updates stay visible; tiny
                # scalar temps built from guarded values only are
                # constants under the entry's value guards
                bindings.append(("tensor", t))
            else:
                # an unsourced, non-persistent tensor (e.g. built from
                # host data inside the call): replaying it would be
                # unsound — no fast path
                return None

        from ..._core.autograd import is_grad_enabled
        segment = lazy.ReplayableSegment(pending, live, in_vals)
        return _CacheEntry(session.guards, segment, bindings,
                           tuple(t.stop_gradient for t in in_tensors),
                           tree, specs, is_grad_enabled(), amp_state_key())


# immutable constants whose value the code itself fixes
_CONST_TYPES = (bool, int, float, complex, str, bytes, tuple)
_DTYPES = (DType, torch.dtype)


def _is_scalar_const(t) -> bool:
    return t.stop_gradient and t.size == 1


def _executor_for_method(target, call_args, kwargs, session):
    ex = OpcodeExecutor.__new__(OpcodeExecutor)
    reason = prescan_cached(target.__code__)
    if reason is not None:
        raise SotFallback(reason)
    session._root_args = call_args
    session._root_kwargs = kwargs
    wrapped = [session.wrap(a, Source("arg", None, i))
               for i, a in enumerate(call_args)]
    wkw = {k: session.wrap(v, Source("kwarg", None, k))
           for k, v in kwargs.items()}
    ex.session = session
    ex.depth = 0
    ex.fn = target
    ex.frame = _Frame(target.__code__,
                      inspect.getcallargs(target, *wrapped, **wkw),
                      target, None)
    return ex


def symbolic_translate(fn):
    """Wrap a function/method in SOT capture (the reference's
    sot.symbolic_translate)."""
    if isinstance(fn, SotFunction):
        return fn
    return SotFunction(fn)


def sot_stats(fn) -> dict:
    if isinstance(fn, SotFunction):
        return fn.stats
    raise TypeError("not a SotFunction")
