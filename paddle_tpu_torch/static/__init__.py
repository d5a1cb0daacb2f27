"""paddle.static: the counterpart of ``paddle_tpu/static/__init__.py``.

Declarative graph mode over the eager API: under ``enable_static()`` every
op call that reaches the port's one dispatch path (``_core/dispatch.apply``)
records an ``OpNode`` into the current ``Program`` instead of running; its
outputs' shapes and types come from running the op's body on meta tensors
(the ``jax.eval_shape`` role). ``Executor.run`` runs the IR pass pipeline
(``paddle_tpu_torch.ir``) on a ``Workspace`` copy of the program and
compiles the replay of the rewritten graph through the compile path of
``jit.to_static`` (``make_fx`` + ``torch.compile``), once per (program,
version, flags, feed, fetch, extra passes) key and feed signature. Eager
Tensors the graph captured (parameters, constants) are compile-time
constants of the program.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence  # noqa: F401

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .._core import dispatch
from .._core import dtype as dtypes
from .._core.op_registry import get_op
from .._core.tensor import Tensor

_state = threading.local()


def _st():
    if not hasattr(_state, "static_mode"):
        _state.static_mode = False
        _state.main_program = None
        _state.startup_program = None
    return _state


class Variable(Tensor):
    """Graph placeholder (framework.py Variable analog). Carries
    shape/dtype metadata; no payload until Executor.run feeds it."""

    def __init__(self, name, shape, dtype, program, source=None):
        dt = dtype if isinstance(dtype, torch.dtype) else \
            dtypes.to_torch(dtype)
        # an empty payload keeps Tensor invariants (never read at run)
        super().__init__(torch.zeros([0], dtype=dt), stop_gradient=True,
                         name=name)
        self.var_shape = list(shape)
        self.var_dtype = dt
        self.program = program
        self.source = source  # None = feed var; else producing OpNode

    # metadata reflects the DECLARED shape, not the empty payload —
    # user code like `y.shape[0]` must work while recording
    @property
    def shape(self):
        return list(self.var_shape)

    @property
    def ndim(self):
        return len(self.var_shape)

    @property
    def size(self):
        out = 1
        for d in self.var_shape:
            out *= (1 if d in (None, -1) else d)
        return out

    @property
    def dtype(self):
        return dtypes.from_torch(self.var_dtype)

    def __repr__(self):
        return (f"static.Variable(name={self.name}, "
                f"shape={self.var_shape}, dtype={self.var_dtype})")


class OpNode:
    """One recorded op: its name, attrs, inputs (Variables, eager Tensors,
    torch tensors or Python values) and output Variables. ``fn`` is the
    body the call dispatched (default: the op registered under the name)."""

    __slots__ = ("op_name", "attrs", "inputs", "outputs", "fn")

    def __init__(self, op_name, attrs, inputs, outputs, fn=None):
        self.op_name = op_name
        self.attrs = attrs
        self.inputs = inputs      # list of Variable | Tensor(const)
        self.outputs = outputs    # list of Variable
        self.fn = fn

    @property
    def body(self):
        return self.fn if self.fn is not None else get_op(self.op_name).fn


class Program:
    """Recorded op graph (framework.py Program / pir Program analog)."""

    _counter = 0

    def __init__(self):
        Program._counter += 1
        self.id = Program._counter
        self.ops: List[OpNode] = []
        self.feed_vars: List[Variable] = []
        self._version = 0

    def clone(self, for_test=False):
        return self

    def global_block(self):
        return self

    def __repr__(self):
        lines = [f"Program(id={self.id}, ops={len(self.ops)})"]
        for op in self.ops:
            lines.append(f"  {op.op_name}{tuple(op.attrs.items())}")
        return "\n".join(lines)


def default_main_program() -> Program:
    st = _st()
    if st.main_program is None:
        st.main_program = Program()
    return st.main_program


def default_startup_program() -> Program:
    st = _st()
    if st.startup_program is None:
        st.startup_program = Program()
    return st.startup_program


class program_guard:
    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        st = _st()
        self._old = (st.main_program, st.startup_program)
        st.main_program = self.main
        if self.startup is not None:
            st.startup_program = self.startup
        return self.main

    def __exit__(self, *exc):
        st = _st()
        st.main_program, st.startup_program = self._old
        return False


# ------------------------------------------------------------- mode switch

def enable_static():
    _st().static_mode = True
    dispatch.STATIC_HOOK = _record_op


def disable_static():
    _st().static_mode = False
    dispatch.STATIC_HOOK = None


def in_static_mode() -> bool:
    return _st().static_mode


def data(name: str, shape, dtype="float32", lod_level=0) -> Variable:
    """paddle.static.data: declare a feed placeholder."""
    prog = default_main_program()
    var = Variable(name, shape, dtype, prog)
    prog.feed_vars.append(var)
    return var


# ---------------------------------------------------------------- recorder

def _meta(t):
    """An input as a meta tensor (a Variable's unknown dims as 1)."""
    if isinstance(t, Variable):
        shape = [1 if d in (None, -1) else d for d in t.var_shape]
        return torch.empty(shape, dtype=t.var_dtype, device="meta")
    if isinstance(t, Tensor):
        t = t._t
    if isinstance(t, torch.Tensor):
        return t.detach().to("meta")
    return t


def _on_cpu(t):
    """An input as a CPU tensor, for a body that takes no meta tensors."""
    if isinstance(t, Variable):
        shape = [1 if d in (None, -1) else d for d in t.var_shape]
        return torch.zeros(shape, dtype=t.var_dtype)
    if isinstance(t, Tensor):
        t = t._t
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    return t


def _record_op(op_name: str, fn, inputs, attrs: Dict[str, Any]):
    """Called by ``dispatch.apply`` instead of running the op when static
    mode is on. Returns output placeholder(s)."""
    prog = default_main_program()
    with torch.no_grad():
        try:
            out = fn(*[_meta(t) for t in inputs], **attrs)
        except (NotImplementedError, RuntimeError):
            out = fn(*[_on_cpu(t) for t in inputs], **attrs)
    multi = isinstance(out, (tuple, list))
    node = OpNode(op_name, attrs, list(inputs), [], fn)
    outs = []
    for i, o in enumerate(pytree.tree_leaves(out if multi else (out,))):
        outs.append(Variable(f"tmp_{prog.id}_{len(prog.ops)}_{i}",
                             list(o.shape), o.dtype, prog, source=node))
    node.outputs = outs
    prog.ops.append(node)
    prog._version += 1
    return tuple(outs) if multi else outs[0]


# ----------------------------------------------------------------- executor

def run_node(node: OpNode, vals):
    """The node's body on concrete inputs, as a list of outputs."""
    out = node.body(*vals, **node.attrs)
    return list(out) if isinstance(out, (tuple, list)) else [out]


class Executor:
    """executor.py:1237 analog: compile the Program once per key and feed
    signature, then run. ``place``: where the program runs (default: the
    current device)."""

    def __init__(self, place=None):
        self.place = place
        self._cache: Dict[Any, Any] = {}

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, return_numpy=True, extra_passes=None):
        from .._core.device import to_device
        from .._core.flags import get_flags
        from ..jit.api import _signature, compile_traced
        program = program or default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        if not program.ops and not fetch_list:
            return []   # startup program: parameters already initialized

        flags_now = get_flags(["FLAGS_apply_ir_passes",
                               "FLAGS_enable_auto_layout",
                               "FLAGS_ir_pass_disable"])
        key = (program.id, program._version,
               tuple(sorted(flags_now.items())),
               tuple(sorted(feed.keys())),
               tuple(id(v) for v in fetch_list),
               tuple(id(p) for p in (extra_passes or ())))
        entry = self._cache.get(key)
        if entry is None:
            # compile-time pass pipeline on a workspace copy; the recorded
            # Program itself is never mutated
            from ..ir import Workspace, default_pass_manager
            ws = Workspace(program)
            protected = [v for v in fetch_list if isinstance(v, Variable)]
            if flags_now["FLAGS_apply_ir_passes"]:
                default_pass_manager().run(ws, protected=protected)
            for p in (extra_passes or ()):
                p.run(ws, frozenset(id(v) for v in protected))
            # keep the pass objects alive alongside the entry so the
            # id()-based key can't alias a freed pass object
            entry = self._cache[key] = (
                self._build_callable(ws, list(feed.keys()), fetch_list), {},
                tuple(extra_passes or ()))
        replay, programs, _ = entry
        dev = to_device(self.place)
        feed_vals = [torch.as_tensor(np.asarray(feed[k]), device=dev)
                     for k in sorted(feed.keys())]
        sig = _signature(feed_vals)
        if sig not in programs:
            programs[sig] = compile_traced(replay, feed_vals, None,
                                           device=dev)
        with torch.no_grad():
            outs = programs[sig](*feed_vals)
        if return_numpy:
            return [Tensor(o).numpy() for o in outs]
        return [Tensor(o) for o in outs]

    def _build_callable(self, ws, feed_names: List[str], fetch_list):
        def replay(*feed_vals):
            env: Dict[int, Any] = {}
            by_name = dict(zip(sorted(feed_names), feed_vals))
            for var in ws.feed_vars:
                if var.name in by_name:
                    env[id(var)] = by_name[var.name]

            def value_of(t):
                if isinstance(t, Variable):
                    t = ws.resolve(t)   # CSE may have aliased it
                if isinstance(t, Variable):
                    if id(t) in env:
                        return env[id(t)]
                    if id(t) in ws.const_env:  # folded to a constant
                        return ws.const_env[id(t)]
                    raise KeyError(f"feed missing for var '{t.name}'")
                if isinstance(t, Tensor):
                    return t._t   # captured dygraph tensor (parameter)
                return t          # constant injected by a pass, or None

            for node in ws.ops:
                outs = run_node(node, [value_of(t) for t in node.inputs])
                for var, o in zip(node.outputs, outs):
                    env[id(var)] = o
            return tuple(value_of(v) for v in fetch_list)

        return replay


# convenience namespace parity
class _StaticNN:
    @staticmethod
    def fc(x, size, num_flatten_dims=1, activation=None, name=None):
        from .. import matmul
        from ..nn import functional as F
        from ..nn.layer import create_parameter
        in_dim = int(np.prod(
            (x.var_shape if isinstance(x, Variable) else x.shape)
            [num_flatten_dims:]))
        w = create_parameter([in_dim, size], "float32")
        b = create_parameter([size], "float32", is_bias=True)
        out = matmul(x, w) + b
        if activation == "relu":
            out = F.relu(out)
        return out


nn = _StaticNN()


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name
