"""to_static, jit.save and jit.load: the counterpart of
``paddle_tpu/jit/api.py``.

The reference functionalizes the module (parameters and buffers become
explicit inputs through ``nn.functional_call``) and traces it with
``jax.jit``: one cached executable for the forward and one for the
backward. Here the same functional forward is traced with ``make_fx`` over
fake tensors, which runs the Python, the eager ``Tensor`` wrapper and the
``dy2static`` converters included, as ``jax.jit`` runs it, into an FX graph
of ATen ops and the port's kernel ops (``ops/cuda/library.py``); that graph
is compiled by ``torch.compile(fullgraph=True, dynamic=False)`` through
AOTAutograd, one forward graph and one backward graph per cache key.
``backend=None`` compiles with inductor on the card and with ``aot_eager``
(AOTAutograd's graphs run op by op, no code generation) on the CPU; a named
backend is used as it is. Inductor writes its generated code under
``TORCHINDUCTOR_CACHE_DIR`` (torch's default: a ``torchinductor_<user>``
folder in the temporary directory).

``jit.save`` writes the reference's ``.pdiparams`` container byte for byte,
its ``.pdmeta``, and as ``.pdmodel`` a ``torch.export`` program (the
reference's is serialized StableHLO, which ``jit.load`` refuses by name).
"""
from __future__ import annotations

import functools
import inspect
import json
import os
import pickle
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from .._core import dtype as dtypes
from .._core import lazy, persist
from .._core.flags import flag_value
from .._core.tensor import Tensor
from ..nn.layer import Layer, Parameter, functional_call

__all__ = ["InputSpec", "StaticFunction", "to_static", "not_to_static",
           "ignore_module", "TranslatedLayer", "save", "load",
           "compile_traced"]


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=False):
        self.shape = shape
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient


# ------------------------------------------------------ tracing + compiling

def _is_tensor(x):
    return isinstance(x, Tensor)


def _is_guard_static(leaf) -> bool:
    """Python bool/int/str leaves are guarded compile-time constants
    (SOT guard semantics); tensors and floats stay dynamic (floats are
    commonly per-call values — guarding them would retrace per value)."""
    return isinstance(leaf, (bool, int, str)) and not hasattr(leaf, "dtype")


def _static_partition(vals):
    """Split a tree into (dynamic leaves, treedef, static signature). The
    static signature is hashable and joins the compile cache key."""
    leaves, treedef = pytree.tree_flatten(vals, is_leaf=_is_tensor)
    dyn, static = [], []
    for i, leaf in enumerate(leaves):
        if _is_guard_static(leaf):
            static.append((i, leaf))
        else:
            dyn.append(leaf)
    return dyn, treedef, tuple(static)


def _restore_static(treedef, static, dyn):
    """Inverse of _static_partition given the dynamic leaves."""
    static_at = dict(static)
    it = iter(dyn)
    leaves = [static_at[i] if i in static_at else next(it)
              for i in range(treedef.num_leaves)]
    return pytree.tree_unflatten(leaves, treedef)


def _payload(leaf, device):
    """A dynamic leaf as the torch tensor the compiled program takes: a
    Tensor's payload, a torch tensor or array as it is, a float as a 0-d
    float32 tensor (the reference traces a float as a weak f32 scalar)."""
    if isinstance(leaf, Tensor):
        return leaf._t
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, (float, np.ndarray, np.generic)):
        t = torch.as_tensor(leaf, device=device)
        return t.float() if t.dtype == torch.float64 else t
    if leaf is None:
        return None
    raise TypeError(f"to_static: cannot pass a {type(leaf).__name__} "
                    f"argument to a compiled function")


def _signature(tensors):
    """What a trace is specialised on besides the cache key: each input's
    shape, type and device, and whether it takes a gradient."""
    return tuple(None if t is None else
                 (tuple(t.shape), t.dtype, t.device, t.requires_grad)
                 for t in tensors)


def default_backend(device: torch.device) -> str:
    """``backend=None``: inductor on the card, ``aot_eager`` on the CPU."""
    return "inductor" if device.type == "cuda" else "aot_eager"


def _recording_backend(backend: str, graphs: List):
    """``backend`` as a ``torch.compile`` backend that appends each graph
    AOTAutograd hands it to ``graphs`` as ("forward" or "backward", the
    graph module); a backend other than inductor and aot_eager is passed
    by name, unrecorded."""
    if backend == "inductor":
        from torch._inductor.compile_fx import compile_fx, compile_fx_inner

        def inner(gm, example_inputs, **kwargs):
            graphs.append(("backward" if kwargs.get("is_backward")
                           else "forward", gm))
            return compile_fx_inner(gm, example_inputs, **kwargs)
        return functools.partial(compile_fx, inner_compile=inner)
    if backend == "aot_eager":
        from functorch.compile import make_boxed_func
        from torch._dynamo.backends.common import aot_autograd

        def graph(kind):
            def compiler(gm, example_inputs):
                graphs.append((kind, gm))
                return make_boxed_func(gm.forward)
            return compiler
        return aot_autograd(fw_compiler=graph("forward"),
                            bw_compiler=graph("backward"))
    return backend


# errors of a trace that reads a traced value on the host: a branch on a
# tensor, .numpy(), .tolist(), int() of a tensor
def _reads_a_traced_value(e: Exception) -> bool:
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.fx.experimental.symbolic_shapes import \
        GuardOnDataDependentSymNode
    return isinstance(e, (GuardOnDataDependentSymNode,
                          DataDependentOutputException)) or (
        isinstance(e, RuntimeError)
        and "not supported for tensor subclasses" in str(e))


def _args_signature(example_args):
    return tuple(_signature([t for t in pytree.tree_leaves(example_args)
                             if isinstance(t, torch.Tensor)]))


def compile_traced(fn: Callable, example_args, backend: Optional[str],
                   graphs: Optional[List] = None,
                   device: Optional[torch.device] = None,
                   persist_key=None, extra: Optional[Dict] = None) -> Callable:
    """Traces ``fn(*example_args)`` (torch tensors in, a tree of torch
    tensors out) over fake tensors with ``make_fx`` and compiles the graph
    with ``torch.compile(fullgraph=True, dynamic=False)``; ``graphs``
    receives the forward and backward graphs compiled (see
    ``_recording_backend``), the result's ``graph_module`` is the traced
    graph. The trace raises where ``fn`` reads a traced value on the host
    (see ``to_static``).

    With ``FLAGS_executable_cache_dir`` set and a ``persist_key`` (what
    names ``fn`` across processes, ``_core/persist.py``), the traced graph
    is stored with ``extra`` (what the trace recorded beside it) and a later
    call with the same key and input signature loads both instead of
    tracing; the result's ``persisted`` says which happened."""
    if device is None:
        device = next((t.device for t in pytree.tree_leaves(example_args)
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
    name = backend or default_backend(device)
    norm = None
    if persist_key is not None and persist.ACTIVE:
        norm = persist.persist_key(
            (persist_key, _args_signature(example_args), name))
    payload = persist.load("traced", norm) if norm is not None else None
    if payload is not None:
        gm = payload["module"]
        if extra is not None:
            extra.update(payload["extra"])
    else:
        with lazy.suspended():   # the eager calls inside reach the tracer
            gm = make_fx(fn, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*example_args)
        if norm is not None:
            persist.store("traced", norm, gm, extra)
    compiled = torch.compile(gm, backend=_recording_backend(
        name, graphs if graphs is not None else []), fullgraph=True,
        dynamic=False)
    compiled.graph_module = gm
    compiled.persisted = payload is not None
    return compiled


def _layer_config(layer: Layer) -> List:
    """Every sublayer's name, class and the values it holds besides its
    parameters, buffers and sublayers (its config, head counts, dropout
    rates, flags, hooks): what a trace reads as Python values and bakes
    into the graph. Two models of the same parameter shapes but another
    config differ here."""
    out = []
    for name, sub in layer.named_sublayers(include_self=True):
        held = set(sub._parameters) | set(sub._buffers) | \
            set(sub._sub_layers) | {"_parameters", "_buffers", "_sub_layers"}
        attrs = {k: v for k, v in vars(sub).items()
                 if k not in held and not isinstance(v, StaticFunction)}
        out.append((name, type(sub), attrs))
    return out


def _amp_state():
    from ..amp.auto_cast import state_key
    return state_key()


class _Entry:
    """One cache key's compiled programs: one per input signature (the
    role of ``jax.jit``'s own signature cache inside the reference's
    entry), the traces taken and the forward and backward graphs compiled
    for them."""

    def __init__(self, names: List[str]):
        self.programs: Dict[Any, Any] = {}
        self.graphs: List = []
        self.traces = 0
        self.loads = 0   # graphs loaded from the persistent cache
        # the state names are part of the key: where each buffer written
        # back sits in the state list
        self.index = {n: i for i, n in enumerate(names)}

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, _ in self.graphs:
            out[kind] = out.get(kind, 0) + 1
        return out


class StaticFunction:
    """Compiled callable wrapping a Layer's forward or a plain function.

    Each call runs the compiled forward of its cache key; the backward is
    the compiled backward graph AOTAutograd made with it, which torch's
    autograd runs when a loss downstream is differentiated.
    """

    def __init__(self, fn, layer: Optional[Layer] = None, input_spec=None,
                 build_strategy=None, backend=None, full_graph=True):
        self._fn = fn
        self._src_fn = fn   # before dy2static: what the persist key names
        self._layer = layer
        self._input_spec = input_spec
        self._backend = backend
        self._fwd_cache: Dict[Any, _Entry] = {}
        self._dy2st_note = None
        # dy2static pass: rewrite tensor control flow into torch.cond /
        # while_loop via the convert operators; on transform failure keep
        # the original function and surface the reason if tracing later
        # hits tensor control flow
        try:
            from .dy2static import ast_transform
            if inspect.ismethod(fn):
                raw = ast_transform(fn.__func__)
                if raw is not fn.__func__:
                    self._fn = raw.__get__(fn.__self__)
            else:
                self._fn = ast_transform(fn)
        except Exception as e:  # keep eager semantics; explain later
            self._dy2st_note = f"{type(e).__name__}: {e}"
        try:
            functools.update_wrapper(self, fn)
        except Exception:
            pass

    def _make_pure(self, names, buffers, a_part, k_part, shapes):
        """The functional forward over (state payloads, dynamic payloads):
        returns the output's tensors and the buffers' values after the
        run; ``shapes`` receives the output tree and its constants.

        The trace runs the layer on copies of the buffers: an update made
        in place under ``no_grad`` (BN's running statistics) then changes
        a copy, which the program returns cut from autograd and the call
        writes back. (The trace keeps the in-place op but not the
        ``no_grad`` around it: on an input, the update would join the
        buffer to the step's autograd graph.)"""
        layer, fn, sf = self._layer, self._fn, self

        def pure(svals, dyn):
            svals = [v.clone() if n in buffers else v
                     for n, v in zip(names, svals)]
            wrapped = [None if d is None else Tensor(d) for d in dyn]
            n_a = a_part[0].num_leaves - len(a_part[1])
            args = _restore_static(a_part[0], a_part[1], wrapped[:n_a])
            kwargs = _restore_static(k_part[0], k_part[1], wrapped[n_a:])
            if layer is not None:
                # layer.forward points at this StaticFunction; restore the
                # original bound forward while tracing
                layer.forward = fn
                try:
                    out, bufs = functional_call(
                        layer, dict(zip(names, svals)), *args,
                        return_buffers=True, **kwargs)
                finally:
                    layer.forward = sf
                bufs = {n: b.detach() for n, b in bufs.items()}
            else:
                out, bufs = fn(*args, **kwargs), {}
            leaves, tree = pytree.tree_flatten(out, is_leaf=_is_tensor)
            shapes["tree"] = tree
            shapes["consts"] = {i: x for i, x in enumerate(leaves)
                                if not isinstance(x, (Tensor, torch.Tensor))}
            outs = [x._t if isinstance(x, Tensor) else x for i, x in
                    enumerate(leaves) if i not in shapes["consts"]]
            return outs, bufs
        return pure

    def __call__(self, *args, **kwargs):
        if self._layer is not None:
            state = self._layer.state_dict()
            names, state_tensors = list(state.keys()), list(state.values())
        else:
            names, state_tensors = [], []
        a_dyn, a_def, a_static = _static_partition(args)
        k_dyn, k_def, k_static = _static_partition(kwargs)
        key = (tuple(names),
               self._layer.training if self._layer else None,
               a_def, k_def, a_static, k_static, _amp_state())
        entry = self._fwd_cache.get(key)
        if entry is None:
            cap = flag_value("FLAGS_dy2static_cache_limit")
            while cap and len(self._fwd_cache) >= cap:  # 0 = unlimited
                self._fwd_cache.pop(next(iter(self._fwd_cache)))
            entry = self._fwd_cache[key] = _Entry(names)

        svals = [t._t for t in state_tensors]
        device = next((_payload(x, None).device for x in
                       state_tensors + a_dyn + k_dyn
                       if isinstance(x, (Tensor, torch.Tensor))),
                      torch.device("cpu"))
        dyn = [_payload(x, device) for x in a_dyn + k_dyn]
        sig = _signature(svals + dyn)
        program = entry.programs.get(sig)
        if program is None:
            shapes: Dict[str, Any] = {}
            buffers = {n for n, t in zip(names, state_tensors)
                       if not isinstance(t, Parameter)}
            pure = self._make_pure(names, buffers, (a_def, a_static),
                                   (k_def, k_static), shapes)
            try:
                compiled = compile_traced(
                    pure, (svals, dyn), self._backend, entry.graphs, device,
                    persist_key=self._persist_key(key), extra=shapes)
            except Exception as e:
                if not _reads_a_traced_value(e):
                    raise
                note = f" (dy2static transform failed: {self._dy2st_note})" \
                    if self._dy2st_note else ""
                raise RuntimeError(
                    "to_static: the function branches on a tensor value "
                    "that is only known at run time. Supported fixes: "
                    "keep the control flow in a form the dy2static "
                    "transformer can convert (plain if/while assigning "
                    "local variables), use paddle.where / torch.cond style "
                    f"ops, or run the model eagerly.{note}") from e
            if compiled.persisted:
                entry.loads += 1
            else:
                entry.traces += 1
            program = entry.programs[sig] = (compiled, shapes)
        compiled, shapes = program
        outs, bufs = compiled(svals, dyn)

        # write back the buffers (BN running statistics)
        for bname, bval in bufs.items():
            state_tensors[entry.index[bname]]._t = bval
        it = iter(outs)
        leaves = [shapes["consts"][i] if i in shapes["consts"]
                  else Tensor(next(it))
                  for i in range(shapes["tree"].num_leaves)]
        return pytree.tree_unflatten(leaves, shapes["tree"])

    def _persist_key(self, key):
        """What names this function's trace across processes: the function
        (normalized: module, qualified name, a digest of its code and of
        its module's file), the cache key, and every sublayer's class and
        held values (``_layer_config``); None when the persistent cache is
        off. (``_core/persist.py`` adds the port's source stamp.)"""
        if not persist.ACTIVE:
            return None
        fn = getattr(self._src_fn, "__func__", self._src_fn)
        layers = _layer_config(self._layer) if self._layer is not None \
            else None
        return ("to_static", fn, layers, key)

    def concrete_program(self):
        return None


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """Decorator/wrapper: compile a Layer's forward or a function, once per
    cache key (state names, training flag, argument trees, their Python
    bool/int/str leaves and the AMP state) and input signature. Usable
    standalone or inside training loops. Tensor control flow must be
    convertible (dy2static) or the trace raises, as in the reference's
    AST path; nothing runs eagerly in its place. ``full_graph=False`` is
    the reference's SOT path (``jit.sot.symbolic_translate``): bytecode
    capture into the lazy window with graph-break fallback, a clean
    capture replayed through a guarded compiled fast path."""
    if not full_graph:
        from .sot import symbolic_translate

        def _build_sot(fn):
            if isinstance(fn, Layer):
                fn.forward = symbolic_translate(fn.forward)
                return fn
            return symbolic_translate(fn)
        return _build_sot(function) if function is not None else _build_sot

    def _build(fn):
        if isinstance(fn, Layer):
            sf = StaticFunction(fn.forward, layer=fn, input_spec=input_spec,
                                backend=backend)
            fn.forward = sf
            return fn
        return StaticFunction(fn, layer=None, input_spec=input_spec,
                              backend=backend)

    if function is not None:
        return _build(function)
    return _build


def not_to_static(fn=None):
    return fn


def ignore_module(modules):
    pass


class TranslatedLayer(Layer):
    """Deserialized inference layer (fluid/jit/layer.h analog)."""

    def __init__(self, state, forward_fn):
        super().__init__()
        self._state = state
        self._forward_fn = forward_fn

    def forward(self, *args):
        return self._forward_fn(*args)


# ------------------------------------------------------------- artifacts

def _lookup_dtype(name):
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A payload as numpy, bfloat16 as ml_dtypes' bfloat16 (the
    reference's name and bytes for it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _save_param_file(path, np_state):
    """safetensors-style container: 8-byte header length, json header
    (name -> dtype/shape/offsets), raw buffers. No pickle: loading
    cannot execute code."""
    metas = {}
    blobs = []
    off = 0
    for k, v in np_state.items():
        b = np.ascontiguousarray(v).tobytes()
        metas[k] = {"dtype": v.dtype.name, "shape": list(v.shape),
                    "offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    head = json.dumps(metas).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in blobs:
            f.write(b)


def _load_param_file(path):
    from .native_layer import HeaderError, NativeJitLayer
    try:
        return {k: v.copy() for k, v in NativeJitLayer.params_of(path).items()}
    except HeaderError:
        # not the container: a legacy pickle one, refused unless opted in
        # (unpickling executes arbitrary code)
        if os.environ.get("PT_ALLOW_PICKLE_LOAD") == "1" \
                or flag_value("FLAGS_allow_pickle_load"):
            with open(path, "rb") as f:
                return pickle.loads(f.read())
        raise RuntimeError(
            f"{path} is a legacy pickle parameter file; loading pickle "
            "can execute arbitrary code. Re-save with jit.save, or set "
            "PT_ALLOW_PICKLE_LOAD=1 if you trust this file") from None


def _spec_shape_dtype(spec, i):
    if isinstance(spec, Tensor):
        return list(spec.shape), spec._t.dtype
    if isinstance(spec, torch.Tensor):
        return list(spec.shape), spec.dtype
    if hasattr(spec, "shape") and hasattr(spec, "dtype"):
        return list(spec.shape), dtypes.to_torch(spec.dtype)
    a = np.asarray(spec)
    return list(a.shape), torch.from_numpy(a).dtype


class _Exportable(torch.nn.Module):
    """The layer's functional forward as a ``torch.nn.Module`` taking its
    state's tensors, then the inputs: the program ``torch.export`` saves
    holds no weights, which live in ``.pdiparams`` as in the reference."""

    def __init__(self, layer, names, fwd):
        super().__init__()
        self._layer, self._names, self._fwd = layer, names, fwd

    def forward(self, *flat):
        n = len(self._names)
        orig = self._layer.forward
        self._layer.forward = self._fwd
        try:
            out = functional_call(self._layer,
                                  dict(zip(self._names, flat[:n])),
                                  *[Tensor(a) for a in flat[n:]])
        finally:
            self._layer.forward = orig
        return tuple(x._t if isinstance(x, Tensor) else x
                     for x in pytree.tree_leaves(out, is_leaf=_is_tensor))


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save analog: persist params (``.pdiparams``), the traced
    program as a ``torch.export`` program (``.pdmodel``, saved with
    ``torch.export.save``; the port's kernel ops stay ops in it) and the
    IO metadata (``.pdmeta``). ``input_spec``: a list of ``InputSpec``
    (shape/dtype, a ``None`` dim becomes a ``torch.export.Dim``) or
    example Tensors; required."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)

    state = layer.state_dict()
    names = list(state.keys())
    np_state = {k: _numpy(v._t) for k, v in state.items()}
    _save_param_file(path + ".pdiparams", np_state)

    if input_spec is None:
        raise ValueError("jit.save needs input_spec (shapes/dtypes or "
                         "example tensors) to trace the program")
    svals = [v._t.detach() for v in state.values()]
    device = svals[0].device if svals else torch.device("cpu")
    examples, dynamic_shapes = [], []
    batch = None
    for i, spec in enumerate(input_spec):
        shape, dt = _spec_shape_dtype(spec, i)
        dims = {}
        concrete = []
        for j, s in enumerate(shape):
            if s is None or s == -1:
                # one Dim for every dynamic dim 0, as a batch dim is shared
                if j == 0:
                    batch = batch or torch.export.Dim("batch", min=1)
                    dims[j] = batch
                else:
                    dims[j] = torch.export.Dim(f"x{i}_d{j}", min=1)
                concrete.append(2 if j == 0 else 3)
            else:
                concrete.append(int(s))
        if isinstance(spec, (Tensor, torch.Tensor)):
            ex = (spec._t if isinstance(spec, Tensor) else spec).detach()
        else:
            ex = torch.zeros(concrete, dtype=dt, device=device)
        examples.append(ex)
        dynamic_shapes.append(dims or None)

    fwd = layer.forward
    if isinstance(fwd, StaticFunction):
        fwd = fwd._fn
    module = _Exportable(layer, names, fwd)
    with torch.no_grad():
        program = torch.export.export(
            module, tuple(svals) + tuple(examples),
            # one entry: forward's *flat, a spec per flat input
            dynamic_shapes=((None,) * len(svals) + tuple(dynamic_shapes),))
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(program, f)

    # IO metadata for the inference AnalysisPredictor (named multi-IO,
    # the role of the reference's serialized feed/fetch op info)
    in_meta = []
    for i, spec in enumerate(input_spec):
        nm = getattr(spec, "name", None) or f"x{i}"
        shape, dt = _spec_shape_dtype(spec, i)
        shp = [(-1 if not isinstance(s, int) or s == -1 else int(s))
               for s in shape]
        in_meta.append({"name": nm, "shape": shp,
                        "dtype": dtypes.from_torch(dt).name})
    if flag_value("FLAGS_jit_save_meta"):
        n_out = len(program.graph_signature.user_outputs)
        with open(path + ".pdmeta", "w") as f:
            json.dump({"inputs": in_meta,
                       "outputs": [f"out{i}" for i in range(n_out)]}, f)


def load_program(path):
    """The ``torch.export`` program of a ``.pdmodel``; a file in another
    format (the reference's serialized StableHLO) raises naming it."""
    import zipfile
    if not zipfile.is_zipfile(path):
        raise RuntimeError(
            f"{path} is not a torch.export program (a zip archive): it is "
            "likely the JAX package's serialized StableHLO (jax.export), "
            "which this package cannot run; re-save the layer with "
            "paddle_tpu_torch.jit.save")
    with open(path, "rb") as f:
        return torch.export.load(f)


def _to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """A container array as a tensor on ``device`` (a copy: the container's
    views are read-only); bfloat16 through its bits."""
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def load(path, device=None, **configs):
    """paddle.jit.load analog: the ``torch.export`` program + params as a
    ``TranslatedLayer`` (no Python class needed). The parameters are read
    through the artifact container (``native_layer.NativeJitLayer``:
    memory-mapped, offsets checked) and copied to ``device`` (default: the
    current device, the card unless ``set_device('cpu')``)."""
    from .._core.device import to_device
    from .native_layer import NativeJitLayer
    container = NativeJitLayer(path)
    program = load_program(path + ".pdmodel")
    np_state = container.state_dict()
    dev = to_device(device)
    svals = [_to_torch(a, dev) for a in np_state.values()]
    module = program.module()

    def forward_fn(*args):
        arrays = [a._t if isinstance(a, Tensor) else
                  torch.as_tensor(np.asarray(a), device=dev) for a in args]
        with torch.no_grad():
            out = [Tensor(o) for o in module(*svals, *arrays)]
        return out[0] if len(out) == 1 else out

    layer = TranslatedLayer(np_state, forward_fn)
    object.__setattr__(layer, "_program", program)
    object.__setattr__(layer, "_svals", svals)
    # np_state holds zero-copy views into the container's mmap: the
    # container must outlive every retained view
    object.__setattr__(layer, "_native_container", container)
    return layer
