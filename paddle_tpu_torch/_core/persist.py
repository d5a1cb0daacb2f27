"""The persistent compile cache (``FLAGS_executable_cache_dir``): the
counterpart of ``paddle_tpu/_core/persist.py``.

What it caches. The port compiles in one place, ``jit.api.compile_traced``:
``jit.to_static`` and SOT's fast path trace a function with ``make_fx`` and
hand the FX graph to ``torch.compile``. A cold start pays the trace (the
Python of the model run over fake tensors) and the compile. This module
stores the traced graph (its code and constants, as the ``GraphModule``
pickles them) with what the caller's trace recorded beside it, so a later
process loads the graph instead of tracing; while the flag names a
directory, inductor's FX-graph and AOTAutograd caches (``TORCHINDUCTOR_
CACHE_DIR``, and Triton's ``TRITON_CACHE_DIR``) point at its ``inductor``
subdirectory, so the compile of the loaded graph hits too. The lazy
window's segments compile nothing (their runners run the recorded ops in
order), so there is nothing of theirs to store.

Key: sha256 over ``repr((VERSION, torch version, CUDA version, device
capability, the port's source stamp, kind, normalized key))``. The source
stamp is a digest of every source file of the package (``.py``, ``.cc``,
``.cu``, ``.h``, ``.yaml``): a traced graph bakes in the code of every op
and layer it ran, so an edit anywhere in the port misses. ``normalize``
turns the caller's key into primitives whose ``repr`` is the same in every
process: sets sorted; functions by module, qualified name, a digest of
their code (bytecode, names and constants, nested code included) and what
they close over; classes by name and a digest of the code of every method
along their MRO; a function or class defined outside the package also by
a digest of its module's file; dataclasses and plain objects by their
fields; arrays and tensors by shape, dtype and a digest of their values;
dtypes and devices by name, pytree specs and enums by their repr. A key
holding something else (a bound method, a C object) is not persisted. The
caller puts into the key what its trace reads as Python values
(``jit.api``: every sublayer's class and attributes, ``_layer_config``).
What the key cannot see: a module-level value outside the package read
from a module that defines none of the key's functions or classes.

File layout (``<kind>-<digest>.ptxc``): ``MAGIC``, the hex sha256 of the
payload, a newline, the pickled payload. Writes are atomic (temporary file,
fsync, ``os.replace``); a load checks the magic, the checksum, the format
version, the torch, CUDA and device stamps and the full key before it
trusts the pickle, so a truncated, corrupted or stale entry is a clean
recompile that counts ``cache.persist.reject`` and logs why, never a crash.
After each store the oldest entries go until the directory fits
``FLAGS_executable_cache_disk_max_mb``. With no directory set the module
does nothing. ``COUNTS`` holds ``cache.persist.{hit,miss,store,reject}``;
with ``FLAGS_observability`` on they are counted into the registry too,
and with the flight recorder on a reject leaves a note. The reference's
sidecar notes (a persisted executable's memory and cost analyses) have no
counterpart: what is stored is a traced graph, not a counted runner.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import logging
import os
import pickle
import sys
import tempfile
import types
from collections import Counter
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import flags as _flags
from ..observability import _state as _OBS
from .dtype import DType

_LOG = logging.getLogger(__name__)

VERSION = 1
MAGIC = b"PTXC1\n"
_SUFFIX = ".ptxc"

ACTIVE = False
_DIR = ""
COUNTS: Counter = Counter()

# the environment variables inductor and Triton read for their caches, and
# what they held before the flag pointed them into the directory
_CACHE_ENV = ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR")
_saved_env: Optional[Dict[str, Optional[str]]] = None


def _sync_dir_gate(value):
    global ACTIVE, _DIR, _saved_env
    _DIR = os.path.abspath(str(value).strip()) if str(value or "").strip() \
        else ""
    ACTIVE = bool(_DIR)
    if ACTIVE:
        if _saved_env is None:
            _saved_env = {k: os.environ.get(k) for k in _CACHE_ENV}
        inductor = os.path.join(_DIR, "inductor")
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = inductor
        os.environ["TRITON_CACHE_DIR"] = os.path.join(inductor, "triton")
    elif _saved_env is not None:
        for k, v in _saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _saved_env = None


def _count(stat: str, reason: Optional[str] = None) -> None:
    COUNTS["cache.persist." + stat] += 1
    if _OBS.METRICS:
        from ..observability import metrics
        metrics.inc("cache.persist." + stat)
    if reason is not None:
        _LOG.warning("persistent compile cache: %s", reason)
        if _OBS.FLIGHT:
            from ..observability import flight
            flight.note("cache.persist", stat, reason=reason)


def counters() -> Dict[str, int]:
    return {k: COUNTS[k] for k in ("cache.persist.hit", "cache.persist.miss",
                                   "cache.persist.store",
                                   "cache.persist.reject")}


_ENV = None


def _env() -> tuple:
    """(torch version, CUDA version, device capability): what a stored
    graph and inductor's code for it depend on besides the key."""
    global _ENV
    if _ENV is None:
        cap = "cpu"
        if torch.cuda.is_available():
            cap = "sm_%d%d" % torch.cuda.get_device_capability()
        _ENV = (torch.__version__, torch.version.cuda, cap)
    return _ENV


_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.basename(_PKG_ROOT)
_SOURCES = (".py", ".cc", ".cu", ".cuh", ".h", ".yaml")
_STAMP = None


def source_stamp() -> str:
    """A digest of every source file of the package (its built libraries
    and bytecode caches left out): what a traced graph's ops and layers
    ran."""
    global _STAMP
    if _STAMP is None:
        h = hashlib.sha256()
        for root, dirs, files in os.walk(_PKG_ROOT):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("build", "__pycache__"))
            for name in sorted(files):
                if name.endswith(_SOURCES):
                    path = os.path.join(root, name)
                    h.update(os.path.relpath(path, _PKG_ROOT).encode()
                             + b"\0")
                    with open(path, "rb") as f:
                        h.update(f.read())
        _STAMP = h.hexdigest()
    return _STAMP


_MODULE_STAMPS: Dict[str, Optional[str]] = {}


def _module_stamp(name: Optional[str]) -> Optional[str]:
    """A digest of the file of module ``name`` when it lies outside the
    package (a user's model file: the helpers and constants its code
    reads); None inside it (``source_stamp`` covers those) or when the
    module has no file."""
    if not name or name.split(".")[0] == _PKG:
        return None
    if name not in _MODULE_STAMPS:
        path = getattr(sys.modules.get(name), "__file__", None)
        stamp = None
        if path and path.endswith(".py"):
            try:
                with open(path, "rb") as f:
                    stamp = hashlib.sha256(f.read()).hexdigest()[:16]
            except OSError:
                pass
        _MODULE_STAMPS[name] = stamp
    return _MODULE_STAMPS[name]


def _code_digest(code: types.CodeType) -> str:
    """Bytecode, names and constants of ``code`` and of the code objects
    nested in it: a changed literal changes the digest."""
    h = hashlib.sha256()

    def walk(c):
        h.update(c.co_code)
        h.update(repr((c.co_names, c.co_varnames, c.co_freevars,
                       c.co_cellvars)).encode())
        for k in c.co_consts:
            if isinstance(k, types.CodeType):
                walk(k)
            else:
                h.update(repr(normalize(k)).encode())
    walk(code)
    return h.hexdigest()[:16]


_CLASS_CODE: Dict[type, str] = {}


def _class_digest(cls: type) -> str:
    """A digest of the code of every method, property and nested function
    along ``cls``'s MRO (``object`` and C types add nothing)."""
    if cls not in _CLASS_CODE:
        h = hashlib.sha256()
        for k in cls.__mro__:
            for name, attr in sorted(vars(k).items()):
                if isinstance(attr, (staticmethod, classmethod)):
                    attr = attr.__func__
                fns = (attr.fget, attr.fset, attr.fdel) \
                    if isinstance(attr, property) else (attr,)
                for fn in fns:
                    if isinstance(fn, types.FunctionType):
                        h.update(name.encode()
                                 + _code_digest(fn.__code__).encode())
        _CLASS_CODE[cls] = h.hexdigest()[:16]
    return _CLASS_CODE[cls]


_HEAPTYPE = 1 << 9   # Py_TPFLAGS_HEAPTYPE: a class made by a class statement


def _plain_object(v) -> bool:
    """An instance of a Python class whose state is all in its
    ``__dict__`` (no slots, no C base holding state of its own)."""
    cls = type(v)
    return bool(cls.__flags__ & _HEAPTYPE) and hasattr(v, "__dict__") \
        and not isinstance(v, (torch.Tensor, torch.nn.Module,
                               types.ModuleType)) \
        and all(k.__flags__ & _HEAPTYPE or k is object
                for k in cls.__mro__) \
        and not any("__slots__" in vars(k) for k in cls.__mro__)


# values named by their repr: it shows all they hold
_BY_REPR = (slice, range, complex, type(Ellipsis), enum.Enum,
            torch.memory_format, torch.layout, torch._ops.OpOverload,
            torch._ops.OpOverloadPacket, pytree.TreeSpec)


class Unpersistable(ValueError):
    """A key part whose ``repr`` differs between processes."""


def normalize(v, _depth: int = 0):
    """``v`` as primitives with a process-independent ``repr``; raises
    ``Unpersistable`` for what has none. A function is named by its module,
    qualified name and a digest of its code, with the values it closes
    over and its defaults (the port's op bodies are closures of the op
    factories)."""
    if _depth > 12:
        raise Unpersistable("nested too deep")
    d = _depth + 1
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, torch.Size):
        return ("Size",) + tuple(v)
    if isinstance(v, (tuple, list)):
        return type(v)(normalize(x, d) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("set",) + tuple(sorted((normalize(x, d) for x in v),
                                       key=repr))
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted(
            ((normalize(k, d), normalize(x, d)) for k, x in v.items()),
            key=repr))
    if isinstance(v, (torch.dtype, torch.device)):
        return ("torch", str(v))
    if isinstance(v, type):
        return ("type", v.__module__, v.__qualname__, _class_digest(v),
                _module_stamp(v.__module__))
    if isinstance(v, types.FunctionType):
        return ("fn", v.__module__, v.__qualname__,
                _code_digest(v.__code__), _module_stamp(v.__module__),
                tuple(normalize(c.cell_contents, d)
                      for c in v.__closure__ or ()),
                normalize(v.__defaults__, d), normalize(v.__kwdefaults__, d))
    if isinstance(v, np.generic):
        return ("np", str(v.dtype), v.item())
    if isinstance(v, (np.ndarray, torch.Tensor)):
        # an array the traced code reads is baked into the graph as a
        # constant: its values are part of the key
        a = v.detach().cpu().contiguous().view(-1).view(torch.uint8) \
            .numpy() if isinstance(v, torch.Tensor) else v
        if a.dtype == object:
            raise Unpersistable("an array of objects")
        return ("array", tuple(v.shape), str(v.dtype),
                hashlib.sha256(np.ascontiguousarray(a).tobytes())
                .hexdigest())
    if isinstance(v, types.BuiltinFunctionType):
        return ("builtin", getattr(v, "__module__", None), v.__qualname__)
    if isinstance(v, DType):
        return ("DType", v.name)
    if isinstance(v, _BY_REPR):
        r = repr(v)
        if " at 0x" not in r and "..." not in r:
            return ("repr", type(v).__qualname__, r)
    if dataclasses.is_dataclass(v):
        return ("dataclass", normalize(type(v), d),
                tuple((f.name, normalize(getattr(v, f.name), d))
                      for f in dataclasses.fields(v)))
    if _plain_object(v):
        return ("obj", normalize(type(v), d), normalize(vars(v), d))
    # a bound method, a C object: what it holds is not in its repr, or its
    # repr holds an address
    raise Unpersistable(f"a {type(v).__name__} value")


def persist_key(key) -> Optional[Any]:
    """The normalized form of ``key``, or None when it has none."""
    try:
        return normalize(key)
    except Unpersistable:
        return None


def digest(kind: str, norm_key) -> str:
    text = repr((VERSION,) + _env() + (source_stamp(), kind, norm_key))
    return hashlib.sha256(text.encode()).hexdigest()


def path_for(kind: str, norm_key) -> str:
    return os.path.join(_DIR, kind + "-" + digest(kind, norm_key) + _SUFFIX)


# ---------------------------------------------------------------- graphs

def graph_payload(gm) -> Dict:
    """What of a traced ``GraphModule`` is stored: its generated code with
    the imports it names, its constants and its input and output specs.
    (A pickled ``GraphModule`` is traced again when it is loaded, which is
    both the cost a warm start avoids and, for a ``make_fx`` graph, a
    trace that can fail.)"""
    from torch.fx.graph_module import _format_import_block
    from torch.package import sys_importer
    code = gm.graph.python_code("self")
    specs = getattr(gm.graph._codegen, "pytree_info", None)
    return {"imports": _format_import_block(code.globals, sys_importer),
            "code": gm.code,
            "buffers": {k: v for k, v in gm._buffers.items()
                        if v is not None},
            "in_spec": None if specs is None
            else pytree.treespec_dumps(specs.in_spec),
            "out_spec": None if specs is None
            else pytree.treespec_dumps(specs.out_spec)}


def graph_from_payload(g: Dict) -> torch.nn.Module:
    """A module whose ``forward`` is the stored graph's generated code over
    its constants: what ``torch.compile`` traces, as it traces the
    ``GraphModule`` the code came from."""
    ns: Dict[str, Any] = {}
    exec(compile(g["imports"] + "\n" + g["code"], "<persisted graph>",
                 "exec"), ns)
    cls = type("PersistedGraph", (torch.nn.Module,),
               {"forward": ns["forward"]})
    mod = cls()
    for k, v in g["buffers"].items():
        mod.register_buffer(k, v)
    if g["in_spec"] is not None:   # a graph over a tree of arguments
        mod._in_spec = pytree.treespec_loads(g["in_spec"])
        mod._out_spec = pytree.treespec_loads(g["out_spec"])
    return mod


# ------------------------------------------------------------------ store

def store(kind: str, norm_key, gm, extra: Optional[Dict] = None) -> bool:
    """Writes one traced ``GraphModule`` (``graph_payload``) and ``extra``
    under its digest. A failure is logged and swallowed: persisting never
    fails the step that compiled."""
    if not ACTIVE:
        return False
    try:
        graph = graph_payload(gm)
        torch_v, cuda_v, cap = _env()
        raw = pickle.dumps({
            "version": VERSION, "torch": torch_v, "cuda": cuda_v,
            "device": cap, "kind": kind, "key": repr(norm_key),
            "graph": graph, "extra": dict(extra or {})},
            protocol=pickle.HIGHEST_PROTOCOL)
        body = MAGIC + hashlib.sha256(raw).hexdigest().encode() + b"\n" + raw
        os.makedirs(_DIR, exist_ok=True)
        path = path_for(kind, norm_key)
        fd, tmp = tempfile.mkstemp(dir=_DIR,
                                   prefix=".tmp_" + os.path.basename(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except Exception as e:  # the step compiled: storing is best effort
        _LOG.warning("persistent compile cache: store failed for %s: %s",
                     kind, e)
        return False
    _count("store")
    _prune_disk()
    return True


def _prune_disk() -> None:
    """Oldest-mtime eviction down to FLAGS_executable_cache_disk_max_mb
    (0 = unbounded)."""
    budget = _flags.flag_value("FLAGS_executable_cache_disk_max_mb")
    if not budget:
        return
    budget_bytes = int(budget) << 20
    try:
        entries = []
        for name in os.listdir(_DIR):
            if name.endswith(_SUFFIX):
                p = os.path.join(_DIR, name)
                st = os.stat(p)
                entries.append((st.st_mtime, st.st_size, p))
        total = sum(e[1] for e in entries)
        entries.sort()
        while total > budget_bytes and entries:
            _, size, p = entries.pop(0)
            os.unlink(p)
            total -= size
    except OSError:
        pass


# ------------------------------------------------------------------- load

def load(kind: str, norm_key) -> Optional[Dict]:
    """The verified payload of a key (``module``, the stored graph rebuilt
    by ``graph_from_payload``, and ``extra``), or None (a miss, or a reject:
    every integrity failure is a clean recompile with a logged reason)."""
    if not ACTIVE:
        return None
    path = path_for(kind, norm_key)
    try:
        with open(path, "rb") as f:
            body = f.read()
    except OSError:
        _count("miss")
        return None
    try:
        if not body.startswith(MAGIC):
            raise ValueError("bad magic (not a cache entry)")
        rest = body[len(MAGIC):]
        if rest.find(b"\n") != 64:
            raise ValueError("malformed checksum header")
        expect = rest[:64].decode("ascii")
        raw = rest[65:]
        got = hashlib.sha256(raw).hexdigest()
        if got != expect:
            raise ValueError(f"checksum mismatch (recorded {expect[:12]}.., "
                             f"computed {got[:12]}..): a torn or corrupted "
                             "entry")
        payload = pickle.loads(raw)
        torch_v, cuda_v, cap = _env()
        for field, want in (("version", VERSION), ("torch", torch_v),
                            ("cuda", cuda_v), ("device", cap),
                            ("key", repr(norm_key))):
            if payload.get(field) != want:
                raise ValueError(f"{field} {payload.get(field)!r} != "
                                 f"{want!r}" if field != "key" else
                                 "key mismatch (a stale entry)")
        payload["module"] = graph_from_payload(payload["graph"])
    except Exception as e:  # an entry is untrusted input: never crash on it
        _count("reject", reason=f"{os.path.basename(path)}: {e}; "
                                "recompiling")
        return None
    _count("hit")
    return payload


_flags.watch_flag("FLAGS_executable_cache_dir", _sync_dir_gate)
