"""The native runtime bridge: the counterpart of
``paddle_tpu/_core/native.py``.

Two libraries are built with ``g++`` at first use, into the git-ignored
``paddle_tpu_torch/csrc/build/``:

- ``libpt_runtime.so``, the runtime library, from the repo's C++ sources
  (``csrc/tcp_store.cc``, ``allocator.cc``, ``flags.cc``, ``data_feed.cc``,
  ``pt_error.cc`` and the headers they include), read as they are and bound
  with ``ctypes``: the ``TCPStore`` (``distributed/store.py``), the host
  allocator (``host_pool()``), the token feed (``io/token_feed.py``) and
  the flag registry's C side. ``csrc/comm_context.cc``'s host ring is served
  by gloo and NCCL (``ROADMAP.md`` §3); ``device_plugin.cc``,
  ``fake_device.cc`` and ``jit_layer.cc`` are not built here.
- ``pt_eager_core``, the port's CPython extension
  (``paddle_tpu_torch/csrc/eager_core.cc``), built against ``Python.h`` of
  the running interpreter: the native record core and whole-step driver of
  the lazy window (``_core/lazy.py``).

A library is rebuilt when one of its sources is newer than it (the
reference's ``_needs_build``). Builds write a temporary file and rename it,
under a file lock, so processes that start together build once.
"""
from __future__ import annotations

import ctypes
import fcntl
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional

_LOG = logging.getLogger(__name__)

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "csrc"
PORT_CSRC = REPO / "paddle_tpu_torch" / "csrc"
BUILD_DIR = PORT_CSRC / "build"

RUNTIME_SOURCES = ("tcp_store.cc", "allocator.cc", "flags.cc",
                   "data_feed.cc", "pt_error.cc")
RUNTIME_SO = BUILD_DIR / "libpt_runtime.so"
EAGER_CORE_SRC = PORT_CSRC / "eager_core.cc"
EAGER_CORE_SO = BUILD_DIR / ("pt_eager_core"
                             + sysconfig.get_config_var("EXT_SUFFIX"))
FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread",
         "-fvisibility=hidden"]

_lib = None
_lib_lock = threading.Lock()


def _stale(target: Path, sources: List[Path]) -> bool:
    if not target.exists():
        return True
    built = target.stat().st_mtime
    return any(p.stat().st_mtime > built for p in sources)


def _compile(target: Path, sources: List[Path], cmd: List[str]) -> None:
    """Runs ``cmd`` (writing ``-o <tmp>``) and renames the result to
    ``target``, unless another process built it meanwhile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(target, sources):
            return
        tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
        full = cmd + ["-o", str(tmp)]
        proc = subprocess.run(full, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed ({' '.join(full)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)


def _runtime_sources() -> List[Path]:
    return [CSRC / f for f in RUNTIME_SOURCES] + sorted(CSRC.glob("*.h"))


def build_runtime() -> Path:
    """The runtime library, compiled first if it is missing or stale."""
    sources = _runtime_sources()
    if _stale(RUNTIME_SO, sources):
        _compile(RUNTIME_SO, sources,
                 ["g++", *FLAGS, f"-I{CSRC}",
                  *(str(CSRC / f) for f in RUNTIME_SOURCES)])
    return RUNTIME_SO


def _bind(lib):
    c = ctypes
    lib.pt_last_error.restype = c.c_char_p
    lib.pt_store_server_start.restype = c.c_void_p
    lib.pt_store_server_start.argtypes = [c.c_int]
    lib.pt_store_server_port.restype = c.c_int
    lib.pt_store_server_port.argtypes = [c.c_void_p]
    lib.pt_store_server_stop.argtypes = [c.c_void_p]
    lib.pt_store_client_connect.restype = c.c_void_p
    lib.pt_store_client_connect.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.pt_store_client_close.argtypes = [c.c_void_p]
    lib.pt_store_set.restype = c.c_int
    lib.pt_store_set.argtypes = [c.c_void_p, c.c_char_p, c.c_void_p,
                                 c.c_uint32]
    lib.pt_store_get.restype = c.c_int64
    lib.pt_store_get.argtypes = [c.c_void_p, c.c_char_p, c.c_void_p,
                                 c.c_int64, c.c_uint32]
    lib.pt_store_wait.restype = c.c_int
    lib.pt_store_wait.argtypes = [c.c_void_p, c.c_char_p, c.c_uint32]
    lib.pt_store_del.restype = c.c_int
    lib.pt_store_del.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_store_add.restype = c.c_int64
    lib.pt_store_add.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]

    lib.pt_alloc_create.restype = c.c_void_p
    lib.pt_alloc_create.argtypes = [c.c_uint64]
    lib.pt_alloc_destroy.argtypes = [c.c_void_p]
    lib.pt_alloc_malloc.restype = c.c_void_p
    lib.pt_alloc_malloc.argtypes = [c.c_void_p, c.c_uint64]
    lib.pt_alloc_free.restype = c.c_int
    lib.pt_alloc_free.argtypes = [c.c_void_p, c.c_void_p]
    lib.pt_alloc_stats.argtypes = [c.c_void_p, c.POINTER(c.c_uint64),
                                   c.POINTER(c.c_uint64)]

    lib.pt_feed_create.restype = c.c_void_p
    lib.pt_feed_create.argtypes = [c.c_char_p, c.c_int64, c.c_int64,
                                   c.c_int, c.c_uint64, c.c_int]
    lib.pt_feed_num_windows.restype = c.c_int64
    lib.pt_feed_num_windows.argtypes = [c.c_void_p]
    lib.pt_feed_next.restype = c.c_int
    lib.pt_feed_next.argtypes = [c.c_void_p, c.c_void_p]
    lib.pt_feed_destroy.argtypes = [c.c_void_p]

    lib.pt_flag_define.restype = c.c_int
    lib.pt_flag_define.argtypes = [c.c_char_p, c.c_char_p]
    lib.pt_flag_set.restype = c.c_int
    lib.pt_flag_set.argtypes = [c.c_char_p, c.c_char_p]
    lib.pt_flag_get.restype = c.c_int64
    lib.pt_flag_get.argtypes = [c.c_char_p, c.c_char_p, c.c_int64]
    return lib


def get_lib(required: bool = False) -> Optional[ctypes.CDLL]:
    """The runtime library (built first if stale); None when it cannot be
    built or loaded and ``required`` is false."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build_runtime())))
            except (OSError, RuntimeError):
                if required:
                    raise
                return None
    return _lib


def last_error() -> str:
    """The calling thread's last error message of the runtime library."""
    lib = get_lib()
    return lib.pt_last_error().decode() if lib is not None else ""


_HOST_POOL = None


def host_pool():
    """The process-wide host memory pool (``csrc/allocator.cc``), with
    chunks of ``FLAGS_host_alloc_chunk_kb``: the reference's host
    ``AllocatorFacade``."""
    global _HOST_POOL
    if _HOST_POOL is None:
        from . import flags
        lib = get_lib(required=True)
        _HOST_POOL = lib.pt_alloc_create(
            int(flags.flag_value("FLAGS_host_alloc_chunk_kb")) * 1024)
    return _HOST_POOL


_EAGER_CORE = None
_EAGER_CORE_TRIED = False
EAGER_CORE_ERROR = ""


def build_eager_core() -> Path:
    """The extension, compiled first if it is missing or stale."""
    if _stale(EAGER_CORE_SO, [EAGER_CORE_SRC]):
        inc = sysconfig.get_paths()["include"]
        if not os.path.exists(os.path.join(inc, "Python.h")):
            raise RuntimeError(f"no Python.h under {inc}")
        _compile(EAGER_CORE_SO, [EAGER_CORE_SRC],
                 ["g++", *FLAGS, f"-I{inc}", str(EAGER_CORE_SRC)])
    return EAGER_CORE_SO


def get_eager_core():
    """The native record core (``pt_eager_core``), built at the first call;
    None when it cannot be built or loaded (the reason is in
    ``EAGER_CORE_ERROR`` and the log) or when ``PT_DISABLE_NATIVE_EAGER=1``.
    The window's Python prong stands alone without it; ``lazy._NC`` caches
    the answer (tests set it to force either prong)."""
    global _EAGER_CORE, _EAGER_CORE_TRIED, EAGER_CORE_ERROR
    if _EAGER_CORE_TRIED:
        return _EAGER_CORE
    _EAGER_CORE_TRIED = True
    if os.environ.get("PT_DISABLE_NATIVE_EAGER") == "1":
        EAGER_CORE_ERROR = "PT_DISABLE_NATIVE_EAGER=1"
        return None
    try:
        so = build_eager_core()
        spec = importlib.util.spec_from_file_location("pt_eager_core",
                                                      str(so))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (OSError, RuntimeError, ImportError) as e:
        EAGER_CORE_ERROR = f"{type(e).__name__}: {e}"
        _LOG.warning("native record core unavailable, the Python prong "
                     "runs: %s", EAGER_CORE_ERROR)
        return None
    sys.modules.setdefault("pt_eager_core", mod)
    _EAGER_CORE = mod
    return mod
