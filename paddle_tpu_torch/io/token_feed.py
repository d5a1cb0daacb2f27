"""``NativeTokenLoader``: the counterpart of ``paddle_tpu/io/token_feed.py``
over the repo's C++ token feed (``csrc/data_feed.cc``).

A C++ thread ``mmap``s a flat int32 token file and keeps a ring of
``prefetch_depth`` batches of ``[batch, seq_len + 1]`` windows (shuffled
by ``std::mt19937_64(seed)`` when ``shuffle``); ``next()`` returns
``(tokens, labels)``, int32 ``[batch, seq_len]`` numpy arrays, the labels
the tokens shifted by one. The port binds the library itself through
``ctypes``: ``csrc/data_feed.cc`` and ``csrc/pt_error.cc`` (read as they
are) are compiled with ``g++`` into
``paddle_tpu_torch/csrc/build/libpt_token_feed-<hash>.so`` at first use,
the hash covering the sources, the header and the flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "csrc"
BUILD_DIR = REPO / "paddle_tpu_torch" / "csrc" / "build"
SOURCES = ("data_feed.cc", "pt_error.cc")
HEADERS = ("pt_common.h",)
FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread"]

_lib = None
_lock = threading.Lock()


def _target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"libpt_token_feed-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library, compiled first if no build of these sources exists;
    raises with the compiler's output if it fails."""
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, f"-I{CSRC}", "-o", str(tmp),
           *(str(CSRC / f) for f in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"token feed build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or none
    return target


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            c = ctypes
            lib.pt_last_error.restype = c.c_char_p
            lib.pt_feed_create.restype = c.c_void_p
            lib.pt_feed_create.argtypes = [c.c_char_p, c.c_int64, c.c_int64,
                                           c.c_int, c.c_uint64, c.c_int]
            lib.pt_feed_num_windows.restype = c.c_int64
            lib.pt_feed_num_windows.argtypes = [c.c_void_p]
            lib.pt_feed_next.restype = c.c_int
            lib.pt_feed_next.argtypes = [c.c_void_p, c.c_void_p]
            lib.pt_feed_destroy.argtypes = [c.c_void_p]
            _lib = lib
        return _lib


class NativeTokenLoader:
    """An endless iterator of ``(tokens, labels)`` batches over the token
    file at ``path`` (module docstring)."""

    def __init__(self, path: str, seq_len: int, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 prefetch_depth: int = 4):
        self._lib = library()
        self._h = self._lib.pt_feed_create(
            str(path).encode(), seq_len, batch_size, 1 if shuffle else 0,
            seed, prefetch_depth)
        if not self._h:
            raise RuntimeError("NativeTokenLoader failed: "
                               f"{self._lib.pt_last_error().decode()}")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self._buf = np.empty((batch_size, seq_len + 1), np.int32)

    @property
    def num_windows(self) -> int:
        return int(self._lib.pt_feed_num_windows(self._h))

    def next(self):
        """Blocks for the next batch: (tokens [B, S], labels [B, S])."""
        if self._lib.pt_feed_next(
                self._h, self._buf.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise StopIteration
        return self._buf[:, :-1].copy(), self._buf[:, 1:].copy()

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.pt_feed_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
