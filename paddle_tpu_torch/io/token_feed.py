"""``NativeTokenLoader``: the counterpart of ``paddle_tpu/io/token_feed.py``
over the repo's C++ token feed (``csrc/data_feed.cc``).

A C++ thread ``mmap``s a flat int32 token file and keeps a ring of
``prefetch_depth`` batches of ``[batch, seq_len + 1]`` windows (shuffled
by ``std::mt19937_64(seed)`` when ``shuffle``); ``next()`` returns
``(tokens, labels)``, int32 ``[batch, seq_len]`` numpy arrays, the labels
the tokens shifted by one. The feed is in the runtime library that
``_core/native.py`` builds from the repo's C++ sources (``csrc/data_feed.cc``
among them, read as they are) with ``g++`` into
``paddle_tpu_torch/csrc/build/`` at first use.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .._core import native


def build() -> Path:
    """The runtime library the feed is in, compiled first if it is missing
    or stale; raises with the compiler's output if it fails."""
    return native.build_runtime()


def library() -> ctypes.CDLL:
    return native.get_lib(required=True)


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
