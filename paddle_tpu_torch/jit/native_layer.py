"""The jit artifact container: the counterpart of
``paddle_tpu/jit/native_layer.py`` (whose C++ side is ``csrc/jit_layer.cc``).

A Python ``mmap`` reader of what ``jit.save`` writes: ``<prefix>.pdiparams``
(8-byte little-endian header length, a JSON header of name -> dtype, shape
and byte offsets, then the raw buffers) and ``<prefix>.pdmodel`` (the
program). The parameters are zero-copy read-only views into the mapped
file. What the C++ container refuses is refused here, before any view is
made: a missing file, a header whose length runs past the file, a header
that is not JSON, and offsets outside the data or disagreeing with the
dtype and shape.
"""
from __future__ import annotations

import json
import mmap
import os
from typing import Dict, List

import numpy as np


class HeaderError(RuntimeError):
    """The file does not start with the container's header (a legacy
    pickle file, or a corrupt one)."""


def _np_dtype(name: str):
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


def _open(path: str):
    try:
        f = open(path, "rb")
    except OSError as e:
        raise RuntimeError(f"jit container: cannot open {path}: "
                           f"{e.strerror}") from None
    with f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return b"", size
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ), size


def _parse(path: str, buf, size: int):
    """The header's entries as (name, dtype, shape, start, stop), checked
    against the file."""
    if size < 8:
        raise HeaderError(f"jit container: {path}: truncated header")
    n = int.from_bytes(buf[:8], "little")
    if n > size - 8:
        raise HeaderError(f"jit container: {path}: header length {n} "
                          f"runs past the file ({size} bytes)")
    try:
        metas = json.loads(bytes(buf[8:8 + n]).decode())
    except (UnicodeDecodeError, ValueError):
        raise HeaderError(f"jit container: {path}: no JSON header") \
            from None
    if not isinstance(metas, dict):
        raise HeaderError(f"jit container: {path}: header is not a map")
    base, data = 8 + n, size - 8 - n
    out = []
    for name, m in metas.items():
        lo, hi = (int(x) for x in m["offsets"])
        dtype = _np_dtype(m["dtype"])
        shape = tuple(int(d) for d in m["shape"])
        if not 0 <= lo <= hi <= data:
            raise RuntimeError(f"jit container: {path}: offsets [{lo}, "
                               f"{hi}) of '{name}' out of bounds "
                               f"({data} data bytes)")
        if hi - lo != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise RuntimeError(f"jit container: {path}: '{name}' holds "
                               f"{hi - lo} bytes, not {shape} {dtype}")
        out.append((name, dtype, shape, base + lo, base + hi))
    return out


class NativeJitLayer:
    """The artifact at ``path_prefix`` (``.pdiparams`` memory-mapped,
    ``.pdmodel`` read on demand)."""

    def __init__(self, path_prefix: str):
        self._prefix = path_prefix
        self._buf, size = _open(path_prefix + ".pdiparams")
        self._entries = _parse(path_prefix + ".pdiparams", self._buf, size)

    @staticmethod
    def params_of(path: str) -> Dict[str, np.ndarray]:
        """The parameters of one ``.pdiparams`` file, as views."""
        layer = NativeJitLayer.__new__(NativeJitLayer)
        layer._prefix = path[:-len(".pdiparams")] \
            if path.endswith(".pdiparams") else path
        layer._buf, size = _open(path)
        layer._entries = _parse(path, layer._buf, size)
        return layer.state_dict()

    # ------------------------------------------------------------ params
    def num_params(self) -> int:
        return len(self._entries)

    def param_names(self) -> List[str]:
        return [e[0] for e in self._entries]

    def param(self, i: int) -> np.ndarray:
        """Zero-copy read-only view into the mapped file."""
        _, dtype, shape, lo, hi = self._entries[i]
        arr = np.frombuffer(self._buf, dtype=dtype, count=(hi - lo)
                            // dtype.itemsize, offset=lo).reshape(shape)
        arr.flags.writeable = False
        return arr

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {e[0]: self.param(i) for i, e in enumerate(self._entries)}

    # ----------------------------------------------------------- program
    def program_bytes(self) -> bytes:
        try:
            with open(self._prefix + ".pdmodel", "rb") as f:
                return f.read()
        except OSError:
            return b""
