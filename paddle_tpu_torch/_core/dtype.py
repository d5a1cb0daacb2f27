"""Data types: the counterpart of ``paddle_tpu/_core/dtype.py``.

Paddle's dtype objects (``paddle.float32`` ...) are named wrappers over
``torch.dtype``s, so user code writes them the way Paddle users do and
compares them with strings (``x.dtype == "float32"``). The integer default
is int64, as in the reference (which turns on JAX's x64 mode for it).
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """A framework dtype. Compares equal to its name, to itself and to its
    ``torch.dtype``."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name: str, torch_dtype: torch.dtype):
        self.name = name
        self.torch_dtype = torch_dtype

    def __repr__(self):
        return f"paddle.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        if isinstance(other, str):
            return self.name == other
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        return NotImplemented

    def __hash__(self):
        return hash(self.name)


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALL = [bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
        float64, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME["bool_"] = bool_
_BY_TORCH = {d.torch_dtype: d for d in _ALL}


def to_dtype(d) -> DType:
    """str, ``DType``, ``torch.dtype`` or numpy dtype -> ``DType``."""
    if d is None or isinstance(d, DType):
        return d
    if isinstance(d, torch.dtype):
        return _BY_TORCH[d]
    if isinstance(d, str) and d in _BY_NAME:
        return _BY_NAME[d]
    name = np.dtype(d).name  # raises TypeError on what numpy cannot read
    if name not in _BY_NAME:
        raise TypeError(f"unsupported dtype: {d!r}")
    return _BY_NAME[name]


def to_torch(d) -> torch.dtype:
    return to_dtype(d).torch_dtype


def from_torch(d: torch.dtype) -> DType:
    return _BY_TORCH[d]
