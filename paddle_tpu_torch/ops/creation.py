"""Tensor creation: the counterpart of ``paddle_tpu/ops/creation.py``.

Every function creates on the current device (``set_device``; the card
unless the caller chose the CPU) and uses the reference's default types:
float32 for ``zeros``/``ones``, int64 for integer ``arange`` and ``full``,
float32 for float ones.
"""
from __future__ import annotations

import torch

from .._core import dtype as dtypes
from .._core.device import default_device
from .._core.tensor import Tensor, to_tensor  # noqa: F401 (re-export)


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)


def _dt(dtype, default=torch.float32) -> torch.dtype:
    return default if dtype is None else dtypes.to_torch(dtype)


def zeros(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype),
                              device=default_device()))


def ones(shape, dtype=None, name=None) -> Tensor:
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype),
                             device=default_device()))


def _scalar_dtype(value) -> torch.dtype:
    if isinstance(value, bool):
        return torch.bool
    return torch.int64 if isinstance(value, int) else torch.float32


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full(_shape(shape), fill_value,
                             dtype=_dt(dtype, _scalar_dtype(fill_value)),
                             device=default_device()))


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    if end is None:
        start, end = 0, start
    bounds = (start, end, step)
    if any(isinstance(v, Tensor) for v in bounds):
        raise TypeError("arange with Tensor bounds: pass python scalars")
    default = torch.int64 if all(isinstance(v, int) for v in bounds) \
        else torch.float32
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype, default),
                               device=default_device()))
