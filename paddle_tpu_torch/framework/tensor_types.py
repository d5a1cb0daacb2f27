"""Non-dense tensor types: SelectedRows, TensorArray, StringTensor; the
counterpart of ``paddle_tpu/framework/tensor_types.py``.

Analogs of the reference's extra TensorBase subclasses
(paddle/phi/core/selected_rows.h, tensor_array.h, string_tensor.h):

- SelectedRows: sparse-row value holder — `rows` (int64 row ids into a
  logical [height, ...] tensor) + `value` (the rows' payload), as used for
  embedding gradients and sparse tables. merge() accumulates duplicate ids
  (the reference's MergeAdd functor) as one ``index_add``.
- TensorArray: dynamically sized list of tensors (while-loop / RNN
  staging, paddle.tensor.array_* API); a plain staging list with
  stack/concat materialization.
- StringTensor: object-dtype host tensor for text pipelines
  (strings_ops.yaml family); lower/upper/strip transforms over numpy
  object arrays.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .._core.tensor import Tensor, to_tensor

__all__ = ["SelectedRows", "TensorArray", "StringTensor",
           "create_array", "array_write", "array_read", "array_length"]


class SelectedRows:
    def __init__(self, rows: Sequence[int], value, height: int):
        self.rows = [int(r) for r in rows]
        self.value = value if isinstance(value, Tensor) else \
            Tensor(value) if isinstance(value, torch.Tensor) else \
            to_tensor(value)
        self.height = int(height)
        if self.value.shape[0] != len(self.rows):
            raise ValueError(
                f"value has {self.value.shape[0]} rows, ids give "
                f"{len(self.rows)}")

    @property
    def shape(self):
        return [self.height] + list(self.value.shape[1:])

    def merge(self) -> "SelectedRows":
        """Accumulate duplicate row ids (MergeAdd,
        selected_rows_functor.h). Deterministic id order."""
        uniq, inv = np.unique(np.asarray(self.rows, np.int64),
                              return_inverse=True)
        v = self.value._t
        merged = torch.zeros((len(uniq),) + tuple(v.shape[1:]),
                             dtype=v.dtype, device=v.device)
        merged.index_add_(0, torch.as_tensor(inv.reshape(-1),
                                             device=v.device), v)
        return SelectedRows(uniq.tolist(), Tensor(merged), self.height)

    def to_dense(self) -> Tensor:
        m = self.merge()
        v = m.value._t
        dense = torch.zeros((self.height,) + tuple(v.shape[1:]),
                            dtype=v.dtype, device=v.device)
        dense[torch.as_tensor(m.rows, dtype=torch.int64,
                              device=v.device)] = v
        return Tensor(dense)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"rows={self.rows[:8]}{'...' if len(self.rows) > 8 else ''}, "
                f"value.shape={self.value.shape})")


class TensorArray:
    """LoDTensorArray analog (paddle.framework core.LoDTensorArray)."""

    def __init__(self, tensors: Optional[List[Tensor]] = None):
        self._items: List[Tensor] = list(tensors or [])

    def append(self, t: Tensor):
        self._items.append(t)
        return self

    def pop(self, idx: int = -1) -> Tensor:
        return self._items.pop(idx)

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, t):
        if i == len(self._items):   # array_write at end grows the array
            self._items.append(t)
        else:
            self._items[i] = t

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def stack(self, axis: int = 0) -> Tensor:
        return Tensor(torch.stack([t._t for t in self._items], axis))

    def concat(self, axis: int = 0) -> Tensor:
        return Tensor(torch.cat([t._t for t in self._items], axis))


def create_array(dtype="float32", initialized_list=None) -> TensorArray:
    """paddle.tensor.create_array (array.py) analog."""
    return TensorArray(list(initialized_list) if initialized_list else [])


def array_write(x: Tensor, i, array: Optional[TensorArray] = None):
    if array is None:
        array = TensorArray()
    idx = int(i.numpy()) if isinstance(i, Tensor) else int(i)
    array[idx] = x
    return array


def array_read(array: TensorArray, i) -> Tensor:
    idx = int(i.numpy()) if isinstance(i, Tensor) else int(i)
    return array[idx]


def array_length(array: TensorArray) -> int:
    return len(array)


class StringTensor:
    def __init__(self, data, name: Optional[str] = None):
        arr = np.asarray(data, dtype=object)
        self._data = arr
        self.name = name

    @property
    def shape(self):
        return list(self._data.shape)

    def numpy(self) -> np.ndarray:
        return self._data

    def _map(self, fn) -> "StringTensor":
        out = np.empty_like(self._data)
        flat_in = self._data.reshape(-1)
        flat_out = out.reshape(-1)
        for i, s in enumerate(flat_in):
            flat_out[i] = fn(s)
        return StringTensor(out, name=self.name)

    def lower(self):
        return self._map(str.lower)

    def upper(self):
        return self._map(str.upper)

    def strip(self):
        return self._map(str.strip)

    def __getitem__(self, idx):
        out = self._data[idx]
        return out if isinstance(out, str) else StringTensor(out)

    def __repr__(self):
        return f"StringTensor(shape={self.shape})"
