"""paddle.framework: the counterpart of ``paddle_tpu/framework``.

``save`` / ``load`` (python/paddle/framework/io.py:773,1020): pickled
state dicts with tensors materialized to numpy, in the reference's format
(each tensor a ``{"__tensor__": True, "data": array, "stop_gradient":
bool}`` dict; bfloat16 as ml_dtypes' bfloat16), so either package loads
the other's files. ``lazy_guard``, ``enable_eager_fusion`` and
``eager_fusion_enabled`` are the lazy runtime's (``_core/lazy.py``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .._core.lazy import (eager_fusion_enabled, enable_eager_fusion,  # noqa
                          lazy_guard)
from .._core.tensor import Tensor, to_tensor

__all__ = ["save", "load", "seed", "lazy_guard", "enable_eager_fusion",
           "eager_fusion_enabled"]


def _to_saveable(obj):
    if isinstance(obj, Tensor):
        from ..jit.api import _numpy
        return {"__tensor__": True, "data": _numpy(obj._t),
                "stop_gradient": obj.stop_gradient}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            data = np.asarray(obj["data"])
            return to_tensor(data, dtype=data.dtype.name,
                             stop_gradient=obj["stop_gradient"])
        return {k: _from_saved(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        return _from_saved(pickle.load(f))


def seed(s):
    from .._core import random as rnd
    return rnd.seed(s)


from .tensor_types import (  # noqa: E402,F401
    SelectedRows, StringTensor, TensorArray,
    array_length, array_read, array_write, create_array,
)

__all__ += ["SelectedRows", "TensorArray", "StringTensor", "create_array",
            "array_write", "array_read", "array_length"]
