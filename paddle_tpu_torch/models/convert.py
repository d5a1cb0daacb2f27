"""Moving parameter and optimizer-state trees in from numpy.

The JAX package's trees become numpy trees with ``jax.device_get``; these
functions turn such a tree into the port's tensors, leaf for leaf and key
for key. bf16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
does not take) go through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._core.device import DeviceLike, resolve_device
from .trainer import tree_map

_NUMPY_TO_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def tensor_from_numpy(arr, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array as a tensor on ``device``, in ``dtype`` (default: the
    array's own type)."""
    arr = np.asarray(arr)
    src = _NUMPY_TO_TORCH.get(arr.dtype.name)
    if src is None:
        raise TypeError(f"no torch dtype for numpy {arr.dtype}")
    if src is torch.bfloat16:
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())  # device_get arrays are read-only
    return t.to(device=resolve_device(device), dtype=dtype or src)


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """A nested dict of arrays (the reference's param tree) as tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev, dtype), tree)


def state_from_numpy(state: Dict[str, Any],
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The reference trainer's ``{params, master, m, v, step}`` state as the
    port's trainer state: each leaf keeps its type (bf16 or fp32 params,
    fp32 master and moments, int32 step)."""
    dev = resolve_device(device)
    out = {k: params_from_numpy(state[k], dev)
           for k in ("params", "master", "m", "v")}
    out["step"] = tensor_from_numpy(state["step"], dev, torch.int32)
    return out


def optimizer_state_renamed(state: Dict[str, Any], src_names,
                            dst_names) -> Dict[str, Any]:
    """An eager optimizer's ``state_dict`` (keys ``<param name>.<state>``,
    ``step``, ``LR_Scheduler``) with each parameter's name in ``src_names``
    replaced by the one at the same position in ``dst_names``: the two
    packages name parameters from counters of their own, so a state
    crosses by the order of the parameters, as the model's weights cross
    by their attribute paths. Values are passed through as they are
    (numpy arrays go into ``set_state_dict``)."""
    rename = dict(zip(src_names, dst_names))
    out = {}
    for key, value in state.items():
        name, dot, rest = key.rpartition(".")
        out[f"{rename.get(name, name)}.{rest}" if dot else key] = value
    return out
