"""Moving parameter and optimizer-state trees in from numpy, and cutting
them into the shards of a mesh.

The JAX package's trees become numpy trees with ``jax.device_get``; these
functions turn such a tree into the port's tensors, leaf for leaf and key
for key. bf16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
does not take) go through float32, which holds every bf16 value exactly.
``shard_for_rank`` cuts a whole tree to one rank's shards by a tree of
``PartitionSpec`` (the reference's ``param_specs``), and ``gather_shards``
puts the ranks' shards back together.
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


# ----------------------------------------------------------- mesh shards

def _path_groups(split_groups, path):
    node = split_groups or {}
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return 1
        node = node[k]
    return node if isinstance(node, int) else 1


def shard_index(shape, spec, mesh, coords, groups: int = 1):
    """The index of one rank's block in a whole array of ``shape`` split by
    ``spec`` (per dim an axis name or None) over ``mesh``, the rank given
    by its ``coords`` (axis name -> index). With ``groups`` > 1 the last
    dim is that many equal groups, and its split over ``mp`` takes the
    rank's part of every group (a fused ``[q | k | v]`` weight split by
    heads); a split over another axis (ZeRO-1's over dp) stays
    contiguous."""
    idx = []
    for dim, size in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            idx.append(slice(None))
            continue
        n = mesh.get_dim_size(axis)
        g = groups if dim == len(shape) - 1 and axis == "mp" else 1
        if size % (n * g):
            raise ValueError(f"dim {dim} of size {size} does not split into "
                             f"{g} groups over {n} ranks of {axis}")
        step = size // (n * g)
        i = coords[axis]
        if g == 1:
            idx.append(slice(i * step, (i + 1) * step))
        else:
            idx.append(np.concatenate([k * (size // g) + i * step
                                       + np.arange(step) for k in range(g)]))
    return tuple(idx)


def _take(arr, idx):
    if isinstance(arr, torch.Tensor):
        idx = tuple(torch.as_tensor(i, device=arr.device)
                    if isinstance(i, np.ndarray) else i for i in idx)
        return arr[idx].clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(np.asarray(arr)[idx])


def shard_for_rank(tree, specs, mesh, rank: Optional[int] = None,
                   split_groups=None):
    """A whole tree (numpy arrays or tensors, e.g. the reference's params or
    state after ``jax.device_get``) cut to one rank's shards, by ``specs``
    (a tree of ``PartitionSpec``); ``rank`` None: this process's.
    ``split_groups`` (a sparse tree of ints) names the leaves whose last
    dim holds equal groups (:func:`shard_index`)."""
    coords = mesh.coords(rank)

    def walk(t, sp, path):
        if isinstance(t, dict):
            return {k: walk(v, sp[k], path + (k,)) for k, v in t.items()}
        return _take(t, shard_index(t.shape, sp, mesh, coords,
                                    _path_groups(split_groups, path)))

    return walk(tree, specs, ())


def gather_shards(shards, specs, mesh, split_groups=None):
    """The inverse of :func:`shard_for_rank`: ``shards[r]`` is rank r's
    tree of numpy arrays; returns the whole tree. Ranks that hold the same
    block must hold the same values (raises otherwise)."""

    def walk(parts, sp, path):
        if isinstance(parts[0], dict):
            return {k: walk([p[k] for p in parts], sp[k], path + (k,))
                    for k in parts[0]}
        g = _path_groups(split_groups, path)
        local = np.asarray(parts[0]).shape
        whole_shape = tuple(
            d * (mesh.get_dim_size(sp[i]) if i < len(sp) and sp[i] else 1)
            for i, d in enumerate(local))
        out = np.zeros(whole_shape, np.asarray(parts[0]).dtype)
        seen = {}
        for r in mesh.process_ids:
            idx = shard_index(whole_shape, sp, mesh, mesh.coords(r), g)
            key = repr(idx)
            block = np.asarray(parts[r])
            if key in seen:
                if not np.array_equal(seen[key], block):
                    raise ValueError(f"{'/'.join(path)}: replicas of one "
                                     f"block differ (rank {r})")
                continue
            seen[key] = block
            out[idx] = block
        return out

    return walk(list(shards), specs, ())
