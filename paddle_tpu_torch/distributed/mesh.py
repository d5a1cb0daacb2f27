"""ProcessMesh: the N-D logical mesh of ranks, the counterpart of
``paddle_tpu/distributed/mesh.py``.

A mesh names the ranks of ``torch.distributed``'s default group by their
coordinates. ``ProcessMesh(np.arange(8).reshape(2, 2, 2), ["dp", "pp",
"mp"])`` puts rank r where the reference's ``np.reshape(devices, (dp, pp,
mp))`` puts device r: the last axis varies fastest. Each axis has one
process group per line of the mesh along it; ``get_group(name)`` is the
one through this rank. A mesh names processes by their ids, which are
their torch ranks until ``parallel_env.rebuild_world`` forms a world again
after a membership change (then ``parallel_env.rank_of`` maps an id to
its rank, in the same order). ``torch.distributed.new_group`` is
collective over the whole world, so the first ``groups()`` or
``get_group`` of a mesh
makes every line's group of every axis at once, and every rank of the
world, in the mesh or not, makes that call at the same point of its
program (the mesh trainers do so when they are built).

``PartitionSpec`` is the port's own: a tuple with an axis name or None per
dim, as the reference's ``jax.sharding.PartitionSpec`` is used in its
param specs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

_global_mesh: Optional["ProcessMesh"] = None
# process groups by their ranks: a line of a mesh is the same group in
# every mesh that has it (every rank makes the same meshes, so every rank
# finds the same groups here and calls new_group for the same others)
_GROUPS: Dict[Tuple[int, ...], object] = {}


class PartitionSpec(tuple):
    """Per dim, the mesh axis it is split over, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _forget_groups() -> None:
    _GROUPS.clear()


def _group(ids: Sequence[int]):
    """The process group of the processes ``ids`` (their ranks follow the
    ids' order)."""
    from .parallel_env import rank_of
    key = tuple(int(r) for r in ids)
    if list(key) != sorted(key):
        # a group numbers its ranks in increasing order; the shard-local
        # code takes that number for the axis index
        raise ValueError(f"a line of a mesh is not in increasing rank "
                         f"order: {list(key)}")
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group([rank_of(i) for i in key])
    return _GROUPS[key]


class ProcessMesh:
    def __init__(self, mesh: Sequence = None,
                 dim_names: Optional[List[str]] = None, shape=None,
                 process_ids=None):
        if shape is not None and process_ids is not None:
            arr = np.asarray(process_ids).reshape(shape)
        else:
            arr = np.asarray(mesh)
        self._mesh_arr = arr
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError("dim_names length must match mesh ndim")
        self._dim_names = list(dim_names)
        self._mine: Dict[str, object] = {}  # this rank's coords and groups

    # ------------------------------------------------------------- info
    @property
    def shape(self):
        return list(self._mesh_arr.shape)

    @property
    def ndim(self):
        return self._mesh_arr.ndim

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def mesh(self):
        return self._mesh_arr

    @property
    def process_ids(self):
        return self._mesh_arr.flatten().tolist()

    @property
    def size(self):
        return int(self._mesh_arr.size)

    def get_dim_size(self, name):
        return self._mesh_arr.shape[self._dim_names.index(name)]

    def axis_size(self, name) -> int:
        """The size of axis ``name``; 1 for an axis the mesh does not
        have."""
        return self.get_dim_size(name) if name in self._dim_names else 1

    def get_rank_by_dim_and_process_id(self, dim, pid):
        idx = np.argwhere(self._mesh_arr == pid)
        if idx.size == 0:
            return -1
        return int(idx[0][self._dim_names.index(dim)])

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> index of ``rank`` (default: this process's)."""
        if rank is None:
            if "coords" not in self._mine:
                from .parallel_env import process_id
                self._mine["coords"] = self.coords(process_id())
            return self._mine["coords"]
        idx = np.argwhere(self._mesh_arr == rank)
        if idx.size == 0:
            raise ValueError(f"rank {rank} is not in {self!r}")
        return dict(zip(self._dim_names, (int(i) for i in idx[0])))

    def axis_index(self, name, rank: Optional[int] = None) -> int:
        """This rank's index along ``name`` (0 for an axis the mesh does
        not have)."""
        if name not in self._dim_names:
            return 0
        return self.coords(rank)[name]

    def line(self, name, rank: Optional[int] = None) -> List[int]:
        """The ranks of the mesh's line along ``name`` through ``rank``, in
        axis order."""
        c = self.coords(rank)
        index = tuple(slice(None) if d == name else c[d]
                      for d in self._dim_names)
        return [int(r) for r in self._mesh_arr[index]]

    def get_group(self, dim_name=None):
        """The process group of this rank's line along ``dim_name`` (None:
        the whole mesh, made on first use by every rank of the world)."""
        if dim_name is None:
            return _group(sorted(self.process_ids))
        return self.groups()[dim_name]

    def groups(self) -> Dict[str, object]:
        """Every axis's group through this rank (empty on a rank outside
        the mesh). The first call makes the groups of every line of every
        axis, in axis order: every rank of the world calls it."""
        from .parallel_env import process_id, world_generation
        if self._mine.get("world") != world_generation():
            self._mine.pop("groups", None)
            self._mine["world"] = world_generation()
        if "groups" not in self._mine:
            made = {}
            rank = process_id()
            for i, name in enumerate(self._dim_names):
                lines = np.moveaxis(self._mesh_arr, i, -1).reshape(
                    -1, self._mesh_arr.shape[i])
                for line in lines:
                    group = _group(line)
                    if rank in line:
                        made[name] = group
            self._mine["groups"] = made
        return self._mine["groups"]

    def __getstate__(self):  # groups belong to one process
        return {**self.__dict__, "_mine": {}}

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._dim_names == other._dim_names
                and np.array_equal(self._mesh_arr, other._mesh_arr))

    def __hash__(self):
        return hash((tuple(self._dim_names), self._mesh_arr.tobytes()))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")


def auto_mesh(*dim_sizes, dim_names=None) -> ProcessMesh:
    """A mesh over ranks ``0 .. prod(dim_sizes) - 1`` in row-major order."""
    n = int(np.prod(dim_sizes))
    return ProcessMesh(np.arange(n).reshape(dim_sizes), dim_names)


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


def set_mesh(mesh: ProcessMesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh


def init_device_mesh(mesh_shape, mesh_dim_names=None):
    return auto_mesh(*mesh_shape, dim_names=list(mesh_dim_names)
                     if mesh_dim_names else None)
