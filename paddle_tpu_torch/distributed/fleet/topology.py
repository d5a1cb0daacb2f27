"""The hybrid-parallel topology: the counterpart of
``paddle_tpu/distributed/fleet/topology.py`` (upstream
``fleet/base/topology.py``).

``CommunicateTopology`` numbers the ranks of an N-D grid over the axes
``pipe``, ``data``, ``sharding``, ``sep``, ``model`` (the last varies
fastest), exactly as the reference does. ``HybridCommunicateGroup`` gives
this rank its coordinate on each axis and the ``Group`` of its line along
each. Its ``mesh`` is the port's ``ProcessMesh`` of the same grid over
``["pp", "dp", "sharding", "sep", "mp"]``, and the groups are that mesh's:
``torch.distributed.new_group`` is collective over the whole world, so
every rank makes every line's group of every axis, in one order (the
reference makes only the groups that hold it), through the mesh's group
cache, which a mesh of the same lines shares. Before
``init_parallel_env`` (one process, no process group) each group has no
process group, as the reference's one-rank groups.
"""
from __future__ import annotations

from itertools import product
from typing import Dict

import numpy as np
import torch.distributed as dist

from ..mesh import ProcessMesh
from ..parallel_env import get_rank
from ..process_group import Group, _groups

# the topology's axis names and the mesh's, in grid order
AXES = ("pipe", "data", "sharding", "sep", "model")
MESH_AXES = ("pp", "dp", "sharding", "sep", "mp")


class CommunicateTopology:
    def __init__(self, hybrid_group_names=AXES, dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = int(np.prod(dims))
        self._rank_arr = np.arange(self._world).reshape(dims)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(self._rank_arr[tuple(coords)])

    def get_coord(self, rank):
        coords = np.argwhere(self._rank_arr == rank)[0]
        return dict(zip(self._parallel_names, coords.tolist()))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return sorted(np.asarray(self._rank_arr[tuple(sl)]).flatten()
                      .tolist())

    def get_comm_list(self, axis_name):
        """Every line of ranks along ``axis_name``, one for each
        combination of the other axes' indices."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for combo in product(*[range(d) for d in other_dims]):
            idx = list(combo)
            idx.insert(axis, slice(None))
            groups.append(np.asarray(
                self._rank_arr[tuple(idx)]).flatten().tolist())
        return groups


class HybridCommunicateGroup:
    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = get_rank()
        self._dp_degree = topology.get_dim("data")
        self._mp_degree = topology.get_dim("model")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep")
        coord = topology.get_coord(self.global_rank)
        self._dp_rank = coord["data"]
        self._mp_rank = coord["model"]
        self._pp_rank = coord["pipe"]
        self._sharding_rank = coord["sharding"]
        self._sep_rank = coord["sep"]
        self.mesh = ProcessMesh(
            np.arange(topology.world_size()).reshape(
                [topology.get_dim(n) for n in AXES]),
            dim_names=list(MESH_AXES))
        # every line's group of every axis, made on every rank
        pgs = self.mesh.groups() if dist.is_initialized() else {}
        self._groups: Dict[str, Group] = {}
        for name, axis in zip(AXES, MESH_AXES):
            line = self.mesh.line(axis, self.global_rank)
            g = Group(line, pg=pgs.get(axis), name=f"hcg_{name}")
            _groups[g.id] = g
            self._groups[name] = g

    # ------------------------------------------------------------- info
    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._mp_degree > 1 or self._sep_degree > 1:
            return "model_parallel"
        if self._dp_degree > 1:
            return "data_parallel"
        return "single"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    # model parallel
    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    # pipeline
    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    # sep
    def get_sep_parallel_rank(self):
        return self._sep_rank

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._groups["sep"]


_hcg: HybridCommunicateGroup = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group():
    return _hcg
