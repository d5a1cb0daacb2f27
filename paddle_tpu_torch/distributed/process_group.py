"""Groups of ranks and the reduction kinds of the eager communication API:
the counterpart of ``Group``, ``ReduceOp``, ``new_group`` and ``get_group``
of ``paddle_tpu/distributed/communication.py`` (whose transport is the
store-backed ``process_group.py`` and the host ring of
``csrc/comm_context.cc``).

A ``Group`` wraps a ``torch.distributed`` process group, made by
``init_parallel_env`` (the default group) or ``new_group``: on a card the
group carries NCCL for CUDA tensors and gloo for CPU tensors, on the CPU
gloo alone. ``new_group`` is collective over the whole world, as
``torch.distributed.new_group`` is: every rank calls it at the same point,
member or not. Ranks are global ranks, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch.distributed as dist


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


# the torch reduction of each kind; AVG is a SUM divided by the group size
# (gloo has no average)
TORCH_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
             "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
             "prod": dist.ReduceOp.PRODUCT}


class Group:
    """A set of global ranks and the process group that connects them
    (None before ``init_parallel_env``: a one-rank group needs none)."""

    _next_id = [0]

    def __init__(self, ranks: List[int], pg=None, name: Optional[str] = None):
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.id = Group._next_id[0]
        Group._next_id[0] += 1
        self.name = name or f"group_{self.id}"
        self.pg = pg

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def process_group(self):
        return self.pg

    @property
    def rank(self) -> int:
        """This process's rank in the group, -1 outside it."""
        return self.get_group_rank(dist.get_rank()
                                   if dist.is_initialized() else 0)

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_default_group: Optional[Group] = None
_groups: Dict[int, Group] = {}


def default_group() -> Group:
    """The group of every rank: the world's process group once there is
    one (made again if the process joined a world after a first call)."""
    global _default_group
    if _default_group is None or (_default_group.pg is None
                                  and dist.is_initialized()):
        from .parallel_env import get_world_size
        pg = dist.group.WORLD if dist.is_initialized() else None
        _default_group = Group(list(range(get_world_size())), pg=pg,
                               name="_default_pg")
        _groups[0] = _default_group
    return _default_group


def _forget_groups() -> None:
    """Drops the default group and every ``Group`` made so far (their
    process groups are gone with the world's)."""
    global _default_group
    _default_group = None
    _groups.clear()


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group of ``ranks`` (all ranks when None). Every rank of the world
    calls it, in the same order."""
    from .parallel_env import get_world_size
    if ranks is None:
        ranks = list(range(get_world_size()))
    pg = None
    if dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(sorted(int(r) for r in ranks), **kw)
    g = Group(sorted(int(r) for r in ranks), pg=pg)
    _groups[g.id] = g
    return g


def get_group(gid: int = 0) -> Group:
    """The group of id ``gid``; the default group for an unknown id."""
    return _groups.get(gid) or default_group()


def get_backend(group: Optional[Group] = None) -> str:
    """The backend of the group's device collectives: ``NCCL`` where it has
    one (a card's group), else ``GLOO`` (the reference answers ``xla``)."""
    g = group or default_group()
    if g.pg is not None:
        name = str(dist.get_backend(g.pg))
    else:
        import torch
        name = "nccl" if torch.cuda.is_available() else "gloo"
    return "NCCL" if "nccl" in name else "GLOO"
