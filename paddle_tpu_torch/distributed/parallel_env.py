"""Process-group setup: the counterpart of
``paddle_tpu/distributed/parallel_env.py``.

One process per rank. ``init_parallel_env`` joins this process to the
job's default process group over ``torch.distributed``: NCCL, one rank per
card (with gloo beside it for CPU tensors), unless the caller asks for the
CPU (``device="cpu"``), which takes gloo alone. The rendezvous is
``init_method`` when given (``file://...`` or
``tcp://host:port``), else the environment (``MASTER_ADDR`` and
``MASTER_PORT``, as ``torchrun`` sets them). Rank and world size come from
the arguments, else from ``RANK``/``WORLD_SIZE``, else from the
reference's ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``.

Every bring-up of a process group fires the ``pg::init`` fault site inside
``retry.bringup_policy()``; a retried bring-up rendezvouses under the same
key on every attempt.

After a membership change the world is formed again: torch cannot shrink
or grow a process group, so ``rebuild_world`` leaves the old one and joins
a new one over the members, through a ``PrefixStore`` keyed by the
membership epoch on one ``torch.distributed.TCPStore`` that lives as long
as the job (``rendezvous_store``). A mesh keeps naming processes by their
ids from before (``ProcessMesh([0, 2, 3])`` after losing 1); the new world
numbers them by id in increasing order, and ``process_id`` and
``rank_of`` map between the two (the identity until a rebuild).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .._core.device import DeviceLike, resolve_device

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)

# this process's id and the torch rank of each member's id, set by
# rebuild_world (None: the identity)
_PROCESS_ID: Optional[int] = None
_RANK_OF: Optional[Dict[int, int]] = None
# bumped whenever the world is made or left: a mesh's cached groups belong
# to the world they were made in
_GENERATION = 0
# the job-long rendezvous store of rebuild_world (torch.distributed.TCPStore)
# and the membership epoch of the last world it formed
_RDZV = None
_EPOCH = 0
_RDZV_KEY = "__elastic/rdzv"


def _env_int(names, default: int) -> int:
    for name in names:
        value = os.environ.get(name)
        if value is not None:
            try:
                return int(value)
            except ValueError:
                pass
    return default


class ParallelEnv:
    """This process's rank, the world size and its card, from the process
    group once it exists, else from the environment."""

    def __init__(self):
        if dist.is_initialized():
            self.rank = dist.get_rank()
            self.world_size = dist.get_world_size()
        else:
            self.rank = _env_int(("RANK", "PADDLE_TRAINER_ID"), 0)
            self.world_size = _env_int(("WORLD_SIZE", "PADDLE_TRAINERS_NUM"),
                                       1)
        self.device_id = _env_int(("LOCAL_RANK", "FLAGS_selected_gpus"),
                                  self.rank)
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = eps.split(",") if eps else []
        self.current_endpoint = os.environ.get(
            "PADDLE_CURRENT_ENDPOINT",
            self.trainer_endpoints[self.rank]
            if self.rank < len(self.trainer_endpoints) else "127.0.0.1:6170")

    @property
    def local_rank(self):
        return self.device_id

    @property
    def nranks(self):
        return self.world_size

    @property
    def dev_id(self):
        return self.device_id


def init_parallel_env(init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      device: DeviceLike = None) -> ParallelEnv:
    """Join the default process group (once; later calls return the
    environment). ``device`` None or CUDA: NCCL for CUDA tensors and gloo
    for CPU ones, and this process's card becomes ``cuda:<local rank>``;
    ``"cpu"``: gloo."""
    if dist.is_initialized():
        return ParallelEnv()
    env = ParallelEnv()
    rank = env.rank if rank is None else rank
    world_size = env.world_size if world_size is None else world_size
    if resolve_device(device).type == "cuda":
        local = _env_int(("LOCAL_RANK",), rank)
        torch.cuda.set_device(local % torch.cuda.device_count())
    # on a card: NCCL for CUDA tensors, gloo for CPU ones (the eager
    # communication API takes both; DataParallel's reducer agrees on its
    # buckets over the host). NCCL's flight recorder keeps a stack trace
    # of every collective, several times the host cost of the call itself
    # (``chip_nccl_probe.py``); the mesh trainers call ~300 a step, so
    # _backend turns it off unless the variable is set.
    backend = _backend(device)
    if init_method is None and "MASTER_ADDR" not in os.environ:
        raise RuntimeError("init_parallel_env needs an init_method or "
                           "MASTER_ADDR/MASTER_PORT in the environment")
    _bring_up(backend, init_method=init_method or "env://", rank=rank,
              world_size=world_size)
    return ParallelEnv()


def _backend(device: DeviceLike) -> str:
    if resolve_device(device).type == "cuda":
        os.environ.setdefault("TORCH_NCCL_TRACE_BUFFER_SIZE", "0")
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def _bring_up(backend: str, **kw) -> None:
    """``init_process_group`` as one attempt under the bring-up policy
    that fires ``pg::init`` first (a failed attempt wrote nothing, so the
    next one rendezvouses under the same key)."""
    from .._core import flags as _flags
    from .resilience import retry

    def attempt():
        if _flags.FAULT_INJECT_ACTIVE:
            from .resilience import faults
            faults.inject("pg::init")
        dist.init_process_group(backend, timeout=TIMEOUT, **kw)

    global _GENERATION
    retry.bringup_policy().run(attempt, what="pg::init")
    _GENERATION += 1


def process_id() -> int:
    """This process's id in the meshes (its torch rank until a
    ``rebuild_world``)."""
    if _PROCESS_ID is not None:
        return _PROCESS_ID
    return get_rank()


def rank_of(pid: int) -> int:
    """The torch rank of the process whose mesh id is ``pid``."""
    if _RANK_OF is None:
        return int(pid)
    try:
        return _RANK_OF[int(pid)]
    except KeyError:
        raise ValueError(f"process {pid} is not in the world "
                         f"{sorted(_RANK_OF)}") from None


def world_process_ids() -> List[int]:
    """The ids of the current world's processes, in rank order."""
    if _RANK_OF is not None:
        return sorted(_RANK_OF)
    return list(range(get_world_size()))


def world_generation() -> int:
    """Changes whenever this process makes or leaves a world."""
    return _GENERATION


def rendezvous_store(store=None):
    """The ``torch.distributed.TCPStore`` every world of ``rebuild_world``
    rendezvouses on, made once for the job's life. Its host is the process
    that hosts ``store`` (the job's ``TCPStore``: the ``ElasticManager``'s,
    by default ``create_or_get_global_tcp_store()``), which publishes its
    endpoint there; the others read it. Losing that host loses the store,
    as losing the job's ``TCPStore`` would."""
    global _RDZV
    if _RDZV is None:
        if store is None:
            from .store import create_or_get_global_tcp_store
            store = create_or_get_global_tcp_store()
        host = store.host
        if store._server:
            rdzv = dist.TCPStore(host, 0, None, True, timeout=TIMEOUT,
                                 wait_for_workers=False)
            store.set(_RDZV_KEY, f"{host}:{rdzv.port}")
        else:
            h, port = store.get(_RDZV_KEY).decode().rsplit(":", 1)
            rdzv = dist.TCPStore(h, int(port), None, False, timeout=TIMEOUT)
        _RDZV = rdzv
    return _RDZV


def rebuild_world(process_ids: Sequence[int], epoch: Optional[int] = None,
                  *, store=None, device: DeviceLike = None,
                  pid: Optional[int] = None):
    """Leave the current world (if any) and join the world of
    ``process_ids`` under membership ``epoch`` (default: the last one this
    process formed, plus 1): every member calls it with the same ids and
    epoch, and no epoch is used twice. Ranks follow the ids in increasing
    order; ``pid`` is this process's id (default ``process_id()``). The
    backend is the current world's (NCCL for CUDA tensors beside gloo, or
    gloo), else ``device``'s. Returns the ``ParallelEnv``."""
    global _PROCESS_ID, _RANK_OF, _EPOCH
    ids = sorted(int(p) for p in process_ids)
    me = process_id() if pid is None else int(pid)
    if me not in ids:
        raise ValueError(f"process {me} is not among the members {ids}")
    if dist.is_initialized():
        backend = str(dist.get_backend())
        backend = "cpu:gloo,cuda:nccl" if "nccl" in backend else "gloo"
    else:
        backend = _backend(device)
        if "nccl" in backend:
            local = _env_int(("LOCAL_RANK",), me)
            torch.cuda.set_device(local % torch.cuda.device_count())
    epoch = _EPOCH + 1 if epoch is None else int(epoch)
    rdzv = rendezvous_store(store)
    destroy_process_group()
    _bring_up(backend, store=dist.PrefixStore(f"__elastic/world/{epoch}/",
                                              rdzv),
              rank=ids.index(me), world_size=len(ids))
    _PROCESS_ID = me
    _RANK_OF = {p: r for r, p in enumerate(ids)}
    _EPOCH = epoch
    return ParallelEnv()


def get_rank(group=None) -> int:
    if not dist.is_initialized():
        return ParallelEnv().rank
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    if not dist.is_initialized():
        return ParallelEnv().world_size
    return dist.get_world_size(group)


def is_initialized() -> bool:
    return dist.is_initialized()


def destroy_process_group(group=None) -> None:
    """Leave the default group (``group`` None: every group, and with
    them the meshes' cached groups, the global mesh, the communication
    API's ``Group``s and what ``fleet.init`` set) or one group."""
    global _PROCESS_ID, _RANK_OF, _GENERATION
    if not dist.is_initialized():
        return
    if group is None:
        from . import fleet, mesh, process_group
        mesh._forget_groups()
        mesh.set_mesh(None)
        process_group._forget_groups()
        fleet._forget()
        _GENERATION += 1
        _PROCESS_ID = _RANK_OF = None
    dist.destroy_process_group(group)
