"""Process-group setup: the counterpart of
``paddle_tpu/distributed/parallel_env.py``.

One process per rank. ``init_parallel_env`` joins this process to the
job's default process group over ``torch.distributed``: NCCL, one rank per
card, unless the caller asks for the CPU (``device="cpu"``), which takes
gloo. The rendezvous is ``init_method`` when given (``file://...`` or
``tcp://host:port``), else the environment (``MASTER_ADDR`` and
``MASTER_PORT``, as ``torchrun`` sets them). Rank and world size come from
the arguments, else from ``RANK``/``WORLD_SIZE``, else from the
reference's ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .._core.device import DeviceLike, resolve_device

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


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
    environment). ``device`` None or CUDA: NCCL, and this process's card
    becomes ``cuda:<local rank>``; ``"cpu"``: gloo."""
    if dist.is_initialized():
        return ParallelEnv()
    env = ParallelEnv()
    rank = env.rank if rank is None else rank
    world_size = env.world_size if world_size is None else world_size
    if resolve_device(device).type == "cuda":
        local = _env_int(("LOCAL_RANK",), rank)
        torch.cuda.set_device(local % torch.cuda.device_count())
        # NCCL's flight recorder keeps a stack trace of every collective,
        # several times the host cost of the call itself
        # (``chip_nccl_probe.py``); the mesh trainers call ~300 a step.
        # Set the variable to keep it.
        os.environ.setdefault("TORCH_NCCL_TRACE_BUFFER_SIZE", "0")
        backend = "nccl"
    else:
        backend = "gloo"
    if init_method is None and "MASTER_ADDR" not in os.environ:
        raise RuntimeError("init_parallel_env needs an init_method or "
                           "MASTER_ADDR/MASTER_PORT in the environment")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
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
    """Leave the default group (``group`` None: every group, and the
    meshes' cached groups with them) or one group."""
    if not dist.is_initialized():
        return
    if group is None:
        from .mesh import _forget_groups
        _forget_groups()
    dist.destroy_process_group(group)
