"""Counterpart of ``paddle_tpu/distributed``: the process groups and the
mesh (``init_parallel_env``, ``ProcessMesh``) over ``torch.distributed``,
the eager communication API (``communication``: ``all_reduce`` and the
other collectives, ``Group``, ``new_group``), ``DataParallel``, the
``TCPStore``, the compiled pipeline over a pp axis, ``fleet`` (the
hybrid-parallel API, ``recompute``), ``sharding`` (eager ZeRO), the eager
pipeline (``pipeline``), the semi-auto API (``placements``, ``api``,
``auto_parallel.reshard_functions``), the distributed checkpoint
(``checkpoint``), the elastic resilience runtime (``resilience``: fault
injection, retry policies, ``ElasticStep``, ``shrink_world`` /
``grow_world`` over a world formed again with ``rebuild_world``,
``AdaptiveTrainer``), context parallelism (``context_parallel``: ring and
Ulysses attention), the auto-parallel ``Engine`` with its spmd rules,
partitioner, planner and passes (``auto_parallel``, ``passes``), the
``auto_tuner``, the launcher (``launch``, ``spawn``), the watchdog
(``CommTaskManager``), ``comm_context`` and ``utils``."""
from .mesh import (ProcessMesh, auto_mesh, get_mesh,  # noqa: F401
                   init_device_mesh, set_mesh)
from .parallel_env import (ParallelEnv, destroy_process_group,  # noqa: F401
                           get_rank, get_world_size, init_parallel_env,
                           is_initialized)
from . import pipeline_compiled  # noqa: F401
from .pipeline_compiled import (FThenB, pipelined_trunk,  # noqa: F401
                                spmd_pipeline)
from . import fleet  # noqa: F401
from .fleet.recompute import recompute  # noqa: F401
from . import communication, process_group, store  # noqa: F401,E402
from .communication import (ReduceOp, Group, new_group,  # noqa: F401,E402
                            get_group, all_reduce, all_gather,
                            all_gather_object, broadcast,
                            broadcast_object_list, reduce, reduce_scatter,
                            scatter, gather, alltoall, all_to_all, send,
                            recv, isend, irecv, barrier, wait, get_backend,
                            stream)
from . import parallel  # noqa: F401,E402
from .parallel import DataParallel  # noqa: F401,E402
from .store import TCPStore, create_or_get_global_tcp_store  # noqa: F401,E402
from . import sharding  # noqa: F401,E402
from .sharding import (DygraphShardingOptimizer,  # noqa: F401,E402
                       DygraphShardingStage3, group_sharded_parallel,
                       save_group_sharded_model)
from .placements import (Placement, Replicate, Shard,  # noqa: F401,E402
                         Partial)
from .api import (DistAttr, shard_tensor, reshard,  # noqa: F401,E402
                  dtensor_from_local, dtensor_to_local, unshard_dtensor,
                  shard_layer, placements_to_spec)
from . import checkpoint  # noqa: F401,E402
from .checkpoint import save_state_dict, load_state_dict  # noqa: F401,E402
from .pipeline import (PipelineLayer, PipelineParallel,  # noqa: F401,E402
                       LayerDesc, SharedLayerDesc,
                       PipelineParallelWithInterleave, DistPipelineRuntime,
                       DistPipelineRuntimeVPP, DistPipelineRuntimeZB,
                       build_pipeline_runtime)
from .fleet.recompute import recompute_sequential  # noqa: F401,E402
from . import resilience  # noqa: F401,E402
from .resilience import (AdaptiveTrainer, ElasticStep,  # noqa: F401,E402
                         FaultPlan, MembershipEvent, Replanner, RetryPolicy,
                         grow_world, join_world, mesh_for_plan, plan_grow,
                         plan_shrink, shrink_world, stage_rank_map)
from .parallel_env import rebuild_world  # noqa: F401,E402
from . import auto_parallel  # noqa: F401,E402
from . import context_parallel, utils  # noqa: F401,E402
from .context_parallel import (ring_attention, ulysses_attention,  # noqa: F401,E402
                               ring_attention_global,
                               ulysses_attention_global)
from . import comm_context, passes, watchdog  # noqa: F401,E402
from .watchdog import CommTaskManager, get_comm_task_manager  # noqa: F401,E402
from .auto_parallel import Engine, Strategy, to_static  # noqa: F401,E402
from . import auto_tuner  # noqa: F401,E402


def _spawn_worker(env, func, args):
    import os
    os.environ.update(env)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """paddle.distributed.spawn. ``nprocs`` -1 is the card count on a card,
    else ``CPU_NUM`` (default 1), as upstream reads them. At one process
    ``func(*args)`` runs in the calling process, as in the reference.
    Above one the port's ranks are processes: ``nprocs`` workers start
    (the ``spawn`` start method), each with the launcher's environment
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
    ``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
    ``MASTER_ADDR``/``MASTER_PORT`` on a free port), and run
    ``func(*args)``, whose ``init_parallel_env()`` joins them. ``join``
    waits for every worker and raises if one failed; otherwise the worker
    processes are returned."""
    import multiprocessing
    import os
    import socket

    import torch
    if nprocs is None or nprocs < 0:
        nprocs = torch.cuda.device_count() if torch.cuda.is_available() \
            else int(os.environ.get("CPU_NUM", "1"))
    if nprocs <= 1:
        func(*args)
        return None
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    endpoints = [f"127.0.0.1:{port + i}" for i in range(nprocs)]
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
               "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
               "PADDLE_RESTART_COUNT": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        p = ctx.Process(target=_spawn_worker, args=(env, func, tuple(args)),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    for p in procs:
        p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if failed:
        raise RuntimeError(f"spawn: workers exited with codes {failed} "
                           f"(rank, code)")
    return None


def launch():
    """``python -m paddle_tpu_torch.distributed.launch`` as a function."""
    from .launch.main import main
    main()
