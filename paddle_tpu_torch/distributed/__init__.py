"""Counterpart of ``paddle_tpu/distributed``: the process groups and the
mesh (``init_parallel_env``, ``ProcessMesh``) over ``torch.distributed``,
the eager communication API (``communication``: ``all_reduce`` and the
other collectives, ``Group``, ``new_group``), ``DataParallel``, the
``TCPStore``, the compiled pipeline over a pp axis, ``fleet`` (the
hybrid-parallel API, ``recompute``), ``sharding`` (eager ZeRO), the eager
pipeline (``pipeline``), the semi-auto API (``placements``, ``api``,
``auto_parallel.reshard_functions``), the distributed checkpoint
(``checkpoint``) and the fault injection and retry policies
(``resilience``)."""
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
from .resilience import FaultPlan, RetryPolicy  # noqa: F401,E402
from . import auto_parallel  # noqa: F401,E402
