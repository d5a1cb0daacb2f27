"""Counterpart of ``paddle_tpu/distributed/fleet`` (upstream
``fleet/fleet.py``): Paddle's dygraph hybrid-parallel training API over
``torch.distributed``, one process per rank.

``init`` joins the process group (when the world has more than one rank),
fills the data-parallel degree as the reference does and builds the
``HybridCommunicateGroup`` over ``pp``, ``dp``, ``sharding``, ``sep`` and
``mp``; ``distributed_model`` wraps a model by the parallel mode
(the pipeline runtime for a ``PipelineLayer``, ``DataParallel`` for data
parallelism, ``TensorParallel`` for model parallelism, the model itself
alone or for sharding) and
``distributed_optimizer`` wraps the optimizer in
``HybridParallelOptimizer``. Beside them: the tensor-parallel layers and
their eager collectives (``mp_layers``, ``mp_ops``), sequence parallelism
(``sequence_parallel_utils``), the RNG tracker (``random_``), the metrics
and ``recompute``; in pipeline mode ``distributed_model`` builds the eager
pipeline (``distributed/pipeline.py``). The parameter server
(``init_server`` and the rest) and ``elastic`` are not ported yet
(``ROADMAP.md`` §1 items 10 and 8.7).
"""
from __future__ import annotations

from ..mesh import ProcessMesh, set_mesh  # noqa: F401
from ..parallel_env import (ParallelEnv, get_rank,  # noqa: F401
                            get_world_size, init_parallel_env,
                            is_initialized as _pg_initialized)
from . import mp_ops  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    TensorParallel, VocabParallelEmbedding)
from .random_ import (get_rng_state_tracker,  # noqa: F401
                      model_parallel_random_seed)
from .recompute import recompute  # noqa: F401
from .strategy import DistributedStrategy
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)
from . import hybrid_optimizer, metrics  # noqa: F401
from . import sequence_parallel_utils  # noqa: F401
from .sequence_parallel_utils import (  # noqa: F401
    ColumnSequenceParallelLinear, RowSequenceParallelLinear,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)

_fleet_initialized = False
_strategy: DistributedStrategy = None


class SegmentParallel:
    """Wrapper of a model whose activations are split along the sequence
    over the sep axis (upstream ``meta_parallel/segment_parallel.py``);
    its parameters stay replicated over sep, so it calls the model."""

    def __init__(self, layers, hcg=None, **kwargs):
        self._layers = layers
        self._hcg = hcg

    def __getattr__(self, item):
        return getattr(self.__dict__["_layers"], item)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class _MetaParallelNS:
    ColumnParallelLinear = ColumnParallelLinear
    RowParallelLinear = RowParallelLinear
    VocabParallelEmbedding = VocabParallelEmbedding
    ParallelCrossEntropy = ParallelCrossEntropy
    ColumnSequenceParallelLinear = ColumnSequenceParallelLinear
    RowSequenceParallelLinear = RowSequenceParallelLinear
    SegmentParallel = SegmentParallel


meta_parallel = _MetaParallelNS()


class _FleetUtilsNS:
    sequence_parallel_utils = sequence_parallel_utils


utils = _FleetUtilsNS()


def init(role_maker=None, is_collective=True, strategy=None, log_level="INFO"):
    """Parses ``strategy.hybrid_configs`` and builds the hybrid group and
    its mesh (set as the global mesh). A world of more than one rank joins
    its process group first (``init_parallel_env``, from the
    environment); the data-parallel degree takes up the ranks the other
    axes leave."""
    global _fleet_initialized, _strategy
    strategy = strategy or DistributedStrategy()
    _strategy = strategy
    if not _pg_initialized() and ParallelEnv().world_size > 1:
        init_parallel_env()
    h = strategy.hybrid_configs
    world = get_world_size()
    degrees = {"dp": h["dp_degree"], "mp": h["mp_degree"],
               "pp": h["pp_degree"], "sharding": h["sharding_degree"],
               "sep": h.get("sep_degree", 1)}
    known = 1
    for k, v in degrees.items():
        if k != "dp" and v > 0:
            known *= v
    if degrees["dp"] <= 0 or degrees["dp"] * known != world:
        degrees["dp"] = max(world // known, 1)
    topo = CommunicateTopology(
        hybrid_group_names=["pipe", "data", "sharding", "sep", "model"],
        dims=[degrees["pp"], degrees["dp"], degrees["sharding"],
              degrees["sep"], degrees["mp"]])
    hcg = HybridCommunicateGroup(topo)
    set_hybrid_communicate_group(hcg)
    set_mesh(hcg.mesh)
    _fleet_initialized = True
    return None


def is_initialized():
    return _fleet_initialized


def _forget() -> None:
    """Drops what ``init`` set: its groups are gone with the world's."""
    global _fleet_initialized, _strategy
    _fleet_initialized, _strategy = False, None
    set_hybrid_communicate_group(None)


def get_hybrid_communicate_group_():
    return get_hybrid_communicate_group()


def distributed_model(model):
    """``model`` wrapped by the parallel mode (fleet/model.py:144-170). In
    pipeline mode a ``PipelineLayer`` becomes, in a world of more than one
    rank, the runtime of ``pipeline_configs``' ``schedule_mode`` over this
    rank's stage and the pp group (``accumulate_steps`` micro-batches),
    else ``PipelineParallel``; ``DataParallel`` over the dp group,
    ``TensorParallel`` over mp (with a process group), else the model
    itself."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return model
    mode = hcg.get_parallel_mode()
    if mode == "pipeline":
        from ..pipeline import (PipelineLayer, PipelineParallel,
                                build_pipeline_runtime)
        if not isinstance(model, PipelineLayer):
            return model
        if _pg_initialized() and get_world_size() > 1:
            # this rank keeps its stage; the strategy's schedule_mode picks
            # the runtime (the pipeline_scheduler_pass role)
            cfg = _strategy.pipeline_configs if _strategy else {}
            stage = model._segment(*model._stage_bounds[hcg.get_stage_id()])
            return build_pipeline_runtime(
                stage, hcg.get_pipe_parallel_group(), model._loss_fn,
                cfg.get("accumulate_steps", 1),
                schedule=cfg.get("schedule_mode", "1F1B"))
        return PipelineParallel(model, hcg, _strategy)
    if mode == "data_parallel":
        from ..parallel import DataParallel
        return DataParallel(model, group=hcg.get_data_parallel_group())
    if mode == "model_parallel" and _pg_initialized():
        return TensorParallel(model, hcg)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """``optimizer`` in ``HybridParallelOptimizer`` (itself before
    ``init``)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return optimizer
    return hybrid_optimizer.HybridParallelOptimizer(
        optimizer, hcg, strategy or _strategy)


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_first_worker():
    return get_rank() == 0


def barrier_worker():
    from ..communication import barrier
    barrier()
