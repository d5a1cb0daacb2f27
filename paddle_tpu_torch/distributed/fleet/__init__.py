"""Counterpart of ``paddle_tpu/distributed/fleet``: ``mp_ops`` (the
vocab-parallel head and the tensor-parallel functions of the mesh
trainers), the tensor-parallel layers at degree 1 and ``recompute``."""
from ..mesh import ProcessMesh, set_mesh  # noqa: F401
from ..parallel_env import (ParallelEnv, get_rank,  # noqa: F401
                            get_world_size, init_parallel_env)
from . import mp_ops  # noqa: F401
from .mp_layers import (ColumnParallelLinear, RowParallelLinear,  # noqa: F401
                        VocabParallelEmbedding)
from .recompute import recompute  # noqa: F401
