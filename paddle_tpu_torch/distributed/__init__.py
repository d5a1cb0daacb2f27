"""Counterpart of ``paddle_tpu/distributed``: the process groups and the
mesh (``init_parallel_env``, ``ProcessMesh``) over ``torch.distributed``,
the compiled pipeline over a pp axis, ``fleet`` (the tensor-parallel
functions of the mesh trainers, the fleet layers at degree 1,
``recompute``)."""
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
