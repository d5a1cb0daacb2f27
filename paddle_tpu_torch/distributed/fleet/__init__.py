"""Counterpart of ``paddle_tpu/distributed/fleet``: the tensor-parallel
layers at degree 1 and ``recompute``."""
from .mp_layers import (ColumnParallelLinear, RowParallelLinear,  # noqa: F401
                        VocabParallelEmbedding)
from .recompute import recompute  # noqa: F401
