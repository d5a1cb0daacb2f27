"""The counterpart of ``paddle_tpu/distributed/auto_parallel``: the
``Engine`` with ``Strategy`` and ``to_static`` (``engine.py``), the spmd
rules, the partitioner and the planner, and the reshard function registry
(``reshard_functions``)."""
from . import reshard_functions  # noqa: F401
from .engine import Engine, Strategy, to_static  # noqa: F401
