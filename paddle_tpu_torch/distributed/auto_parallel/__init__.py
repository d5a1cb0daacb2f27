"""The counterpart of ``paddle_tpu/distributed/auto_parallel``, so far its
reshard function registry (``reshard_functions``). ``Engine``,
``Strategy`` and ``to_static`` (the engine, planner, partitioner and spmd
rules) are ``ROADMAP.md`` §1 item 8.6."""
from . import reshard_functions  # noqa: F401
