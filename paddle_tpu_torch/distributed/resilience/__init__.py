"""The counterpart of ``paddle_tpu/distributed/resilience``: the elastic
fault-tolerance runtime, the reactions to the distributed layer's sensors
(the watchdog, the TCPStore rendezvous, the checkpoint).

- ``faults``: deterministic fault injection (``FLAGS_fault_inject``);
- ``retry``: retry/timeout/backoff policies for the transient class;
- ``ElasticStep``: step snapshot, rollback and watchdog coverage;
- ``shrink_world`` / ``grow_world`` (``elastic.py``): the survivors (and
  joiners) form a new world and lay the sharded state out over the new
  mesh, validated by the sanitizer's sweep before anything moves;
- ``growth``: the joiner's rendezvous (``join_world``) and the chunked,
  checksummed state broadcast through the TCPStore
  (``publish_state`` / ``receive_state``);
- ``AdaptiveTrainer`` (``adaptive.py``): re-planning on a membership
  change (the auto-tuner picks dp/mp/pp for the new world), the checkpoint
  fallback and preemption checkpoints.
"""
from __future__ import annotations

from . import faults  # noqa: F401
from . import growth  # noqa: F401
from . import retry  # noqa: F401
from .faults import (CollectiveTimeout, FaultError, FaultPlan,  # noqa: F401
                     RankDeath, TransientFault)
from .retry import RetryPolicy  # noqa: F401
from .elastic import (ElasticStep, grow_world, plan_grow,  # noqa: F401
                      plan_shrink, shrink_world)
from .growth import join_world  # noqa: F401
from .adaptive import (AdaptiveTrainer, MembershipEvent,  # noqa: F401
                       Replanner, mesh_for_plan, stage_rank_map)
