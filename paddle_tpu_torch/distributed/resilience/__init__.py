"""The counterpart of ``paddle_tpu/distributed/resilience``, so far its
fault injection and retry policies: ``faults`` (``FaultPlan``,
``inject``, the ``FaultError`` family, gated by ``FLAGS_fault_inject``)
and ``retry`` (``RetryPolicy`` and its presets). ``ElasticStep``,
``shrink_world``, the growth and adaptive trainers and the store's retry
wiring are ``ROADMAP.md`` §1 item 8.7.
"""
from __future__ import annotations

from . import faults  # noqa: F401
from . import retry  # noqa: F401
from .faults import (CollectiveTimeout, FaultError, FaultPlan,  # noqa: F401
                     RankDeath, TransientFault)
from .retry import RetryPolicy  # noqa: F401
