"""The counterpart of ``paddle_tpu/observability``, so far its metrics
registry alone (``metrics``: counters, gauges, histograms, ``snapshot``,
``reset``) and the module-level gates (``_state``), which stay closed.

The resilience runtime counts into the registry unconditionally, as the
reference's does (``resilience.*``, ``sanitizer.shrink_sweeps``). The rest
of the package (the ``FLAGS_observability`` collection at the runtime's
hot sites, spans, the flight recorder, cross-rank telemetry, memory and
compute telemetry, goodput, the live monitor and ``stats()``) is
``ROADMAP.md`` §1 item 9.
"""
from __future__ import annotations

from . import _state, metrics  # noqa: F401

__all__ = ["metrics"]
