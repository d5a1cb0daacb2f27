"""Module-level gates of the observability layer: the counterpart of
``paddle_tpu/observability/_state.py``.

Every instrumented hot path (segment flush, cache lookup, collective, SOT
guard eval) pays exactly ONE module-attribute read when everything here
is off. The gates are kept coherent with their flags by flag watchers
(registered in ``observability/__init__``) and with the profiler's
recording state by its start/stop/step.

Stdlib only: the runtime's core modules import it at load.
"""
from __future__ import annotations

METRICS = False   # FLAGS_observability: registry collection at hot sites
TRACE = False     # profiler is recording: spans land in the host trace
FLIGHT = False    # FLAGS_flight_recorder: ring-buffer event capture
DIST = False      # FLAGS_distributed_telemetry: cross-rank frame plane
MEM = False       # FLAGS_memory_telemetry: live-buffer census + bytes
COMPUTE = False   # FLAGS_compute_telemetry: FLOPs accounting + MFU
GOODPUT = False   # FLAGS_goodput: wall-clock attribution ledger
MONITOR = False   # FLAGS_monitor: live time-series sampler + exporter

# The single gate hot paths read: any consumer on.
ACTIVE = False


def recompute():
    global ACTIVE
    ACTIVE = METRICS or TRACE or FLIGHT or DIST or MEM or COMPUTE \
        or GOODPUT or MONITOR


def set_metrics(on: bool):
    global METRICS
    METRICS = bool(on)
    recompute()


def set_trace(on: bool):
    global TRACE
    TRACE = bool(on)
    recompute()


def set_flight(on: bool):
    global FLIGHT
    FLIGHT = bool(on)
    recompute()


def set_dist(on: bool):
    global DIST
    DIST = bool(on)
    recompute()


def set_mem(on: bool):
    global MEM
    MEM = bool(on)
    recompute()


def set_compute(on: bool):
    global COMPUTE
    COMPUTE = bool(on)
    recompute()


def set_goodput(on: bool):
    global GOODPUT
    GOODPUT = bool(on)
    recompute()


def set_monitor(on: bool):
    global MONITOR
    MONITOR = bool(on)
    recompute()
