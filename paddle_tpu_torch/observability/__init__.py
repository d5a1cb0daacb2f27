"""paddle_tpu_torch.observability: fused-runtime telemetry, the
counterpart of ``paddle_tpu/observability``.

Three consumers over one set of instrumentation points (segment
record→flush, runner build vs. cached execute, runner-cache hit/miss,
the fused-backward step cache, SOT guard evaluation, collectives,
optimizer updates, the input feed, checkpoint I/O):

- **metrics registry** (`FLAGS_observability` / `enable()`): process-
  wide counters/gauges/histograms, snapshot via `stats()`;
- **structured spans**: while a `paddle_tpu_torch.profiler.Profiler` is
  recording, the same points emit timed span events into the chrome
  trace (`segment::flush[reason]` with build/execute children);
- **flight recorder** (`FLAGS_flight_recorder`): bounded ring of recent
  events, auto-dumped to a report on enforce errors and failed flushes
  (rank-aware retention via FLAGS_flight_max_dumps).

Beside them the planes: bytes (`FLAGS_memory_telemetry`, memory.py),
FLOPs (`FLAGS_compute_telemetry`, compute.py), the goodput ledger
(`FLAGS_goodput`, goodput.py), cross-rank frames
(`FLAGS_distributed_telemetry`, distributed.py) and the live monitor
(`FLAGS_monitor`, timeseries.py and exporter.py); `stats()` gains each
plane's section while it is on. The budget tool is budget.py, less its
static diff (the analysis plane's).

Cost when everything is off: one module-level boolean check per
instrumentation point (`observability._state.ACTIVE`), zero registry
work.

    python -m paddle_tpu_torch.observability        # demo workload + stats
"""
from __future__ import annotations

from .._core import flags as _flags
from . import _state, flight, metrics, spans
from .metrics import counter, gauge, histogram
from .spans import span

__all__ = ["stats", "reset", "enable", "disable", "enabled",
           "counter", "gauge", "histogram", "span",
           "flight_record", "dump_flight_record"]

# keep the module-level fast gates coherent with the flags (env spelling
# FLAGS_observability=1 works from first import; set_flags mid-run
# flips the gate immediately)
_flags.watch_flag("FLAGS_observability", _state.set_metrics)
_flags.watch_flag("FLAGS_flight_recorder", _state.set_flight)
_flags.watch_flag("FLAGS_distributed_telemetry", _state.set_dist)
_flags.watch_flag("FLAGS_memory_telemetry", _state.set_mem)


def _on_compute_flag(on):
    was = _state.COMPUTE
    _state.set_compute(on)
    if on and not was:
        # an armed whole-step drive records through the native prong,
        # which names no call site: retire it
        from .._core import lazy
        lazy._drive_retire()
        # ENTERING the compute plane re-keys the runner caches
        # (mesh-epoch salt): the next execution of each workload builds
        # ONE fresh runner whose FLOPs and op scopes are captured — a
        # warm pre-plane cache would otherwise report zero FLOPs forever
        # (counts are taken at build time only). Only when some runner
        # was actually cached without a count (COST_STALE): a loop
        # flipping the plane around each budget sample must not rebuild
        # every runner per sample once the warm entries carry counts.
        if lazy.COST_STALE:
            lazy.bump_mesh_epoch()
            lazy.COST_STALE = False


_flags.watch_flag("FLAGS_compute_telemetry", _on_compute_flag)


def _on_goodput_flag(on):
    import sys as _sys
    _state.set_goodput(bool(on))
    # the goodput module is only imported once the plane is first
    # turned ON (the resilience-package laziness discipline); after
    # that, flips keep its ledger/watchdog coherent
    mod = _sys.modules.get(__name__ + ".goodput")
    if on:
        from . import goodput as mod
    if mod is not None:
        mod._sync(bool(on))


_flags.watch_flag("FLAGS_goodput", _on_goodput_flag)


def _on_monitor_flag(on):
    import sys as _sys
    _state.set_monitor(bool(on))
    # same laziness discipline as the goodput plane: the timeseries
    # module (sampler thread + HTTP exporter) is only imported once the
    # monitor is first turned ON; later flips start/stop in place
    mod = _sys.modules.get(__name__ + ".timeseries")
    if on:
        from . import timeseries as mod
    if mod is not None:
        mod._sync(bool(on))


_flags.watch_flag("FLAGS_monitor", _on_monitor_flag)


def enable(flight_recorder: bool = None):
    """Turn on metrics collection (and optionally the flight recorder)."""
    f = {"FLAGS_observability": True}
    if flight_recorder is not None:
        f["FLAGS_flight_recorder"] = bool(flight_recorder)
    _flags.set_flags(f)


def disable():
    _flags.set_flags({"FLAGS_observability": False})


def enabled() -> bool:
    return _state.METRICS


def reset():
    """Zero every metric and drop the flight ring (counter snapshots
    restart from a clean baseline)."""
    metrics.reset()
    flight.reset()


def _derived(counters: dict) -> dict:
    hits = misses = 0
    for k, v in counters.items():
        if k.startswith("cache."):
            if k.endswith(".hit"):
                hits += v
            elif k.endswith(".miss"):
                misses += v
    step_hit = counters.get("cache.fused_step.hit", 0)
    step_miss = counters.get("cache.fused_step.miss", 0)
    return {
        "compiles": sum(v for k, v in counters.items()
                        if k.startswith("compiles.")),
        "cache_hit_rate": (hits / (hits + misses)
                           if hits + misses else None),
        "step_cache_hit_rate": (step_hit / (step_hit + step_miss)
                                if step_hit + step_miss else None),
        # every fusion-window break costs the step cache: a headline
        # number instead of raw span archaeology
        "fusion_window_breaks": counters.get("fusion.window_breaks", 0),
    }


def stats(reset_after: bool = False) -> dict:
    """Snapshot of the registry plus derived headline numbers:

    - ``compiles``: runner builds (sum of the ``compiles.*`` counters) —
      steady state adds zero;
    - ``cache_hit_rate``: hit fraction across every runner cache;
    - ``step_cache_hit_rate``: the fused fwd+vjp "step cache" alone —
      THE steady-state train-step health signal.
    """
    snap = metrics.snapshot()
    snap.update(_derived(snap["counters"]))
    if _state.MEM:
        # byte-domain headline (census watermark + cached per-runner
        # memory notes) rides along whenever the memory
        # telemetry plane is on
        from . import memory as _memory
        snap["memory"] = _memory.summary()
    if _state.COMPUTE:
        # FLOP-domain headline (runner count log + executed-FLOPs
        # totals + the per-chip peak the MFU column divides by)
        from . import compute as _compute
        snap["compute"] = _compute.summary()
    if _state.GOODPUT:
        # job-level wall attribution: the exclusive bucket partition,
        # goodput fraction and top badput source from the ledger
        from . import goodput as _goodtel
        snap["goodput"] = _goodtel.summary()
    if reset_after:
        reset()
    return snap


def flight_record() -> str:
    """The flight-recorder ring formatted as a report."""
    return flight.record()


def dump_flight_record(path: str = None) -> str:
    """Write the flight record to a file; returns the path."""
    return flight.dump(reason="manual dump", path=path)
