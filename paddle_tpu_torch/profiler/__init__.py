"""paddle.profiler (python/paddle/profiler/profiler.py:358 analog): the
counterpart of ``paddle_tpu/profiler``.

Host tracer: RecordEvent instrumentation collecting (name, tid, t0, t1)
host events — the analog of the reference's HostTracer
(paddle/fluid/platform/profiler/event_tracing.h). Device tracer: where the
reference starts ``jax.profiler``, the port starts ``torch.profiler`` with
``ProfilerActivity.CUDA`` (CUPTI underneath) when the targets hold
``ProfilerTarget.GPU``, and reads its Kineto trace through
``profiler/xplane.py``, rebased onto the host ``perf_counter`` timeline.
``ProfilerTarget.TPU`` stays in the enum for the names' sake; asking for it
raises ``ValueError``. One ``torch.profiler`` trace runs at a time: a
device trace that cannot start (another one is live) is a logged
warning and no device events, as the reference's failed ``start_trace``
is. Scheduler states and chrome-trace export mirror profiler.py:89
(make_scheduler) and chrometracing_logger.cc.

Two recording modes:

- default: per-op host events (`op::<name>`) — the fusion window is
  bypassed while recording so each op dispatches (and times) alone;
- `fused_runtime=True` (or FLAGS_profiler_fused_runtime): the fusion
  window stays ON and the trace instead carries the runtime spans the
  steady-state hot path actually executes — `segment::flush[reason]`
  with `segment::compile` / `segment::execute` children, fused
  optimizer updates, collectives (see paddle_tpu.observability).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from enum import Enum
from typing import Callable, List, Optional

from .._core import flags as _flags
from ..observability import _state as _obs_state
from .statistic import SortedKeys, StatisticData, summary as _summary

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "SortedKeys",
           "load_profiler_result"]

log = logging.getLogger("paddle_tpu_torch.profiler")


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


_events_lock = threading.Lock()
_events: List[dict] = []
_recording = False

# Disabled-path fast gates: a RecordEvent in user code must be
# near-free when no profiler is recording, so begin()/end() test ONE
# module-level bool — no clock stamp, no flag-registry lookup. The
# flag values are cached here and kept coherent via flags.watch_flag.
_TRACER_ON = False      # _recording and host_tracer_level >= 1
_TRACER_LEVEL = 1
_MAX_EVENTS = 1_000_000
_CUR_PROFILER = None    # the profiler currently recording, if any


def _refresh_gates():
    global _TRACER_ON
    _TRACER_ON = _recording and _TRACER_LEVEL >= 1


def _on_level_change(v):
    global _TRACER_LEVEL
    _TRACER_LEVEL = v
    _refresh_gates()
    # flipping the level mid-recording must (un)install the per-op
    # dispatch hook immediately, not at the next step boundary
    p = _CUR_PROFILER
    if p is not None:
        p._sync_recording()


def _on_cap_change(v):
    global _MAX_EVENTS
    _MAX_EVENTS = v


_flags.watch_flag("FLAGS_host_tracer_level", _on_level_change)
_flags.watch_flag("FLAGS_profiler_max_events", _on_cap_change)


# Interned per-thread ids: threading.get_ident() & 0xFFFF could merge
# two threads' trace lanes on a collision, and even a full get_ident()
# key is recycled by the OS after a thread exits (a later thread would
# inherit a dead thread's lane and name). Thread-local storage dies
# with its thread, so every thread — including one on a recycled
# ident — gets a fresh small id; _TID_NAMES carries the names into
# the export's metadata events.
_TID_LOCK = threading.Lock()
_TID_TLS = threading.local()
_TID_NAMES: dict = {}        # small id -> thread name at first event


def _tid() -> int:
    t = getattr(_TID_TLS, "tid", None)
    if t is None:
        with _TID_LOCK:
            t = len(_TID_NAMES) + 1
            _TID_NAMES[t] = threading.current_thread().name
        _TID_TLS.tid = t
    return t


def _append_event(ev: dict):
    with _events_lock:
        if len(_events) >= _MAX_EVENTS:
            # amortized O(1)/event: drop the oldest 1/64th at once
            del _events[:max(_MAX_EVENTS // 64, 1)]
        _events.append(ev)


def _add_span_event(name: str, ts_us: float, dur_us: float, args=None):
    """Observability spans land in the host-event buffer under
    cat='runtime' (called by paddle_tpu.observability.spans while
    `_recording`; spans bypass the host-tracer level — they are the
    fused-runtime trace, not python-range detail)."""
    if not _recording:
        return
    ev = {"name": name, "tid": _tid(), "ts": ts_us, "dur": dur_us,
          "cat": "runtime"}
    if args:
        ev["args"] = args
    _append_event(ev)


def _add_counter_event(name: str, value, key: str = "bytes"):
    """Chrome counter-track sample (ph='C') — the memory telemetry
    plane feeds memory.live_bytes here on census changes, and the
    compute plane feeds achieved GFLOP/s per execution, while a
    profiler records: the trace shows the byte watermark and the
    FLOP-rate as counter lanes alongside the runtime spans."""
    if not _recording:
        return
    _append_event({"name": name, "tid": _tid(), "ph": "C",
                   "ts": time.perf_counter_ns() / 1000.0,
                   "cat": "runtime",
                   # byte counters stay integral; rate counters (the
                   # GFLOP/s lane) keep their fraction — int() would
                   # flatline any rate under 1 GFLOP/s (every CPU-box
                   # bench model) to a constant 0
                   "args": {key: int(value) if key == "bytes"
                            else round(float(value), 4)}})


class RecordEvent:
    """User-scope host event (profiler/utils.py RecordEvent analog).
    Disabled cost: one module-level bool per begin/end."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None

    def begin(self):
        if not _TRACER_ON:
            self._t0 = None
            return
        self._t0 = time.perf_counter_ns()

    def end(self):
        if self._t0 is None or not _TRACER_ON:
            return
        t1 = time.perf_counter_ns()
        _append_event({
            "name": self.name,
            "tid": _tid(),
            "ts": self._t0 / 1000.0,       # us, chrome convention
            "dur": (t1 - self._t0) / 1000.0,
        })

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0) -> Callable:
    """profiler.py:89 state machine: skip_first -> [closed -> ready ->
    record(last step returns)] cycling `repeat` times (0 = forever)."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str = None, worker_name: str = None):
    """on_trace_ready factory writing chrome trace json (reference
    chrometracing_logger.cc output shape)."""
    if dir_name is None:
        dir_name = _flags.flag_value("FLAGS_profiler_dir") or "."
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof: "Profiler"):
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{name}_step{prof.step_num}.pt.trace.json")
        prof.export(path)

    return handler


class Profiler:
    def __init__(self, *, targets=None, scheduler=None,
                 on_trace_ready=None, timer_only: bool = False,
                 record_shapes: bool = False, profile_memory: bool = False,
                 with_flops: bool = False, emit_nvtx: bool = False,
                 fused_runtime: Optional[bool] = None):
        self.targets = list(targets or [ProfilerTarget.CPU])
        if ProfilerTarget.TPU in self.targets:
            raise ValueError("ProfilerTarget.TPU names the reference's "
                             "device; the port traces a CUDA card: ask "
                             "for ProfilerTarget.GPU")
        if scheduler is None:
            self.scheduler = _default_scheduler
        elif isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self.scheduler = make_scheduler(closed=max(lo, 0), ready=0,
                                            record=hi - lo, repeat=1)
        else:
            self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        # fused-runtime recording: keep the fusion window on (no per-op
        # events; the trace carries segment/comm/optimizer spans)
        self.fused_runtime = (
            _flags.flag_value("FLAGS_profiler_fused_runtime")
            if fused_runtime is None else bool(fused_runtime))
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._device_tracing = False
        self._torch_prof = None
        self._trace_start_perf_us = 0.0
        self._device_events: List[dict] = []

    # ---------------------------------------------------------- lifecycle
    def _sync_recording(self):
        """Recompute every consumer of the recording state: the fast
        RecordEvent gate, the per-op dispatch hook (installed only
        while actually recording in per-op mode — ops during CLOSED
        cycles were always dropped, now they skip the detour entirely),
        and the observability TRACE gate feeding spans into _events."""
        global _recording, _CUR_PROFILER
        _recording = self.current_state in (
            ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        _CUR_PROFILER = self if _recording else None
        _refresh_gates()
        _obs_state.set_trace(_recording)
        from .._core import dispatch
        if _recording and not self.fused_runtime and _TRACER_LEVEL >= 1:
            dispatch.set_profile_cb(lambda name: RecordEvent(f"op::{name}"))
        else:
            dispatch.set_profile_cb(None)

    def start(self):
        with _events_lock:
            _events.clear()
        self._device_events = []  # never mix cycles if a capture fails
        self.current_state = self.scheduler(self.step_num)
        self._sync_recording()
        if _recording:
            self._maybe_device_trace()
        return self

    def stop(self):
        self.current_state = ProfilerState.CLOSED
        self._sync_recording()
        self._stop_device_trace()
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self, num_samples: Optional[int] = None):
        prev = self.current_state
        self.step_num += 1
        self.current_state = self.scheduler(self.step_num)
        if prev == ProfilerState.RECORD_AND_RETURN:
            # cycle boundary: pull the device trace in NOW so the per-cycle
            # export carries this cycle's device events, not none
            self._stop_device_trace()
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
        was_recording = _recording
        self._sync_recording()
        if _recording and (not was_recording
                           or prev == ProfilerState.RECORD_AND_RETURN):
            # new record cycle: drop the previous cycle's events so each
            # exported trace covers exactly one cycle
            with _events_lock:
                _events.clear()
            self._device_events = []
            self._maybe_device_trace()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------- device trace
    def _maybe_device_trace(self):
        if self.timer_only or ProfilerTarget.GPU not in self.targets:
            return
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            from . import xplane
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device to trace")
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            # align Kineto's clock with perf_counter: the anchor scope's
            # trace event opens at this host time
            self._trace_start_perf_us = time.perf_counter_ns() / 1000.0
            with torch.profiler.record_function(xplane.ANCHOR):
                pass
            self._torch_prof = prof
            self._device_tracing = True
        except Exception as e:
            log.warning("device trace: torch.profiler start failed: %r", e)
            self._device_tracing = False

    def _stop_device_trace(self):
        if not self._device_tracing:
            return
        self._device_tracing = False
        prof, self._torch_prof = self._torch_prof, None
        try:
            import torch
            torch.cuda.synchronize()
            prof.stop()
        except Exception as e:
            log.warning("device trace: torch.profiler stop failed: %r", e)
            return
        try:
            self._ingest_device_trace(prof)
        except Exception as e:
            log.warning("device trace: Kineto trace ingestion failed: %r",
                        e)

    def _ingest_device_trace(self, prof):
        """Export the Kineto trace and read it into per-kernel device
        events (profiler/xplane.py), rebased onto the host perf_counter
        timeline through the clock anchor. A zero-event ingest logs its
        reason instead of passing silently."""
        import tempfile
        from . import xplane
        with tempfile.TemporaryDirectory() as d:
            prof.export_chrome_trace(os.path.join(d, "device.pt.trace.json"))
            events, why = xplane.ingest(d)
        if why:
            log.warning("device trace: %s", why)
        if not events:
            return
        base = self._trace_start_perf_us
        from ..observability import compute as _comptel
        out = []
        for e in events:
            ev = {"name": e["name"], "tid": e["tid"],
                  "ts": base + e["start_ns"] / 1000.0,
                  "dur": e["dur_ns"] / 1000.0, "cat": "device"}
            if "launch_ns" in e:
                ev["launch_ts"] = base + e["launch_ns"] / 1000.0
            if "src" in e:
                ev["src"] = e["src"]
                _comptel.note_source(e["name"], e["src"])
            out.append(ev)
        self._device_events = out
        if _obs_state.METRICS:
            from ..observability import metrics
            metrics.inc("profiler.device_events", len(self._device_events))

    # ------------------------------------------------------------ exports
    def events(self) -> List[dict]:
        with _events_lock:
            return list(_events)

    def device_events(self) -> List[dict]:
        return list(getattr(self, "_device_events", []))

    def device_summary(self):
        """Aggregate device kernel durations by name (profiler_statistic
        kernel view analog): {name: {calls, total_us}} sorted by time."""
        agg = {}
        for e in self.device_events():
            a = agg.setdefault(e["name"], {"calls": 0, "total_us": 0.0})
            a["calls"] += 1
            a["total_us"] += e["dur"]
        return dict(sorted(agg.items(),
                           key=lambda kv: -kv[1]["total_us"]))

    def _source_of(self, event):
        """paddle ``op@file:line`` provenance for one device event (or an
        event name), or None: the scope the trace reader found open at
        the kernel's launch (runners built while FLAGS_compute_telemetry
        is on open one ``<op>[<file>:<line>]`` scope per recorded op),
        else the compute plane's last launch of that kernel name."""
        if isinstance(event, dict):
            if event.get("src"):
                return event["src"]
            event = event["name"]
        from ..observability import compute as _comptel
        return _comptel.source_of(event)

    def source_summary(self, sorted_by=None, time_unit="ms"):
        """The statistic table over DEVICE events grouped by paddle
        source provenance: device time attributed to the
        ``op@file:line`` that recorded the op (unattributed kernels
        keep their raw kernel name). Closes the loop from the perf lint's
        "this line breaks the window" to "this line spends the device
        time"."""
        evs = [dict(e, name=self._source_of(e) or e["name"])
               for e in self.device_events()]
        return _summary(evs, sorted_by=sorted_by, time_unit=time_unit)

    def export(self, path: str, format: str = "json"):
        pid = os.getpid()
        trace_events = [
            # counter samples (ph='C': the memory track) carry no dur
            {"name": e["name"], "ph": e.get("ph", "X"), "pid": pid,
             "tid": e["tid"], "ts": e["ts"],
             **({"dur": e["dur"]} if "dur" in e else {}),
             "cat": e.get("cat", "host"),
             **({"args": e["args"]} if "args" in e else {})}
            for e in self.events()
        ] + [
            {"name": e["name"], "ph": "X", "pid": pid,
             "tid": e["tid"], "ts": e["ts"], "dur": e["dur"],
             "cat": "device",
             # paddle source provenance (op@file:line from the compute
             # plane's record_function scopes) rides the exported event so
             # the chrome trace groups device time by recording line
             **({"args": {"src": src}} if (src := self._source_of(
                 e)) else {})}
            for e in self.device_events()
        ]
        # name the interned host-thread lanes so two python threads are
        # never confused in the viewer — only lanes with events in THIS
        # export (under thread churn the intern map remembers every
        # thread ever seen; re-emitting dead empty lanes would bloat
        # each cycle's trace)
        used = {e["tid"] for e in trace_events}
        with _TID_LOCK:
            tids = [(i, n) for i, n in _TID_NAMES.items() if i in used]
        for small_id, tname in tids:
            trace_events.append({"name": "thread_name", "ph": "M",
                                 "pid": pid, "tid": small_id,
                                 "cat": "__metadata",
                                 "args": {"name": tname}})
        trace = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        return path

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        return _summary(self.events(), sorted_by=sorted_by,
                        time_unit=time_unit)


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)
