"""Structured runtime spans: the counterpart of
``paddle_tpu/observability/spans.py``.

A span is one timed region of the fused runtime (a segment flush, a
runner build, a collective) that fans out to every enabled consumer:

- metrics:  duration observed into a histogram (`hist` name, so e.g.
  every `segment::flush[<reason>]` variant feeds ONE `segment.flush_us`
  histogram instead of fragmenting per reason);
- trace:    an event appended to the profiler's host-event buffer, so
  the chrome-trace export shows the span on the recording thread's
  lane, nested under/over other host events by time;
- flight:   a ring-buffer entry for post-mortem dumps.

Callers pre-gate on `_state.ACTIVE` — constructing a span when
everything is off never happens on a hot path. No span synchronizes the device: a span
times the host's work, and device time comes from the profiler's device
tracer.
"""
from __future__ import annotations

import time

from . import _state, metrics


class Span:
    __slots__ = ("name", "hist", "args", "_t0")

    def __init__(self, name: str, hist=None, args=None):
        self.name = name
        self.hist = hist
        self.args = args
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter_ns()
        if _state.GOODPUT:
            # the attribution ledger's state transition: entering a
            # mapped span (execute/compile/comm/io/ckpt/...) switches
            # the wall-clock bucket the goodput plane accrues into
            from . import goodput
            goodput.on_span_begin(self.name, self._t0)
        return self

    def end(self, error=None):
        if self._t0 is None:
            return
        t0, self._t0 = self._t0, None
        now_ns = time.perf_counter_ns()
        dur_us = (now_ns - t0) / 1000.0
        if _state.GOODPUT:
            from . import goodput
            goodput.on_span_end(self.name, now_ns, dur_us)
        if _state.METRICS and self.hist is not None:
            metrics.observe(self.hist, dur_us)
        if _state.TRACE:
            from ..profiler import _add_span_event
            _add_span_event(self.name, t0 / 1000.0, dur_us, self.args)
        if _state.FLIGHT:
            from . import flight
            detail = dict(self.args) if self.args else {}
            detail["dur_us"] = round(dur_us, 1)
            if error is not None:
                detail["error"] = repr(error)
            flight.note("span", self.name, **detail)
        if _state.DIST:
            from . import distributed
            distributed.note_span(
                self.name, t0, dur_us,
                (self.args or {}).get("bytes", 0))

    def __enter__(self):
        return self.begin()

    def __exit__(self, et, ev, tb):
        self.end(error=ev)
        return False


def span(name: str, hist: str = None, **args) -> Span:
    return Span(name, hist, args or None)


class _NullSpan:
    """Shared no-op stand-in (stateless, safe to reuse) so call sites
    can write `with maybe_span(...)` without a branch."""

    def begin(self):
        return self

    def end(self, error=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()
