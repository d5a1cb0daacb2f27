"""Process-wide metrics registry: counters, gauges, histograms, the
counterpart of ``paddle_tpu/observability/metrics.py``.

The registry itself is always functional: gating lives at the
instrumented call sites, so a subsystem that only runs on a failure or
recovery path (retries, rollbacks, the world-shrink sweep) counts
unconditionally. ``MUTATIONS`` counts every registry update, so a test can
hold the registry frozen across a path that must do no counting work (the
faults-off gate of the resilience runtime).

Thread safety: one registry lock around every mutation.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict

_LOCK = threading.Lock()

# total registry mutations since process start (or last hard reset) —
# the observability-off work counter
MUTATIONS = 0


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1):
        global MUTATIONS
        with _LOCK:
            self.value += n
            MUTATIONS += 1


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v):
        global MUTATIONS
        with _LOCK:
            self.value = v
            MUTATIONS += 1


# histogram bucket upper bounds, microseconds (last bucket = +inf)
_BOUNDS = (10.0, 50.0, 100.0, 500.0, 1e3, 5e3, 1e4, 5e4, 1e5, 5e5, 1e6)


class Histogram:
    __slots__ = ("name", "count", "total", "min", "max", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.buckets = [0] * (len(_BOUNDS) + 1)

    def observe(self, v: float):
        global MUTATIONS
        with _LOCK:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self.buckets[bisect.bisect_left(_BOUNDS, v)] += 1
            MUTATIONS += 1

    def summary(self) -> dict:
        out = {"count": self.count, "total": self.total,
               "min": self.min, "max": self.max}
        out["avg"] = self.total / self.count if self.count else None
        return out


_COUNTERS: Dict[str, Counter] = {}
_GAUGES: Dict[str, Gauge] = {}
_HISTS: Dict[str, Histogram] = {}


def counter(name: str) -> Counter:
    c = _COUNTERS.get(name)
    if c is None:
        with _LOCK:
            c = _COUNTERS.setdefault(name, Counter(name))
    return c


def gauge(name: str) -> Gauge:
    g = _GAUGES.get(name)
    if g is None:
        with _LOCK:
            g = _GAUGES.setdefault(name, Gauge(name))
    return g


def histogram(name: str) -> Histogram:
    h = _HISTS.get(name)
    if h is None:
        with _LOCK:
            h = _HISTS.setdefault(name, Histogram(name))
    return h


def inc(name: str, n: int = 1):
    counter(name).inc(n)


def observe(name: str, v: float):
    histogram(name).observe(v)


def snapshot() -> dict:
    """Point-in-time copy: {counters, gauges, histograms}."""
    with _LOCK:
        return {
            "counters": {k: c.value for k, c in _COUNTERS.items()},
            "gauges": {k: g.value for k, g in _GAUGES.items()},
            "histograms": {k: h.summary() for k, h in _HISTS.items()},
        }


def reset():
    """Zero every metric IN PLACE. Instrumentation sites (ExecCache)
    hold direct Counter references, so reset must not replace the
    objects — only their values."""
    global MUTATIONS
    with _LOCK:
        for c in _COUNTERS.values():
            c.value = 0
        for g in _GAUGES.values():
            g.value = 0.0
        for h in _HISTS.values():
            h.count = 0
            h.total = 0.0
            h.min = None
            h.max = None
            h.buckets = [0] * (len(_BOUNDS) + 1)
        MUTATIONS = 0
