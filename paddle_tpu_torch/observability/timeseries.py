"""Live monitoring plane: bounded time-series rings fed by a daemon
sampler, plus an online regression watchdog (the counterpart of
``paddle_tpu/observability/timeseries.py``).

While `FLAGS_monitor` is on, a daemon thread wakes every
`FLAGS_monitor_interval_s` and appends one timestamped sample per
series into a bounded ring (capacity `FLAGS_monitor_ring`):

- **rates** from monotonic counters: `steps_per_s`, `tokens_per_s`,
  `compiles_per_s`, `cache_hit_rate`, `fusion_breaks_per_s`,
  `comm_bytes_per_s` (registry counters only move while
  FLAGS_observability is on; the step/token feed comes from the
  ElasticStep hook and is monitor-local, so the headline throughput
  series work with the metrics plane off);
- **gauges** from the byte plane: `mem_live_bytes`, `mem_peak_bytes`,
  `mem_census`, per-device `mem_device_bytes.<dev>`;
- **goodput** bucket fractions over the sample window from the goodput
  ledger (`goodput_frac`, `badput_frac.<bucket>`);
- **efficiency**: windowed `mfu` from the compute plane, and
  `step_time_ms` (mean step duration inside the window).

The regression watchdog keeps an EWMA baseline per headline series
(`step_time_ms` up-bad, `tokens_per_s` / `goodput_frac` down-bad). A
deviation past `FLAGS_monitor_regression_factor`, sustained for
`FLAGS_monitor_regression_steps` consecutive samples, fires once:
`monitor.regressions` increments, a flight note carries the
baseline-vs-current evidence, and (when
`FLAGS_monitor_deep_capture_steps` > 0) a one-shot deep capture arms —
the next K steps run under a fused-runtime profiler whose chrome trace
is dumped beside the flight ring under the same rank-aware retention.
After firing, the baseline re-anchors at the deviant level so a
sustained shift is reported exactly once, not every sample.

Off = the usual discipline: ONE module-attribute read per step hook
(`_state.MONITOR`), no sampler thread, no bound port, zero registry
mutations — asserted by the off-cost tests.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional

from . import _state

_LOG = logging.getLogger("paddle_tpu_torch.observability")

_LOCK = threading.Lock()

# series name -> deque[(t_wall, value)]; every ring-held series is a
# gauge in exposition terms (rates are instantaneous values)
_SERIES: "collections.OrderedDict[str, collections.deque]" = \
    collections.OrderedDict()

# the headline throughput feed (monitor-local so it works with the
# metrics registry off): ElasticStep's hook bumps STEPS, trainers that
# know their batch geometry call note_tokens()
STEPS = 0
TOKENS = 0
_LAST_STEP_WALL: Optional[float] = None   # time.time() — /healthz age
_STEP_T0: Optional[float] = None          # perf_counter of last boundary
_WIN_DUR_S = 0.0                          # step-duration mass this window
_WIN_N = 0

_SAMPLER: Optional["_Sampler"] = None
_WATCHDOG: Optional["_Regression"] = None
REGRESSIONS: List[Dict] = []              # fired events (evidence copies)

# one-shot deep capture: armed by a fired regression, consumed by the
# step hook (profiler must bracket steps, not sampler ticks)
_DEEP = {"armed": 0, "left": 0, "prof": None, "path": None}


def _cap() -> int:
    from .._core.flags import flag_value
    return max(int(flag_value("FLAGS_monitor_ring")), 2)


def _append(name: str, t: float, v) -> None:
    if v is None:
        return
    with _LOCK:
        ring = _SERIES.get(name)
        if ring is None:
            ring = _SERIES[name] = collections.deque(maxlen=_cap())
        ring.append((t, float(v)))


def series_names() -> List[str]:
    with _LOCK:
        return list(_SERIES)


def series(name: str) -> List:
    """Ring dump: [[t_wall, value], ...] oldest first."""
    with _LOCK:
        ring = _SERIES.get(name)
        return [[t, v] for t, v in ring] if ring is not None else []


def latest() -> Dict[str, float]:
    """name -> newest sample value (the /metrics gauge surface)."""
    with _LOCK:
        return {k: ring[-1][1] for k, ring in _SERIES.items() if ring}


def last_step_age_s() -> Optional[float]:
    """Seconds since the last step boundary (None before the first) —
    the /healthz staleness column."""
    t = _LAST_STEP_WALL
    return None if t is None else max(time.time() - t, 0.0)


# ---------------------------------------------------------- step feed

def on_step(step_index: int) -> None:
    """Step-boundary hook (ElasticStep.run calls this behind the
    `_state.MONITOR` gate; AdaptiveTrainer rides through its inner
    ElasticStep). Cheap: two clocks + integer bumps under the lock."""
    global STEPS, _LAST_STEP_WALL, _STEP_T0, _WIN_DUR_S, _WIN_N
    now = time.perf_counter()
    with _LOCK:
        STEPS += 1
        _LAST_STEP_WALL = time.time()
        if _STEP_T0 is not None:
            _WIN_DUR_S += now - _STEP_T0
            _WIN_N += 1
        _STEP_T0 = now
    _deep_capture_tick()


def note_tokens(n: int) -> None:
    """Throughput feed: a trainer that knows its batch geometry calls
    this once per step with the tokens (or samples) consumed; the
    sampler turns the running total into the tokens_per_s series."""
    global TOKENS
    if not _state.MONITOR:
        return
    with _LOCK:
        TOKENS += int(n)


# --------------------------------------------------- regression watch

class _Regression:
    """EWMA baseline per headline series; a deviation past `factor`,
    sustained for `steps` consecutive samples, fires exactly once and
    re-anchors the baseline at the deviant level."""

    _ALPHA = 0.2
    # direction: True = a larger value is a regression
    _HEADLINES = {"step_time_ms": True,
                  "tokens_per_s": False,
                  "goodput_frac": False}

    def __init__(self, factor: float, steps: int):
        self.factor = max(float(factor), 1.0 + 1e-9)
        self.steps = max(int(steps), 1)
        self._state: Dict[str, Dict] = {}

    def judge(self, name: str, value: Optional[float], t: float):
        up_bad = self._HEADLINES.get(name)
        if up_bad is None or value is None or value <= 0.0:
            return
        st = self._state.setdefault(name, {"ewma": None, "consec": 0})
        base = st["ewma"]
        if base is None or base <= 0.0:
            st["ewma"] = float(value)
            return
        dev = (value / base) if up_bad else (base / value)
        if dev >= self.factor:
            st["consec"] += 1
            if st["consec"] >= self.steps:
                self._fire(name, base, value, t)
                # re-anchor: a sustained shift is ONE event, not one
                # per sample forever after
                st["ewma"] = float(value)
                st["consec"] = 0
            return
        st["consec"] = 0
        st["ewma"] = base + self._ALPHA * (value - base)

    def _fire(self, name: str, baseline: float, current: float,
              t: float):
        from . import flight, metrics
        ev = {"series": name, "baseline": round(baseline, 3),
              "current": round(current, 3),
              "factor": round(self.factor, 3),
              "sustained": self.steps, "t_wall": t}
        REGRESSIONS.append(ev)
        metrics.inc("monitor.regressions")
        # evidence rides the flight ring (no-op when FLAGS_flight_
        # recorder is off)
        flight.note("monitor", "regression", **ev)
        _LOG.warning(
            "monitor: %s regressed — baseline %.3f vs current %.3f "
            "(>= %.2fx for %d sample(s))", name, baseline, current,
            self.factor, self.steps)
        from .._core.flags import flag_value
        k = int(flag_value("FLAGS_monitor_deep_capture_steps"))
        if k > 0 and _DEEP["armed"] == 0 and _DEEP["prof"] is None:
            _DEEP["armed"] = k


# ---------------------------------------------------------- deep capture

def _deep_capture_tick():
    """Called from on_step: start the armed profiler at the next step
    boundary, stop after K steps and dump the trace beside the flight
    ring (same rank-aware retention as the text dumps)."""
    if _DEEP["armed"] <= 0 and _DEEP["prof"] is None:
        return
    try:
        if _DEEP["prof"] is None:
            from ..profiler import Profiler, ProfilerTarget
            prof = Profiler(targets=[ProfilerTarget.CPU],
                            fused_runtime=True)
            prof.start()
            _DEEP["prof"] = prof
            _DEEP["left"] = _DEEP["armed"]
            _DEEP["armed"] = 0
            return
        _DEEP["left"] -= 1
        if _DEEP["left"] > 0:
            return
        prof = _DEEP["prof"]
        _DEEP["prof"] = None
        prof.stop()
        from . import flight, metrics
        path = prof.export(flight.trace_path())
        flight.prune_dumps()
        _DEEP["path"] = path
        metrics.inc("monitor.deep_captures")
        _LOG.warning("monitor: deep-capture trace written to %s", path)
    except Exception:
        # capture is advisory; it must never take the train step down
        _DEEP["prof"] = None
        _DEEP["armed"] = 0


# -------------------------------------------------------------- sampler

class _Sampler(threading.Thread):
    """Daemon tick loop: one batch of ring appends per interval plus
    the watchdog pass. All registry reads are snapshots — the sampler
    never mutates counters other than monitor.* on a fired event."""

    def __init__(self, interval_s: float):
        super().__init__(name="pt-monitor-sampler", daemon=True)
        self.interval_s = max(float(interval_s), 0.01)
        self._stop_ev = threading.Event()
        self._prev: Optional[Dict] = None

    def stop(self, timeout: float = 2.0):
        self._stop_ev.set()
        self.join(timeout=timeout)

    def run(self):
        while not self._stop_ev.wait(self.interval_s):
            try:
                sample_once(self._prev_box())
            except Exception:
                _LOG.exception("monitor sampler tick failed")

    def _prev_box(self) -> Dict:
        if self._prev is None:
            self._prev = {}
        return self._prev


def _counter_sums(counters: Dict[str, int]) -> Dict[str, float]:
    out = {"compiles": 0.0, "comm_bytes": 0.0,
           "cache_hit": 0.0, "cache_miss": 0.0,
           "fusion_breaks": float(
               counters.get("fusion.window_breaks", 0))}
    for k, v in counters.items():
        if k.startswith("compiles."):
            out["compiles"] += v
        elif k.startswith("comm.bytes."):
            out["comm_bytes"] += v
        elif k.startswith("cache."):
            if k.endswith(".hit"):
                out["cache_hit"] += v
            elif k.endswith(".miss"):
                out["cache_miss"] += v
    return out


def sample_once(prev: Dict) -> None:
    """One sampler tick: compute window deltas against `prev` (mutated
    in place), append samples, run the watchdog. Exposed un-threaded so
    tests drive deterministic seeded windows."""
    global _WIN_DUR_S, _WIN_N
    from . import metrics
    now = time.time()
    t_prev = prev.get("t")
    dt = (now - t_prev) if t_prev else None
    prev["t"] = now

    with _LOCK:
        steps, tokens = STEPS, TOKENS
        # window step-duration accumulators are consumed per tick
        win_dur, win_n = _WIN_DUR_S, _WIN_N
        _WIN_DUR_S -= win_dur
        _WIN_N -= win_n

    snap = metrics.snapshot()
    sums = _counter_sums(snap["counters"])

    def rate(key: str, cur: float) -> Optional[float]:
        last = prev.get(key)
        prev[key] = cur
        if last is None or dt is None or dt <= 0.0:
            return None
        return max(cur - last, 0.0) / dt

    steps_rate = rate("steps", float(steps))
    tok_rate = rate("tokens", float(tokens))
    _append("steps_per_s", now, steps_rate)
    _append("tokens_per_s", now, tok_rate)
    _append("compiles_per_s", now, rate("compiles", sums["compiles"]))
    _append("comm_bytes_per_s", now,
            rate("comm_bytes", sums["comm_bytes"]))
    _append("fusion_breaks_per_s", now,
            rate("fusion_breaks", sums["fusion_breaks"]))
    dh = rate("cache_hit", sums["cache_hit"])
    dm = rate("cache_miss", sums["cache_miss"])
    if dh is not None and dm is not None and dh + dm > 0:
        _append("cache_hit_rate", now, dh / (dh + dm))

    step_time_ms = (win_dur / win_n * 1e3) if win_n else None
    _append("step_time_ms", now, step_time_ms)

    # byte plane gauges (zeros while FLAGS_memory_telemetry is off)
    from . import memory
    _append("mem_live_bytes", now, memory.live_bytes())
    _append("mem_peak_bytes", now, memory.peak_bytes())
    _append("mem_census", now, memory.census_size())
    for dev, b in memory.device_bytes().items():
        _append(f"mem_device_bytes.{dev}", now, b)

    # goodput bucket fractions over THIS window (ledger deltas)
    goodput_frac = None
    if _state.GOODPUT:
        from . import goodput
        gsnap = goodput.snapshot()
        gprev = prev.get("goodput")
        prev["goodput"] = gsnap
        if gprev is not None:
            d = goodput.delta(gprev, gsnap)
            total = sum(d["buckets"].values())
            if total > 0:
                goodput_frac = d["buckets"].get("execute", 0.0) / total
                _append("goodput_frac", now, goodput_frac)
                for b, v in d["buckets"].items():
                    if b != "execute" and v > 0:
                        _append(f"badput_frac.{b}", now, v / total)

    # windowed MFU from the compute plane's executed-FLOPs ledger
    if _state.COMPUTE:
        from . import compute
        df = rate("flops", float(compute.executed_flops()))
        peak = compute.peak_flops()
        if df is not None and peak > 0:
            _append("mfu", now, compute.mfu(df, peak))

    wd = _WATCHDOG
    if wd is not None:
        wd.judge("step_time_ms", step_time_ms, now)
        if steps_rate:
            # only judge throughput on windows where steps happened —
            # an idle gap (eval, checkpoint) is not a regression
            wd.judge("tokens_per_s", tok_rate, now)
        wd.judge("goodput_frac", goodput_frac, now)


# ------------------------------------------------------------- control

def sampler_alive() -> bool:
    s = _SAMPLER
    return s is not None and s.is_alive()


def _sync(on: bool):
    """Flag watcher body (observability/__init__): start/stop the
    sampler thread and the HTTP exporter with the plane."""
    global _SAMPLER, _WATCHDOG
    from .._core.flags import flag_value
    from . import exporter
    if on:
        _WATCHDOG = _Regression(
            flag_value("FLAGS_monitor_regression_factor"),
            flag_value("FLAGS_monitor_regression_steps"))
        if _SAMPLER is None or not _SAMPLER.is_alive():
            _SAMPLER = _Sampler(flag_value("FLAGS_monitor_interval_s"))
            _SAMPLER.start()
        port = int(flag_value("FLAGS_monitor_port"))
        if port:
            exporter.start(port, str(flag_value("FLAGS_monitor_host")))
    else:
        if _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None
        _WATCHDOG = None
        exporter.stop()


def reset():
    """Drop every ring and the throughput totals (tests)."""
    global STEPS, TOKENS, _LAST_STEP_WALL, _STEP_T0, _WIN_DUR_S, _WIN_N
    with _LOCK:
        _SERIES.clear()
        STEPS = TOKENS = 0
        _LAST_STEP_WALL = _STEP_T0 = None
        _WIN_DUR_S, _WIN_N = 0.0, 0
    del REGRESSIONS[:]
    _DEEP.update(armed=0, left=0, prof=None, path=None)
