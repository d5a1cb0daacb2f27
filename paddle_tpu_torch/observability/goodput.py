"""Goodput plane: job-level wall-clock attribution, step anomalies,
hang watchdog (the counterpart of ``paddle_tpu/observability/goodput.py``).

Every other meter prices a *step* in one domain — spans (time), frames
(cross-rank), bytes, FLOPs. This module accounts for the **job**: a
per-process wall-clock **attribution ledger** that partitions the
timeline into exclusive states, the MLPerf end-to-end efficiency lens
(arxiv 1909.09756, 2011.03641) applied to this runtime:

=============  =====================================================
bucket         what lands there
=============  =====================================================
``execute``    productive device work: ``segment::execute``,
               per-op replay, the fused optimizer update
``compile``    ``segment::compile`` (a runner build)
``input_wait`` the ``io::*`` feed spans — h2d transfer dispatch and
               the new ``io::input_wait`` stall probe (training
               thread blocked on an empty DevicePrefetcher source)
``comm_wait``  host-driven ``comm::*`` collectives
``ckpt_io``    ``ckpt::save`` / ``ckpt::load`` checkpoint I/O
``recovery``   rollback + re-plan + checkpoint restore: from fault
               detection (ElasticStep) to the first successful
               re-run, plus ``resilience::*`` spans outside a
               failure window. STICKY: sub-states inside a recovery
               window stay attributed to recovery, so the bucket
               matches ``resilience.recovery_us`` — redone work is
               badput, not goodput.
``host``       in-step remainder: Python dispatch, cache keys,
               autograd glue (the budget tool's host gap)
``idle``       outside any step (before the first, between jobs)
=============  =====================================================

The ledger is a state machine over the **job thread** (the thread
that marks step boundaries): span begin/end events from
`spans.Span` push/pop mapped states, step marks flip the host/idle
base, recovery probes set the sticky flag. Accrual happens at every
transition, so the **additivity identity** — bucket sum == wall
since ledger start — holds by construction (asserted by
`check_additivity` and the budget tool). Spans from
OTHER threads (the async flush worker) are overlapped work, not wall
time: their durations land in a side `offthread` map, never the
partition.

Riding the ledger:

- a bounded **step-time ring** feeding anomaly detection: a step
  slower than ``FLAGS_goodput_spike_factor`` x the rolling median
  counts ``goodput.anomalies.step_spike``; the existing NaN scan
  (`FLAGS_check_nan_inf`) reports into ``goodput.anomalies.nan``,
  and `note_loss` watches for divergence the same way;
- a **hang watchdog** (reusing `distributed.watchdog`): when no
  probe activity happens within
  ``max(FLAGS_goodput_hang_factor x median step,
  FLAGS_goodput_hang_min_s)``, the watchdog thread captures every
  thread's stack and dumps the flight ring WHILE THE JOB IS STILL
  ALIVE — a stuck collective is named before the job dies silently.

Cluster-wide, each rank's bucket deltas ride the cross-rank telemetry
frames; rank 0's step table gains a goodput column and
`TelemetryAggregator.goodput_report` renders the job-end **cluster
goodput report** (productive chip-seconds / total chip-seconds, top
badput source per rank).

Off-cost is the house pattern: `FLAGS_goodput` is watcher-cached into
`_state.GOODPUT` (folded into `_state.ACTIVE` so spans exist when
only this plane is on); off = one module-attribute read per probe,
zero ring mutations, frozen registry (the off-cost tests).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Tuple

from . import _state

BUCKETS = ("execute", "compile", "input_wait", "comm_wait", "ckpt_io",
           "recovery", "host", "idle")
BADPUT = tuple(b for b in BUCKETS if b != "execute")

# step/loss ring appends since process start: the off-cost freeze
# counter (plane off => this never moves)
RING_MUTATIONS = 0

# span-name -> bucket map, longest prefix wins; names not listed are
# TRANSPARENT (segment::flush brackets its compile/execute children and
# must not shadow them; sot::/telemetry:: are host-side bookkeeping)
_PREFIX_BUCKET = (
    ("segment::execute", "execute"),
    ("segment::replay_per_op", "execute"),
    ("segment::replay_step", "execute"),
    ("optimizer::", "execute"),
    ("segment::compile", "compile"),
    ("comm::", "comm_wait"),
    ("io::", "input_wait"),
    ("ckpt::", "ckpt_io"),
    ("resilience::", "recovery"),
)
_MISS = object()
_BUCKET_MEMO: Dict[str, Optional[str]] = {}


def bucket_of(name: str) -> Optional[str]:
    """The ledger bucket a span name transitions into (None =
    transparent). Memoized — span names are interned formats."""
    b = _BUCKET_MEMO.get(name, _MISS)
    if b is _MISS:
        b = None
        for prefix, bucket in _PREFIX_BUCKET:
            if name.startswith(prefix):
                b = bucket
                break
        _BUCKET_MEMO[name] = b
    return b


class Ledger:
    """Exclusive wall-clock partition of one process's job timeline."""

    def __init__(self):
        self._lock = threading.RLock()
        self._started = False
        self._thread: Optional[int] = None   # the job thread's ident
        self._t_start = 0
        self._t_last = 0
        self._stack = []                     # mapped-span bucket stack
        self._step_depth = 0
        self._recover_depth = 0
        self.buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.offthread: Dict[str, float] = {}
        self.steps = 0
        self.ring: collections.deque = collections.deque(maxlen=128)
        self.loss_ring: collections.deque = collections.deque(maxlen=128)
        self._t_step_begin = 0
        self.hangs = 0
        self.last_hang: Optional[Dict] = None

    # ------------------------------------------------------- lifecycle
    def start(self, ring_capacity: int = 128):
        with self._lock:
            now = time.perf_counter_ns()
            self._started = True
            self._thread = threading.get_ident()
            self._t_start = self._t_last = now
            self._stack = []
            self._step_depth = 0
            self._recover_depth = 0
            self.buckets = {b: 0.0 for b in BUCKETS}
            self.offthread = {}
            self.steps = 0
            self.ring = collections.deque(maxlen=max(ring_capacity, 8))
            self.loss_ring = collections.deque(
                maxlen=max(ring_capacity, 8))
            self.hangs = 0
            self.last_hang = None

    def stop(self):
        with self._lock:
            if self._started:
                self._accrue(time.perf_counter_ns())
                self._started = False

    # -------------------------------------------------------- accrual
    def _cur(self) -> str:
        if self._recover_depth:
            return "recovery"
        if self._stack:
            return self._stack[-1]
        return "host" if self._step_depth else "idle"

    def _accrue(self, now_ns: int):
        # caller holds the lock
        dt = (now_ns - self._t_last) / 1000.0
        if dt > 0:
            self.buckets[self._cur()] += dt
        self._t_last = now_ns

    # ---------------------------------------------------------- spans
    def on_span_begin(self, name: str, t_ns: int):
        if not self._started:
            return
        if threading.get_ident() != self._thread:
            return
        bucket = bucket_of(name)
        if bucket is None:
            return
        with self._lock:
            self._accrue(t_ns)
            self._stack.append(bucket)
        _hang_beat()

    def on_span_end(self, name: str, t_ns: int, dur_us: float):
        if not self._started:
            return
        bucket = bucket_of(name)
        if bucket is None:
            return
        if threading.get_ident() != self._thread:
            # overlapped work (async flush worker, publisher): priced,
            # but never part of the wall partition
            with self._lock:
                self.offthread[bucket] = \
                    self.offthread.get(bucket, 0.0) + dur_us
            return
        with self._lock:
            self._accrue(t_ns)
            if self._stack:
                self._stack.pop()
        _hang_beat()

    # ---------------------------------------------------------- steps
    def step_begin(self, step_index: Optional[int] = None):
        if not self._started:
            return
        with self._lock:
            now = time.perf_counter_ns()
            self._step_depth += 1
            if self._step_depth == 1:
                # the outermost step mark claims the job thread: the
                # training loop is wherever steps actually run
                self._thread = threading.get_ident()
                self._accrue(now)
                self._t_step_begin = now
        _hang_beat()

    def step_end(self, step_index: Optional[int] = None,
                 loss=None, ok: bool = True):
        global RING_MUTATIONS
        if not self._started:
            return
        dur_us = None
        prior_median = None
        with self._lock:
            if self._step_depth == 0:
                return
            if self._step_depth > 1:
                self._step_depth -= 1
                return
            if ok:
                # step duration stamped NOW (the honest step time the
                # ring feeds); the anomaly/watchdog bookkeeping below
                # runs before the step closes, so its cost accrues to
                # the host bucket instead of polluting idle
                now = time.perf_counter_ns()
                dur_us = (now - self._t_step_begin) / 1000.0
                prior_median = self.median_us()
                self.steps += 1
                self.ring.append(dur_us)
                RING_MUTATIONS += 1
        if dur_us is not None:
            _on_step_complete(dur_us, prior_median)
            if loss is not None:
                self.note_loss(loss)
        with self._lock:
            if self._step_depth:
                self._accrue(time.perf_counter_ns())
                self._step_depth -= 1

    def step_abort(self):
        """Unwind a failed step (exception propagating out of the
        wrapper): clears the in-step and recovery states without
        feeding the ring."""
        with self._lock:
            if self._step_depth:
                now = time.perf_counter_ns()
                self._accrue(now)
                self._step_depth -= 1
                if self._step_depth == 0:
                    self._recover_depth = 0
                    self._stack = []

    # ------------------------------------------------------- recovery
    def recovery_begin(self):
        if not self._started:
            return
        with self._lock:
            self._accrue(time.perf_counter_ns())
            self._recover_depth += 1

    def recovery_end(self):
        if not self._started:
            return
        with self._lock:
            if self._recover_depth:
                self._accrue(time.perf_counter_ns())
                self._recover_depth -= 1

    # ------------------------------------------------------ anomalies
    def note_loss(self, value):
        global RING_MUTATIONS
        if not self._started:
            return
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if v != v or v in (float("inf"), float("-inf")):
            note_nan("loss")
            return
        with self._lock:
            ring = self.loss_ring
            prior = sorted(abs(x) for x in ring)
            ring.append(v)
            RING_MUTATIONS += 1
        if len(prior) >= 5:
            med = prior[(len(prior) - 1) // 2]
            from .._core.flags import flag_value
            factor = float(flag_value("FLAGS_goodput_spike_factor"))
            if med > 0 and abs(v) > factor * med:
                from . import metrics
                metrics.inc("goodput.anomalies.loss_divergence")
                if _state.FLIGHT:
                    from . import flight
                    flight.note("goodput", "loss_divergence",
                                loss=round(v, 6),
                                median=round(med, 6))

    def median_us(self) -> Optional[float]:
        vals = sorted(self.ring)
        if not vals:
            return None
        return vals[(len(vals) - 1) // 2]

    # ------------------------------------------------------- snapshot
    def snapshot(self) -> Dict:
        """Point-in-time copy: cumulative buckets (us), wall since
        start, steps, ring stats. The partition is accrued up to NOW,
        so ``sum(buckets) == wall`` by construction."""
        with self._lock:
            if self._started:
                self._accrue(time.perf_counter_ns())
            wall = (self._t_last - self._t_start) / 1000.0
            return {
                "buckets": dict(self.buckets),
                "wall_us": wall,
                "steps": self.steps,
                "median_step_us": self.median_us(),
                "offthread_us": dict(self.offthread),
                "hangs": self.hangs,
            }


LEDGER = Ledger()


# ------------------------------------------------------- hang watchdog

_HANG_LOCK = threading.Lock()
_HANG_MGR = None           # dedicated CommTaskManager
_HANG_TASK = "goodput::step"
_HANG_ARMED = False


def _hang_beat():
    """Any probe-visible progress resets the hang clock — a stuck
    collective (blocked INSIDE its comm span) stops producing
    transitions and times out; a long compile keeps beating at its
    span boundaries only, so the dynamic timeout still bounds it."""
    if _HANG_ARMED:
        mgr = _HANG_MGR
        if mgr is not None:
            mgr.heartbeat(_HANG_TASK)


def _on_step_complete(dur_us: float, prior_median_us: Optional[float]):
    """Outermost step finished: spike detection + (re)arm the hang
    watchdog with a timeout derived from the rolling median."""
    from .._core.flags import flag_value
    if prior_median_us and len(LEDGER.ring) >= 5:
        factor = float(flag_value("FLAGS_goodput_spike_factor"))
        if dur_us > factor * prior_median_us:
            from . import metrics
            metrics.inc("goodput.anomalies.step_spike")
            if _state.FLIGHT:
                from . import flight
                flight.note("goodput", "step_spike",
                            dur_us=round(dur_us, 1),
                            median_us=round(prior_median_us, 1))
    median = LEDGER.median_us()
    if median is None or len(LEDGER.ring) < 2:
        return
    factor = float(flag_value("FLAGS_goodput_hang_factor"))
    floor_s = float(flag_value("FLAGS_goodput_hang_min_s"))
    timeout = max(factor * median / 1e6, floor_s)
    _hang_arm(timeout)


def _hang_arm(timeout_s: float):
    global _HANG_MGR, _HANG_ARMED
    with _HANG_LOCK:
        if _HANG_MGR is None:
            from .._core.flags import flag_value
            from ..distributed.watchdog import CommTaskManager
            _HANG_MGR = CommTaskManager(
                check_interval=float(
                    flag_value("FLAGS_goodput_hang_poll_s")),
                on_timeout=_on_hang)
        if not _HANG_ARMED:
            _HANG_MGR.register(_HANG_TASK, timeout=timeout_s)
            _HANG_ARMED = True
        else:
            _HANG_MGR.heartbeat(_HANG_TASK)
            _HANG_MGR.set_timeout(_HANG_TASK, timeout_s)


def _hang_disarm():
    global _HANG_MGR, _HANG_ARMED
    with _HANG_LOCK:
        if _HANG_MGR is not None:
            _HANG_MGR.deregister(_HANG_TASK)
            _HANG_MGR.shutdown()
            _HANG_MGR = None
        _HANG_ARMED = False


def _on_hang(task):
    """Watchdog-thread handler: the job made no probe-visible progress
    for the dynamic timeout. Count it, record the evidence (which
    bucket it hung in, the captured stacks, the detection latency) and
    leave the stack-carrying flight dump to the watchdog's own
    `_account_fired` — all while the job is still alive; nothing here
    raises in the training thread."""
    from . import metrics
    metrics.inc("goodput.hangs")
    with LEDGER._lock:
        bucket = LEDGER._cur()
        LEDGER.hangs += 1
    LEDGER.last_hang = {
        "bucket": bucket,
        "timeout_s": task.timeout,
        "latency_s": time.monotonic() - task.last_beat,
        "stacks": task.stacks,
        "t_wall": time.time(),
    }
    if _state.FLIGHT:
        from . import flight
        flight.note("goodput", "hang", bucket=bucket,
                    timeout_s=round(task.timeout, 3))


# --------------------------------------------------------- module API

def _sync(on: bool):
    """Flag watcher body (observability/__init__): start/stop the
    ledger with the plane."""
    if on:
        from .._core.flags import flag_value
        LEDGER.start(ring_capacity=int(flag_value("FLAGS_goodput_ring")))
    else:
        _hang_disarm()
        LEDGER.stop()


def on_span_begin(name: str, t_ns: int):
    LEDGER.on_span_begin(name, t_ns)


def on_span_end(name: str, t_ns: int, dur_us: float):
    LEDGER.on_span_end(name, t_ns, dur_us)


def step_begin(step_index: Optional[int] = None):
    if _state.GOODPUT:
        LEDGER.step_begin(step_index)


def step_end(step_index: Optional[int] = None, loss=None):
    if _state.GOODPUT:
        LEDGER.step_end(step_index, loss=loss)


def step_abort():
    if _state.GOODPUT:
        LEDGER.step_abort()


def recovery_begin():
    if _state.GOODPUT:
        LEDGER.recovery_begin()


def recovery_end():
    if _state.GOODPUT:
        LEDGER.recovery_end()


def note_loss(value):
    if _state.GOODPUT:
        LEDGER.note_loss(value)


def note_nan(site: str):
    """The NaN scan's goodput hook (`dispatch._check_nan_inf`): a
    non-finite value is a job-health anomaly whatever the scan's
    raise/warn level does next."""
    if not _state.GOODPUT:
        return
    from . import metrics
    metrics.inc("goodput.anomalies.nan")
    if _state.FLIGHT:
        from . import flight
        flight.note("goodput", "nan", site=site)


def snapshot() -> Dict:
    return LEDGER.snapshot()


def delta(before: Dict, after: Dict) -> Dict:
    """Bucket-wise difference of two snapshots (the budget window /
    telemetry frame form)."""
    b0 = before.get("buckets", {})
    return {
        "buckets": {k: after["buckets"][k] - b0.get(k, 0.0)
                    for k in after["buckets"]},
        "wall_us": after["wall_us"] - before.get("wall_us", 0.0),
        "steps": after["steps"] - before.get("steps", 0),
        "median_step_us": after.get("median_step_us"),
    }


def check_additivity(snap: Dict, rel_tol: float = 0.05) -> bool:
    """The additivity identity: bucket sum == wall within rel_tol
    (the accrual construction makes it exact up to float rounding;
    the tolerance absorbs snapshot-boundary skew on deltas)."""
    total = sum(snap["buckets"].values())
    wall = snap["wall_us"]
    return abs(total - wall) <= max(rel_tol * max(wall, 1.0), 50.0)


def goodput_fraction(snap: Dict) -> Optional[float]:
    total = sum(snap["buckets"].values())
    if total <= 0:
        return None
    return snap["buckets"].get("execute", 0.0) / total


def top_badput(snap: Dict) -> Optional[Tuple[str, float]]:
    """(bucket, us) of the largest non-productive bucket."""
    items = [(b, snap["buckets"].get(b, 0.0)) for b in BADPUT]
    items.sort(key=lambda kv: -kv[1])
    if not items or items[0][1] <= 0:
        return None
    return items[0]


def summary() -> Dict:
    """The `observability.stats()` section while the plane is on."""
    snap = snapshot()
    tb = top_badput(snap)
    snap["goodput_frac"] = goodput_fraction(snap)
    snap["top_badput"] = (
        {"bucket": tb[0], "us": round(tb[1], 1)} if tb else None)
    snap["additivity_ok"] = check_additivity(snap)
    snap["last_hang"] = (
        {k: v for k, v in LEDGER.last_hang.items() if k != "stacks"}
        if LEDGER.last_hang else None)
    snap["buckets"] = {k: round(v, 1) for k, v in snap["buckets"].items()}
    snap["offthread_us"] = {k: round(v, 1)
                            for k, v in snap["offthread_us"].items()}
    return snap


def frame_delta(prev: Optional[Dict]) -> Tuple[Optional[Dict], Dict]:
    """(frame section, new snapshot) for the telemetry publisher: the
    per-rank bucket DELTAS since the last publication, json-normalized
    (rounded floats, string keys)."""
    snap = snapshot()
    d = delta(prev, snap) if prev else dict(
        snap, buckets=dict(snap["buckets"]))
    section = {
        "buckets": {k: round(v, 1) for k, v in d["buckets"].items()
                    if v > 0.0},
        "steps": d["steps"],
    }
    med = snap.get("median_step_us")
    if med is not None:
        section["median_step_us"] = round(med, 1)
    if LEDGER.last_hang is not None:
        section["hang"] = {
            "bucket": LEDGER.last_hang["bucket"],
            "timeout_s": round(LEDGER.last_hang["timeout_s"], 3)}
    return section, snap


def budget_section(before: Dict, after: Dict, steps: int) -> Dict:
    """The budget tool's goodput line, from the SAME ledger the spans
    feed — no second timing source. Asserts the additivity identity
    over the measured window."""
    d = delta(before, after)
    total = sum(d["buckets"].values())
    wall = d["wall_us"]
    # explicit raise, not assert: the identity must hold under
    # python -O too (the off-cost tests gate on it)
    if abs(total - wall) > max(0.05 * max(wall, 1.0), 50.0):
        raise RuntimeError(
            f"goodput additivity violated: bucket sum {total:.1f}us != "
            f"ledger wall {wall:.1f}us over the measured window")
    frac = (d["buckets"].get("execute", 0.0) / total) if total else None
    n = max(steps, 1)
    return {
        "goodput_frac": round(frac, 4) if frac is not None else None,
        "wall_us_per_step": round(wall / n, 1),
        "buckets_us_per_step": {k: round(v / n, 1)
                                for k, v in d["buckets"].items()},
        "additivity_ok": True,
    }


def render_line(section: Dict) -> str:
    frac = section.get("goodput_frac")
    head = ("n/a" if frac is None else f"{frac * 100.0:.1f}% productive")
    parts = []
    per = section.get("buckets_us_per_step", {})
    total = sum(per.values()) or 1.0
    for b in BUCKETS:
        v = per.get(b, 0.0)
        if b != "execute" and v > 0.005 * total:
            parts.append(f"{b} {100.0 * v / total:.1f}%")
    return f"goodput:        {head}" + \
        (" | " + " | ".join(parts) if parts else "")
