"""Cross-rank telemetry plane: merged rank timelines, straggler and
comm-overlap analysis, distributed flight postmortems (the counterpart
of ``paddle_tpu/observability/distributed.py``; its frames are
byte-compatible with the reference's).

Every other observability surface (metrics registry, spans, flight
recorder, the budget tool) is single-process; the distributed runtime
is not. This module makes per-rank telemetry a cluster-wide artifact:

- **publisher** (every rank): at step boundaries each rank publishes a
  compact *telemetry frame* — metrics-snapshot deltas, per-step span
  histogram deltas, recent span events, the step index and mesh epoch,
  and a (wall, perf) clock anchor — through the existing TCPStore
  under ``__telem/`` keys. Publication happens on a daemon thread over
  a bounded drop-oldest queue, so a slow store can never block
  training; the aggregator reads with `try_get` probes, so aggregation
  never blocks either.
- **aggregator** (rank 0, or the offline `merge` CLI verb): merges the
  frames into (a) a cluster **step table** with per-rank durations,
  per-span-family skew columns (slowest rank minus median) and
  straggler flagging, (b) a **comm-overlap report** computing, per
  step, the fraction of ``comm::*`` span time overlapped with
  compute/worker spans — and, from the payload bytes the comm spans
  now carry, the achieved host-collective bandwidth — and (c) a
  **merged chrome trace** with one lane per rank, every rank's
  perf-counter timeline rebased onto a common store-derived clock
  offset.
- **distributed postmortem**: on rank death or a latched async-flush
  worker error, survivors publish their bounded flight-recorder rings
  under ``__telem/post/<rank>`` and rank 0 writes ONE interleaved,
  rank-tagged report next to the (rank-tagged) per-process dumps.

Store key namespace::

    __telem/seq/<rank>          newest published frame seq (ascii int)
    __telem/frame/<rank>/<slot> frame ring, slot = seq % keep (zlib'd
                                json, self-describing) — the store
                                holds at most `keep` frames per rank,
                                however long the job runs
    __telem/post/<rank>         postmortem ring blob

Off-cost follows the house pattern: `FLAGS_distributed_telemetry` is
cached into the `_state.DIST` module gate by a flag watcher; when off,
the step hook is one module-attribute read and NO registry or store
work happens (the off-cost tests assert both exactly).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence

from . import _state

FRAME_VERSION = 1

_SEQ_KEY = "__telem/seq/{rank}"
_FRAME_KEY = "__telem/frame/{rank}/{slot}"
_POST_KEY = "__telem/post/{rank}"

# frames retained in the store per rank (ring of slot keys): bounds
# store growth on long runs while letting a periodically-polling
# aggregator catch up on the recent window
FRAME_KEEP = 64


# ------------------------------------------------------------ frame codec

def encode_frame(frame: Dict) -> bytes:
    """Compact wire form: minified json, zlib-compressed. Each frame
    lands in a per-rank slot ring (seq % FRAME_KEEP), so the store
    holds at most world_size * FRAME_KEEP of them."""
    return zlib.compress(
        json.dumps(frame, separators=(",", ":")).encode())


def decode_frame(blob: bytes) -> Dict:
    frame = json.loads(zlib.decompress(blob).decode())
    v = frame.get("v")
    if v != FRAME_VERSION:
        raise ValueError(f"telemetry frame version {v!r} "
                         f"(expected {FRAME_VERSION})")
    return frame


# -------------------------------------------------------- span event feed

_EVENTS_LOCK = threading.Lock()
_EVENTS: Optional[collections.deque] = None


def _events_ring() -> collections.deque:
    global _EVENTS
    if _EVENTS is None:
        from .._core import flags
        cap = max(int(flags.flag_value(
            "FLAGS_distributed_telemetry_events")), 16)
        _EVENTS = collections.deque(maxlen=cap)
    return _EVENTS


def note_span(name: str, t0_ns: int, dur_us: float, nbytes: int = 0):
    """One finished span, fed by spans.Span.end while `_state.DIST` is
    on: (name, start in perf-us, duration us, payload bytes). Bounded
    ring — a rank that never publishes cannot grow without bound."""
    with _EVENTS_LOCK:
        _events_ring().append(
            (name, t0_ns / 1000.0, dur_us, int(nbytes)))


def _drain_events() -> List:
    with _EVENTS_LOCK:
        if _EVENTS is None:
            return []
        out = list(_EVENTS)
        _EVENTS.clear()
    return out


# -------------------------------------------------------------- publisher

class TelemetryPublisher:
    """Per-rank frame publication at step boundaries.

    `on_step(step)` is the only hot call: it stamps the step boundary
    and, every `FLAGS_distributed_telemetry_interval` steps, snapshots
    the registry delta + drained span events into a frame and hands it
    to the publish thread. The store `set` runs entirely off-thread
    behind a bounded drop-oldest queue — telemetry can lag, training
    cannot block."""

    def __init__(self, store, rank: int, world_size: int,
                 interval: Optional[int] = None):
        from .._core import flags
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.interval = max(int(
            interval if interval is not None
            else flags.flag_value("FLAGS_distributed_telemetry_interval")),
            1)
        self._seq = 0
        self._steps_since = 0
        self._last_counters: Dict[str, int] = {}
        self._last_hists: Dict[str, tuple] = {}
        # (executed-FLOPs total, t_perf_us) at the last publication:
        # the compute section ships per-frame deltas so rank 0 can put
        # an MFU column next to the straggler flags
        self._last_compute = None
        # goodput-ledger snapshot at the last publication: frames ship
        # per-window bucket DELTAS so rank 0 can sum them into the
        # cluster goodput report
        self._last_goodput = None
        self._last_step_t: Optional[float] = None
        self._marks: List = []   # [step_index, end_us, dur_us]
        # retained for the offline dump; bounded so a long training
        # run cannot grow rank memory with its step count
        self.frames: collections.deque = collections.deque(
            maxlen=4 * FRAME_KEEP)
        self._q: collections.deque = collections.deque(maxlen=8)
        self._have_work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._published_seq = 0   # last seq CONFIRMED written
        self._publish_us = None   # metrics.histogram, bound lazily

    # ------------------------------------------------------------ steps
    def on_step(self, step_index: int):
        now = time.perf_counter_ns() / 1000.0
        if self._last_step_t is not None:
            self._marks.append(
                [int(step_index), now, now - self._last_step_t])
        self._last_step_t = now
        self._steps_since += 1
        if self._steps_since >= self.interval:
            self.publish(step_index)

    def publish(self, step_index: int):
        """Build one frame from the deltas since the last publication
        and enqueue it for the store thread."""
        t0 = time.perf_counter_ns()
        self._steps_since = 0
        self._seq += 1
        from . import metrics
        snap = metrics.snapshot()
        counters = {}
        for k, v in snap["counters"].items():
            d = v - self._last_counters.get(k, 0)
            if d:
                counters[k] = d
            self._last_counters[k] = v
        hists = {}
        for k, h in snap["histograms"].items():
            prev = self._last_hists.get(k, (0.0, 0))
            d_total = (h["total"] or 0.0) - prev[0]
            d_count = (h["count"] or 0) - prev[1]
            if d_count or d_total:
                hists[k] = [round(d_total, 3), d_count]
            self._last_hists[k] = ((h["total"] or 0.0), (h["count"] or 0))
        from .._core import lazy
        frame = {
            "v": FRAME_VERSION,
            "rank": self.rank,
            "pid": os.getpid(),
            "seq": self._seq,
            "step": int(step_index),
            "mesh_epoch": int(getattr(lazy, "MESH_EPOCH", 0)),
            "t_wall": time.time(),
            "t_perf_us": time.perf_counter_ns() / 1000.0,
            "counters": counters,
            "hists": hists,
            # json-normalized (lists, rounded) so a retained frame is
            # byte-identical to its store round trip
            "spans": [[n, round(t0, 3), round(d, 3), b]
                      for n, t0, d, b in _drain_events()],
            "marks": [[s, round(t, 3), round(d, 3)]
                      for s, t, d in self._marks],
        }
        if _state.MEM:
            # byte-domain deltas ride the frame: rank 0's step table
            # grows a per-rank memory column from these (watermark +
            # census size + donation total, all O(1) reads)
            from . import memory as _memtel
            frame["mem"] = {"live": _memtel.live_bytes(),
                            "peak": _memtel.peak_bytes(),
                            "donated": _memtel.donated_bytes(),
                            "census": _memtel.census_size(),
                            # STRING-keyed per-device map: survives the
                            # json round trip through the store (the
                            # step-table key-type bug class)
                            "per_device": _memtel.device_bytes()}
        if _state.COMPUTE:
            # FLOP-domain deltas: executed FLOPs since the last frame
            # over the elapsed window -> this rank's achieved GFLOP/s
            # and MFU against its OWN backend peak (each rank prices
            # itself, so a heterogeneous pod stays honest). The step
            # table's straggler column reads this to say "slow AND
            # idle" vs "slow but saturated".
            from . import compute as _comptel
            flops = _comptel.executed_flops()
            now_us = frame["t_perf_us"]
            peak = _comptel.peak_flops()
            comp = {"peak": peak}
            if self._last_compute is not None:
                d_flops = flops - self._last_compute[0]
                dt_us = now_us - self._last_compute[1]
                comp["flops"] = int(d_flops)
                if dt_us > 0:
                    ach = d_flops / (dt_us * 1e-6)
                    comp["gflops"] = round(ach / 1e9, 3)
                    comp["mfu"] = round(_comptel.mfu(ach, peak), 6)
            else:
                comp["flops"] = int(flops)
            frame["compute"] = comp
            self._last_compute = (flops, now_us)
        if _state.GOODPUT:
            # wall-attribution deltas: each rank's exclusive bucket
            # partition since the last frame — rank 0 sums these into
            # the per-rank goodput column and the job-end cluster
            # goodput report (productive / total chip-seconds)
            from . import goodput as _goodtel
            sec, self._last_goodput = _goodtel.frame_delta(
                self._last_goodput)
            if sec and sec.get("buckets"):
                frame["goodput"] = sec
        self._marks = []
        self.frames.append(frame)
        self._q.append(frame)        # drop-oldest: never blocks
        self._have_work.set()
        self._ensure_thread()
        if _state.METRICS:
            if self._publish_us is None:
                self._publish_us = metrics.histogram(
                    "telemetry.publish_us")
            metrics.inc("telemetry.frames")
            self._publish_us.observe(
                (time.perf_counter_ns() - t0) / 1000.0)

    # --------------------------------------------------- publish thread
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            t = threading.Thread(target=self._publish_loop,
                                 name="pt-telemetry-publish",
                                 daemon=True)
            self._thread = t
            t.start()

    def _publish_loop(self):
        while not self._stop.is_set():
            self._have_work.wait(timeout=0.5)
            self._have_work.clear()
            while True:
                try:
                    frame = self._q.popleft()
                except IndexError:
                    break
                try:
                    self.store.set(
                        _FRAME_KEY.format(
                            rank=self.rank,
                            slot=frame["seq"] % FRAME_KEEP),
                        encode_frame(frame))
                    # seq key LAST: an aggregator that sees the seq
                    # always finds the slot populated
                    self.store.set(_SEQ_KEY.format(rank=self.rank),
                                   str(frame["seq"]).encode())
                    self._published_seq = frame["seq"]
                except Exception:
                    # a dead store must not kill the loop; the frame is
                    # lost, training is not
                    if _state.METRICS:
                        from . import metrics
                        metrics.inc("telemetry.publish_errors")

    def flush(self, timeout: float = 5.0):
        """Block until every enqueued frame is CONFIRMED in the store
        (not merely dequeued — a caller about to die must know its last
        frame landed). Drills and tests; training never calls this."""
        deadline = time.time() + timeout
        self._ensure_thread()
        while self._published_seq < self._seq \
                and time.time() < deadline:
            self._have_work.set()
            time.sleep(0.01)

    def shutdown(self):
        self._stop.set()
        self._have_work.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # ----------------------------------------------------- offline dump
    def dump(self, path: str) -> str:
        """Write every frame this rank produced to `telem_rank<R>.json`
        (or `path` if it names a file) for the offline `merge` verb."""
        if os.path.isdir(path):
            path = os.path.join(path, f"telem_rank{self.rank}.json")
        with open(path, "w") as f:
            json.dump({"rank": self.rank,
                       "frames": list(self.frames)}, f)
        return path

    # ------------------------------------------------------- postmortem
    def publish_postmortem(self, reason: str):
        """Publish this rank's bounded flight ring (plus a clock anchor
        so the aggregator can rebase it) under __telem/post/<rank>.
        Synchronous and best-effort: the caller is already handling a
        failure."""
        from . import flight
        events = [[t / 1000.0, kind, name,
                   " ".join(f"{k}={v}" for k, v in detail.items())]
                  for t, kind, name, detail in flight.entries()]
        blob = encode_frame({
            "v": FRAME_VERSION,
            "rank": self.rank,
            "pid": os.getpid(),
            "reason": reason,
            "t_wall": time.time(),
            "t_perf_us": time.perf_counter_ns() / 1000.0,
            "events": events,
        })
        try:
            self.store.set(_POST_KEY.format(rank=self.rank), blob)
        except Exception:
            pass


# ------------------------------------------------------------- aggregator

def clock_anchor(frame: Dict) -> float:
    """A rank's wall-clock origin of its perf timeline, in us: adding
    this to any of the rank's perf-us timestamps yields epoch-us. Two
    ranks' anchors differ by exactly their clock offset, so rebasing
    every rank onto one base rank needs only the frames themselves —
    the store carried the (wall, perf) pair."""
    return frame["t_wall"] * 1e6 - frame["t_perf_us"]


def _interval_union(intervals: List) -> List:
    """Merge [start, end) intervals into a disjoint sorted list."""
    out: List = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_len(a: List, b: List) -> float:
    """Total intersection length of two disjoint sorted interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_family(name: str) -> str:
    """Span names group into families by their `::` prefix:
    `comm::all_reduce` -> `comm`, `segment::flush[...]` -> `segment`."""
    return name.split("::", 1)[0]


class TelemetryAggregator:
    """Merge per-rank frames into cluster-wide reports. Frames come
    from live store probes (`poll_store`), the offline dump files
    (`add_dump`), or directly (`add_frame`); all three feed the same
    merge."""

    def __init__(self):
        self._frames: Dict[int, List[Dict]] = {}
        self._seen: set = set()
        self._next_seq: Dict[int, int] = {}   # per-rank poll cursor
        self._bucket_memo = None   # (frame_count, per_rank, spans)

    # ------------------------------------------------------------ intake
    def add_frame(self, frame: Dict):
        key = (frame["rank"], frame.get("seq"))
        if frame.get("seq") is not None and key in self._seen:
            return
        self._seen.add(key)
        self._frames.setdefault(int(frame["rank"]), []).append(frame)

    def add_dump(self, path: str):
        with open(path) as f:
            doc = json.load(f)
        for frame in doc["frames"]:
            self.add_frame(frame)

    def poll_store(self, store, ranks: Sequence[int]):
        """One non-blocking probe pass: read each rank's latest seq,
        then fetch every not-yet-seen frame still inside its slot ring
        (try_get probes throughout — a missing or slow rank is skipped,
        never waited for)."""
        for r in ranks:
            raw = store.try_get(_SEQ_KEY.format(rank=r), timeout=0.05)
            if not raw:
                continue
            try:
                latest = int(raw.decode())
            except ValueError:
                continue
            start = max(self._next_seq.get(r, 1),
                        latest - FRAME_KEEP + 1)
            for seq in range(start, latest + 1):
                blob = store.try_get(
                    _FRAME_KEY.format(rank=r, slot=seq % FRAME_KEEP),
                    timeout=0.05)
                if not blob:
                    continue
                try:
                    frame = decode_frame(blob)
                except (ValueError, zlib.error):
                    continue
                if frame.get("seq") == seq:   # slot not yet rewritten
                    self.add_frame(frame)
            self._next_seq[r] = latest + 1

    @property
    def ranks(self) -> List[int]:
        return sorted(self._frames)

    def frames(self, rank: int) -> List[Dict]:
        return sorted(self._frames.get(rank, ()),
                      key=lambda f: f.get("seq", 0))

    # ------------------------------------------------------- clock rebase
    def clock_offsets(self, base_rank: Optional[int] = None) -> Dict:
        """Per-rank offset (us) rebasing each rank's perf timeline onto
        `base_rank`'s (default: lowest rank seen). Derived from the
        newest frame's (wall, perf) anchor per rank."""
        if not self._frames:
            return {}
        if base_rank is None:
            base_rank = self.ranks[0]
        anchors = {}
        for r in self.ranks:
            fs = self.frames(r)
            anchors[r] = clock_anchor(fs[-1])
        base = anchors.get(base_rank, next(iter(anchors.values())))
        return {r: a - base for r, a in anchors.items()}

    # --------------------------------------------------------- step table
    def _per_rank_steps(self) -> Dict[int, Dict[int, Dict]]:
        """rank -> step index -> {dur_us, start_us, end_us} (rank-local
        perf timeline)."""
        out: Dict[int, Dict[int, Dict]] = {}
        for r in self.ranks:
            steps: Dict[int, Dict] = {}
            for frame in self.frames(r):
                for step, end_us, dur_us in frame.get("marks", ()):
                    steps[int(step)] = {"dur_us": dur_us,
                                        "start_us": end_us - dur_us,
                                        "end_us": end_us}
            out[r] = steps
        return out

    def _spans_by_step(self, per_rank: Dict) -> Dict:
        """rank -> step -> {"comm": [intervals], "other": [intervals],
        "bytes": payload} — every span event bucketed into its rank's
        step window by midpoint (rank-local timeline; no cross-rank
        clock involved). Transfers are the ``comm::*`` collectives AND
        the ``io::*`` device-feed spans (io::h2d carries payload bytes
        the same way), so the input feed is priced like any other
        transfer."""
        import bisect
        out: Dict[int, Dict[int, Dict]] = {}
        for r in self.ranks:
            windows = per_rank.get(r, {})
            # windows are disjoint: bisect over sorted starts keeps
            # aggregation O((events + steps) log steps) per rank
            ordered = sorted((w["start_us"], w["end_us"], s)
                             for s, w in windows.items())
            starts = [w[0] for w in ordered]
            buckets: Dict[int, Dict] = {}

            def _step_of(t_us):
                i = bisect.bisect_right(starts, t_us) - 1
                if i >= 0 and t_us < ordered[i][1]:
                    return ordered[i][2]
                return None

            for frame in self.frames(r):
                for ev in frame.get("spans", ()):
                    name, t0_us, dur_us = ev[0], ev[1], ev[2]
                    nbytes = ev[3] if len(ev) > 3 else 0
                    s = _step_of(t0_us + dur_us / 2.0)
                    if s is None:
                        continue
                    b = buckets.setdefault(
                        s, {"comm": [], "other": [], "bytes": 0})
                    iv = (t0_us, t0_us + dur_us)
                    if span_family(name) in ("comm", "io"):
                        b["comm"].append(iv)
                        b["bytes"] += int(nbytes)
                    else:
                        b["other"].append(iv)
            out[r] = buckets
        return out

    def _buckets(self):
        """(per_rank_steps, spans_by_step), memoized on the frame
        count: step_table() and overlap_report() are always called
        back-to-back over the same intake, and the bucketing pass is
        the aggregation's heaviest."""
        n = sum(len(fs) for fs in self._frames.values())
        if self._bucket_memo is None or self._bucket_memo[0] != n:
            per_rank = self._per_rank_steps()
            self._bucket_memo = (n, per_rank,
                                 self._spans_by_step(per_rank))
        return self._bucket_memo[1], self._bucket_memo[2]

    def step_table(self) -> Dict:
        """The cluster step table: one row per step index with per-rank
        durations, the cross-rank median, the skew column (slowest
        minus median) and a straggler flag; plus per-span-family skew
        aggregated over the run (slowest rank minus median, us/step).

        Straggler detection uses TWO signals, because a synchronizing
        collective equalizes every rank's wall time: (a) wall skew —
        the slowest rank when no barrier hides it — and (b) comm-wait
        deficit — under a barrier the laggard is the rank that waits
        LEAST inside ``comm::*`` while its peers idle there (MLPerf-
        on-pods' skew attribution, arxiv 1909.09756)."""
        from .._core.flags import flag_value
        factor = float(flag_value("FLAGS_telemetry_straggler_factor"))
        min_us = float(flag_value("FLAGS_telemetry_straggler_min_us"))
        per_rank, spans = self._buckets()
        all_steps = sorted({s for steps in per_rank.values()
                            for s in steps})
        rows = []
        strag_counts: Dict[int, int] = {}
        # per-rank windowed MFU by frame step (the compute plane's
        # frame section): lets a straggler flag say "slow AND idle"
        # (its device is starving — chase input feed / host dispatch)
        # vs "slow but saturated" (its device is busy — chase the work
        # imbalance). Each frame's MFU covers the steps since the
        # previous frame, so a step row reads the first frame at or
        # after it — not the newest frame, which would stamp the
        # end-of-run verdict onto every historical row.
        mfu_frames: Dict[int, list] = {}
        for r in self.ranks:
            pts = sorted(
                (int(f["step"]), f["compute"]["mfu"])
                for f in self.frames(r)
                if f.get("compute", {}).get("mfu") is not None)
            if pts:
                mfu_frames[int(r)] = pts
        # per-rank goodput sections by frame step: a straggler row reads
        # the window COVERING the step (first frame at-or-after) to name
        # its top badput source — the input-wait bucket upgrades the
        # verdict to "input_bound" (the rank is slow because its feed
        # is, not because its work is)
        good_frames: Dict[int, list] = {}
        for r in self.ranks:
            # key on the step alone: a replayed step (checkpoint
            # restore rewinds the index) publishes two frames with the
            # same step value, and the tuple sort would fall through
            # to comparing the goodput dicts — TypeError
            pts = sorted(
                ((int(f["step"]), f["goodput"])
                 for f in self.frames(r) if f.get("goodput")),
                key=lambda p: p[0])
            if pts:
                good_frames[int(r)] = pts
        for s in all_steps:
            durs = {r: steps[s]["dur_us"]
                    for r, steps in per_rank.items() if s in steps}
            if not durs:
                continue
            vals = sorted(durs.values())
            # lower-middle median: skew stays meaningful at even counts
            median = vals[(len(vals) - 1) // 2]
            mx = vals[-1]
            slowest = max(durs, key=durs.get)
            skew = mx - median
            straggler, via = None, None
            if len(durs) > 1 and skew >= min_us \
                    and mx >= factor * median:
                straggler, via = slowest, "wall"
            else:
                # comm-wait deficit: everyone waits in the collective
                # for the laggard, who is the one NOT waiting
                comm = {r: sum(e - b for b, e in _interval_union(
                            spans.get(r, {}).get(s, {}).get("comm",
                                                            [])))
                        for r in durs}
                with_comm = {r: c for r, c in comm.items() if c > 0.0}
                if len(with_comm) > 1:
                    cvals = sorted(with_comm.values())
                    cmed = cvals[(len(cvals) - 1) // 2]
                    laggard = min(with_comm, key=with_comm.get)
                    cmin = with_comm[laggard]
                    if cmed - cmin >= min_us \
                            and cmed >= factor * max(cmin, 1.0):
                        straggler, via = laggard, "comm_wait"
            if straggler is not None:
                strag_counts[straggler] = \
                    strag_counts.get(straggler, 0) + 1
            compute_verdict = None
            badput_name = None
            if straggler is not None:
                mfus = {r: next((m for st, m in mfu_frames[r]
                                 if st >= s), mfu_frames[r][-1][1])
                        for r in durs if r in mfu_frames}
                if straggler in mfus and len(mfus) > 1:
                    cvals2 = sorted(mfus.values())
                    cmed = cvals2[(len(cvals2) - 1) // 2]
                    compute_verdict = ("idle" if mfus[straggler]
                                       < 0.6 * max(cmed, 1e-12)
                                       else "saturated")
                pts = good_frames.get(straggler)
                if pts:
                    sec = next((g for st, g in pts if st >= s),
                               pts[-1][1])
                    buckets = sec.get("buckets", {})
                    bad = sorted(((k, v) for k, v in buckets.items()
                                  if k != "execute"),
                                 key=lambda kv: -kv[1])
                    total = sum(buckets.values())
                    if bad and bad[0][1] > 0:
                        badput_name = bad[0][0]
                        if badput_name == "input_wait" and total \
                                and bad[0][1] >= 0.1 * total:
                            # the straggler's window is dominated by
                            # feed stalls: slow because starved, the
                            # MLPerf input-bound case
                            compute_verdict = "input_bound"
            # per-rank maps are string-keyed so the table survives a
            # json round trip (the CLI ships it between processes)
            rows.append({"step": s,
                         "ranks": {str(r): round(d, 1)
                                   for r, d in sorted(durs.items())},
                         "median_us": round(median, 1),
                         "max_us": round(mx, 1),
                         "skew_us": round(skew, 1),
                         "straggler": straggler,
                         "straggler_via": via,
                         "straggler_compute": compute_verdict,
                         "straggler_badput": badput_name})
        # span-family skew: per rank us/step for each family, then
        # slowest-minus-median across ranks
        fam_rank: Dict[str, Dict[int, float]] = {}
        steps_per_rank = {r: max(len(per_rank[r]), 1) for r in per_rank}
        for r in self.ranks:
            for frame in self.frames(r):
                for hist, (total, _count) in frame.get("hists",
                                                       {}).items():
                    # the plane's own publish cost is not a runtime
                    # span family
                    if not hist.endswith("_us") \
                            or hist.startswith("telemetry."):
                        continue
                    fam = hist[:-3].split(".", 1)[0]
                    fam_rank.setdefault(fam, {}).setdefault(r, 0.0)
                    fam_rank[fam][r] += total
        families = {}
        for fam, by_rank in sorted(fam_rank.items()):
            per_step = {r: v / steps_per_rank.get(r, 1)
                        for r, v in by_rank.items()}
            vals = sorted(per_step.values())
            median = vals[(len(vals) - 1) // 2]   # lower-middle: skew stays meaningful at even rank counts
            slowest = max(per_step, key=per_step.get)
            families[fam] = {
                "ranks": {str(r): round(v, 1)
                          for r, v in sorted(per_step.items())},
                "median_us": round(median, 1),
                "skew_us": round(per_step[slowest] - median, 1),
                "slowest": slowest}
        return {"ranks": self.ranks, "steps": rows,
                "families": families,
                "memory": self._memory_column(),
                "compute": self._compute_column(),
                "goodput": self._goodput_column(),
                "straggler_counts": {str(r): n for r, n in
                                     strag_counts.items()}}

    def _goodput_totals(self) -> Dict[int, Dict[str, float]]:
        """Per-rank bucket totals: the frame DELTAS summed over the
        observed window (each frame ships the partition since its
        predecessor, so the sum is the rank's cumulative ledger)."""
        out: Dict[int, Dict[str, float]] = {}
        for r in self.ranks:
            buckets: Dict[str, float] = {}
            for f in self.frames(r):
                sec = f.get("goodput")
                if not sec:
                    continue
                for k, v in sec.get("buckets", {}).items():
                    buckets[k] = buckets.get(k, 0.0) + float(v)
            if buckets:
                out[int(r)] = buckets
        return out

    def _goodput_column(self) -> Optional[Dict]:
        """Per-rank goodput fraction + top badput source for the step
        table — the job-health column next to memory and MFU."""
        totals = self._goodput_totals()
        if not totals:
            return None
        col: Dict[str, Dict] = {}
        for r, buckets in sorted(totals.items()):
            total = sum(buckets.values())
            prod = buckets.get("execute", 0.0)
            bad = sorted(((k, v) for k, v in buckets.items()
                          if k != "execute"), key=lambda kv: -kv[1])
            col[str(r)] = {
                "goodput_frac": round(prod / total, 4) if total else None,
                "top_badput": bad[0][0] if bad and bad[0][1] > 0
                else None}
        return {"ranks": col}

    def goodput_report(self) -> Optional[Dict]:
        """The job-end CLUSTER goodput report: productive chip-seconds
        over total chip-seconds (every rank's wall is a chip's wall),
        per-rank goodput fraction with the top badput source named —
        the end-to-end efficiency lens the MLPerf pod papers grade
        every scaling recipe through, and the bar a pod run must clear
        before burning real chip hours."""
        totals = self._goodput_totals()
        if not totals:
            return None
        ranks: Dict[str, Dict] = {}
        tot_us = prod_us = 0.0
        for r, buckets in sorted(totals.items()):
            total = sum(buckets.values())
            prod = buckets.get("execute", 0.0)
            tot_us += total
            prod_us += prod
            bad = sorted(((k, v) for k, v in buckets.items()
                          if k != "execute"), key=lambda kv: -kv[1])
            top = bad[0] if bad and bad[0][1] > 0 else None
            hang = any(f.get("goodput", {}).get("hang")
                       for f in self.frames(r))
            ranks[str(r)] = {
                "total_us": round(total, 1),
                "productive_us": round(prod, 1),
                "goodput_frac": round(prod / total, 4) if total
                else None,
                "top_badput": ({"bucket": top[0],
                                "us": round(top[1], 1),
                                "frac": round(top[1] / total, 4)}
                               if top and total else None),
                # same dominance rule as the step-table verdict: a few
                # stray microseconds of feed wait on a near-perfect
                # rank must not fail the 'no input-bound rank' pod bar
                "input_bound": bool(top and top[0] == "input_wait"
                                    and total
                                    and top[1] >= 0.1 * total),
                "hang": bool(hang),
                "buckets_us": {k: round(v, 1)
                               for k, v in sorted(buckets.items())},
            }
        return {
            "ranks": ranks,
            "cluster": {
                "total_chip_s": round(tot_us / 1e6, 4),
                "productive_chip_s": round(prod_us / 1e6, 4),
                "goodput_frac": (round(prod_us / tot_us, 4)
                                 if tot_us else None),
            }}

    def _compute_column(self) -> Optional[Dict]:
        """Per-rank achieved GFLOP/s + MFU from the newest frame that
        carried a ``compute`` section (FLAGS_compute_telemetry on that
        rank) — the per-chip-MFU acceptance column the pod-scale
        ROADMAP item grades against."""
        col: Dict[str, Dict] = {}
        for r in self.ranks:
            for frame in reversed(self.frames(r)):
                c = frame.get("compute")
                if c:
                    col[str(r)] = c
                    break
        return {"ranks": col} if col else None

    def _memory_column(self) -> Optional[Dict]:
        """Per-rank byte watermark from the newest frame that carried a
        ``mem`` section (FLAGS_memory_telemetry on that rank), plus the
        rank nearest its HBM budget: peak/FLAGS_memory_budget_bytes
        when the budget is known, highest absolute peak otherwise —
        THE number that picks the mesh degree before scaling a model
        up (memory, not FLOPs, often binds first)."""
        col: Dict[str, Dict] = {}
        for r in self.ranks:
            for frame in reversed(self.frames(r)):
                m = frame.get("mem")
                if m:
                    col[str(r)] = m
                    break
        if not col:
            return None
        from .._core.flags import flag_value
        budget_b = int(flag_value("FLAGS_memory_budget_bytes"))
        nearest = max(col, key=lambda rs: col[rs].get("peak", 0))
        frac = (round(col[nearest].get("peak", 0) / budget_b, 4)
                if budget_b > 0 else None)
        return {"ranks": col, "budget_bytes": budget_b,
                "nearest_budget": int(nearest),
                "nearest_budget_frac": frac}

    # ----------------------------------------------------- comm overlap
    def overlap_report(self) -> Dict:
        """Per step, the fraction of ``comm::*`` span time that ran
        concurrently with compute/worker spans (interval intersection
        on each rank's own timeline — no cross-rank clock needed), and
        the achieved bandwidth priced from the payload bytes the comm
        spans carry. Host-driven collectives serialize against the
        step loop, so today's baseline is ~0 — the number the
        overlapped-collectives work must beat."""
        per_rank, spans = self._buckets()
        steps: Dict[int, Dict] = {}
        for r in self.ranks:
            for s, b in spans.get(r, {}).items():
                if not b["comm"]:
                    continue
                cu = _interval_union(b["comm"])
                ou = _interval_union(b["other"])
                comm_us = sum(e - beg for beg, e in cu)
                row = steps.setdefault(
                    s, {"comm_us": 0.0, "overlap_us": 0.0, "bytes": 0})
                row["comm_us"] += comm_us
                row["overlap_us"] += _overlap_len(cu, ou)
                row["bytes"] += b["bytes"]
        rows = []
        tot_comm = tot_overlap = tot_bytes = 0.0
        for s in sorted(steps):
            row = steps[s]
            tot_comm += row["comm_us"]
            tot_overlap += row["overlap_us"]
            tot_bytes += row["bytes"]
            frac = (row["overlap_us"] / row["comm_us"]
                    if row["comm_us"] else None)
            bw = (row["bytes"] / (row["comm_us"] / 1e6) / 1e9
                  if row["comm_us"] else None)
            rows.append({"step": s,
                         "comm_us": round(row["comm_us"], 1),
                         "overlap_us": round(row["overlap_us"], 1),
                         "overlap_frac": (round(frac, 4)
                                          if frac is not None else None),
                         "bytes": int(row["bytes"]),
                         "gbps": round(bw, 4) if bw is not None else None})
        total = {
            "comm_us": round(tot_comm, 1),
            "overlap_us": round(tot_overlap, 1),
            "overlap_frac": (round(tot_overlap / tot_comm, 4)
                             if tot_comm else None),
            "bytes": int(tot_bytes),
            "gbps": (round(tot_bytes / (tot_comm / 1e6) / 1e9, 4)
                     if tot_comm else None),
        }
        return {"steps": rows, "total": total,
                "compiled": self._compiled_comm(per_rank)}

    def _compiled_comm(self, per_rank) -> Optional[Dict]:
        """Collectives the SPMD step compiled INTO its executables are
        invisible to the comm::* span layer — their estimated payload
        rides the frames as ``comm.bytes.compiled.<site>`` counter
        deltas (lazy._note_compiled_comm). Summed here so moving the
        collectives off the host keeps them priced: a run whose host
        comm_us dropped to ~0 while compiled bytes are nonzero MOVED
        its traffic into the program instead of losing it."""
        prefix = "comm.bytes.compiled."
        sites: Dict[str, int] = {}
        per_step = 0.0
        for r in self.ranks:
            rank_total = 0
            for frame in self.frames(r):
                for k, v in frame.get("counters", {}).items():
                    if k.startswith(prefix):
                        sites[k[len(prefix):]] = \
                            sites.get(k[len(prefix):], 0) + int(v)
                        rank_total += int(v)
            steps = len(per_rank.get(r, ()))
            if rank_total and steps:
                per_step += rank_total / steps
        if not sites:
            return None
        return {"sites": sites, "bytes": sum(sites.values()),
                "bytes_per_step": round(per_step, 1)}

    # ----------------------------------------------------- merged trace
    def merged_trace(self, path: Optional[str] = None) -> Dict:
        """Chrome trace with one process lane per rank, every event's
        timestamp rebased onto the base rank's timeline via the
        store-derived clock offsets. Returns the trace dict; writes it
        to `path` when given."""
        offsets = self.clock_offsets()
        events: List[Dict] = []
        for r in self.ranks:
            events.append({"name": "process_name", "ph": "M", "pid": r,
                           "tid": 0, "args": {"name": f"rank {r}"}})
            off = offsets.get(r, 0.0)
            for frame in self.frames(r):
                for ev in frame.get("spans", ()):
                    name, t0_us, dur_us = ev[0], ev[1], ev[2]
                    nbytes = ev[3] if len(ev) > 3 else 0
                    e = {"name": name, "ph": "X", "pid": r, "tid": 0,
                         "ts": round(t0_us + off, 3),
                         "dur": round(dur_us, 3), "cat": "runtime"}
                    if nbytes:
                        e["args"] = {"bytes": nbytes}
                    events.append(e)
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    # ------------------------------------------------------- postmortem
    def aggregate_postmortem(self, store, ranks: Sequence[int],
                             reason: str = "",
                             grace_s: Optional[float] = None,
                             path: Optional[str] = None) -> Optional[str]:
        """Rank 0's half of the distributed postmortem: poll
        ``__telem/post/<rank>`` for every rank (try_get, bounded by the
        grace window), interleave all arrived rings by rebased time
        with a ``[rN]`` tag per line, and write one report next to the
        per-process flight dumps. Returns the path (None when nothing
        arrived)."""
        from .._core.flags import flag_value
        if grace_s is None:
            grace_s = float(flag_value(
                "FLAGS_telemetry_postmortem_grace_s"))
        blobs: Dict[int, Dict] = {}
        t_start = time.time()
        deadline = t_start + max(grace_s, 0.0)
        while True:
            for r in ranks:
                if r in blobs:
                    continue
                raw = store.try_get(_POST_KEY.format(rank=r))
                if raw:
                    try:
                        doc = decode_frame(raw)
                    except (ValueError, zlib.error):
                        continue
                    # freshness: a ring published for a PREVIOUS
                    # incident (survivor died before rank 0's delete
                    # below, or a late publish after it) must not be
                    # attributed to this one
                    if doc.get("t_wall", 0.0) >= t_start - 60.0:
                        blobs[r] = doc
            if len(blobs) >= len(ranks) or time.time() >= deadline:
                break
            time.sleep(0.05)
        # consume the keys: the next incident's aggregation starts
        # clean instead of re-reading this one's rings
        for r in list(blobs):
            try:
                store.delete(_POST_KEY.format(rank=r))
            except Exception:
                pass
        if not blobs:
            return None
        # rebase every ring onto the lowest-rank publisher's timeline
        base = clock_anchor(blobs[min(blobs)])
        merged = []
        for r, doc in blobs.items():
            off = clock_anchor(doc) - base
            for t_us, kind, name, detail in doc.get("events", ()):
                merged.append((t_us + off, r, kind, name, detail))
        merged.sort()
        missing = [r for r in ranks if r not in blobs]
        lines = [f"== paddle_tpu DISTRIBUTED flight record: "
                 f"{len(merged)} event(s) from rank(s) "
                 f"{sorted(blobs)} ==",
                 f"trigger: {reason}" if reason else "trigger: (none)"]
        if missing:
            lines.append(f"missing rank(s) (no ring published within "
                         f"{grace_s:.1f}s): {missing}")
        for r, doc in sorted(blobs.items()):
            lines.append(f"  [r{r}] pid {doc.get('pid')} "
                         f"reason={doc.get('reason')!r} "
                         f"events={len(doc.get('events', ()))}")
        now = max((m[0] for m in merged), default=0.0)
        for t_us, r, kind, name, detail in merged:
            rel = (t_us - now) / 1e6
            lines.append(f"  {rel:+10.6f}s  [r{r}] {kind:<6} {name}"
                         + (f"  {detail}" if detail else ""))
        body = "\n".join(lines) + "\n"
        if path is None:
            from . import flight
            d = flight._dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_distributed_r{min(blobs)}_"
                   f"{os.getpid()}.txt")
        with open(path, "w") as f:
            f.write(body)
        if _state.METRICS:
            from . import metrics
            metrics.inc("telemetry.postmortems")
        return path


# ------------------------------------------------------------ module API

_PUB: Optional[TelemetryPublisher] = None
_WORLD_RANKS: Optional[List[int]] = None


def init(store, rank: int, world_size: int,
         interval: Optional[int] = None) -> TelemetryPublisher:
    """Create this process's publisher (idempotent per process). Does
    NOT flip the flag: `FLAGS_distributed_telemetry` stays the single
    on/off switch so the off path costs nothing even when a publisher
    exists."""
    global _PUB, _WORLD_RANKS
    if _PUB is not None:
        _PUB.shutdown()
    _PUB = TelemetryPublisher(store, rank, world_size, interval)
    _WORLD_RANKS = list(range(int(world_size)))
    return _PUB


def publisher() -> Optional[TelemetryPublisher]:
    return _PUB


def shutdown():
    global _PUB
    if _PUB is not None:
        _PUB.shutdown()
        _PUB = None
    with _EVENTS_LOCK:
        if _EVENTS is not None:
            _EVENTS.clear()


def on_step(step_index: int):
    """Step-boundary hook (ElasticStep.run calls this behind the
    `_state.DIST` gate). A process with no publisher ignores it."""
    if _PUB is not None:
        _PUB.on_step(step_index)


def trigger_postmortem(reason: str) -> Optional[str]:
    """Distributed postmortem trigger (rank death seen by the adaptive
    loop, latched async-flush worker error): publish THIS rank's
    flight ring; on rank 0, also poll the survivors' rings and write
    the interleaved report. Never raises — this runs inside failure
    handling."""
    if _PUB is None:
        return None
    try:
        _PUB.publish_postmortem(reason)
        if _PUB.rank == 0:
            return TelemetryAggregator().aggregate_postmortem(
                _PUB.store, _WORLD_RANKS or [0], reason=reason)
    except Exception:
        pass
    return None


# ------------------------------------------------------------- rendering

def render_step_table(table: Dict) -> str:
    ranks = table["ranks"]
    lines = ["== cluster step table =="]
    header = "  step | " + " | ".join(f"r{r:<2}" for r in ranks) \
        + " | median | skew | straggler"
    lines.append(header)
    for row in table["steps"]:
        cells = " | ".join(
            f"{row['ranks'][str(r)] / 1000.0:7.2f}"
            if str(r) in row["ranks"] else "      -"
            for r in ranks)
        flag = "-"
        if row["straggler"] is not None:
            via = row.get("straggler_via")
            verdict = row.get("straggler_compute")
            detail = ", ".join(x for x in (via, verdict) if x)
            flag = f"r{row['straggler']}" \
                + (f" ({detail})" if detail else "")
        lines.append(f"  {row['step']:>4} | {cells} | "
                     f"{row['median_us'] / 1000.0:6.2f} | "
                     f"{row['skew_us'] / 1000.0:5.2f} | {flag}")
    lines.append("  (cells in ms)")
    if table["families"]:
        lines.append("  span-family skew (us/step, slowest - median):")
        for fam, info in table["families"].items():
            lines.append(f"    {fam:<12} skew={info['skew_us']:>10.1f} "
                         f"slowest=r{info['slowest']} "
                         f"median={info['median_us']:.1f}")
    if table.get("memory"):
        mem = table["memory"]
        cells = "  ".join(
            f"r{r}={mem['ranks'][str(r)].get('peak', 0) / 1048576.0:.1f}"
            f"MB" for r in ranks if str(r) in mem["ranks"])
        near = mem["nearest_budget"]
        if mem.get("budget_bytes"):
            frac = mem.get("nearest_budget_frac")
            tail = (f"nearest budget: r{near} at "
                    f"{frac * 100.0:.0f}% of "
                    f"{mem['budget_bytes'] / 1048576.0:.0f}MB")
        else:
            tail = f"highest peak: r{near} (no FLAGS_memory_budget_bytes)"
        lines.append(f"  per-rank peak memory: {cells}  [{tail}]")
    if table.get("compute"):
        comp = table["compute"]
        cells = "  ".join(
            f"r{r}={comp['ranks'][str(r)].get('mfu', 0) * 100.0:.3f}%"
            f"/{comp['ranks'][str(r)].get('gflops', 0):.1f}GF"
            for r in ranks if str(r) in comp["ranks"])
        lines.append(f"  per-rank MFU / achieved GFLOP/s: {cells}")
    if table.get("goodput"):
        good = table["goodput"]
        cells = []
        for r in ranks:
            g = good["ranks"].get(str(r))
            if not g or g.get("goodput_frac") is None:
                continue
            tail = (f" ({g['top_badput']})" if g.get("top_badput")
                    else "")
            cells.append(f"r{r}={g['goodput_frac'] * 100.0:.1f}%{tail}")
        if cells:
            lines.append("  per-rank goodput (top badput): "
                         + "  ".join(cells))
    if table["straggler_counts"]:
        lines.append(f"  straggler flags: "
                     + ", ".join(f"r{r}x{n}" for r, n in
                                 sorted(table["straggler_counts"]
                                        .items())))
    return "\n".join(lines)


def render_goodput(report: Optional[Dict]) -> str:
    if not report:
        return ("== cluster goodput report ==\n  (no goodput frames — "
                "was FLAGS_goodput on while the ranks ran?)")
    c = report["cluster"]
    frac = ("n/a" if c["goodput_frac"] is None
            else f"{c['goodput_frac'] * 100.0:.1f}%")
    lines = ["== cluster goodput report ==",
             f"  cluster: {frac} productive "
             f"({c['productive_chip_s']:.3f} of {c['total_chip_s']:.3f} "
             f"chip-seconds)"]
    for r, g in sorted(report["ranks"].items(), key=lambda kv:
                       int(kv[0])):
        top = g.get("top_badput")
        tail = (f"top badput: {top['bucket']} "
                f"{top['frac'] * 100.0:.1f}%" if top else "no badput")
        marks = []
        if g.get("input_bound"):
            marks.append("INPUT-BOUND")
        if g.get("hang"):
            marks.append("HANG")
        lines.append(f"  r{r}: {g['goodput_frac'] * 100.0:5.1f}% "
                     f"productive | {tail}"
                     + (f"  [{', '.join(marks)}]" if marks else ""))
    return "\n".join(lines)


def render_overlap(report: Dict) -> str:
    lines = ["== comm-overlap report =="]
    t = report["total"]
    frac = ("n/a" if t["overlap_frac"] is None
            else f"{t['overlap_frac']:.3f}")
    bw = "n/a" if t["gbps"] is None else f"{t['gbps']:.3f} GB/s"
    lines.append(f"  total comm: {t['comm_us'] / 1000.0:.2f} ms, "
                 f"overlapped: {t['overlap_us'] / 1000.0:.2f} ms, "
                 f"fraction: {frac}, payload: {t['bytes']} B, "
                 f"achieved: {bw}")
    comp = report.get("compiled")
    if comp:
        sites = ", ".join(f"{k}={v}" for k, v in
                          sorted(comp["sites"].items()))
        lines.append(f"  compiled-in-program collectives (est): "
                     f"{comp['bytes']} B total, "
                     f"{comp['bytes_per_step']} B/step ({sites})")
    for row in report["steps"]:
        frac = ("n/a" if row["overlap_frac"] is None
                else f"{row['overlap_frac']:.3f}")
        lines.append(f"    step {row['step']:>4}: "
                     f"comm {row['comm_us'] / 1000.0:7.2f} ms  "
                     f"overlap {frac:>6}  bytes {row['bytes']:>10}")
    return "\n".join(lines)
