"""Flight recorder: a bounded ring of recent runtime events, dumped to
a human-readable report when something goes wrong (the counterpart of
``paddle_tpu/observability/flight.py``).

While `FLAGS_flight_recorder` is on, the instrumented runtime pushes
one entry per span/flush/cache decision into a deque (capacity =
FLAGS_flight_recorder_capacity). Three triggers auto-dump the ring:

- an `EnforceNotMet` (framework error) being constructed,
- a failed segment flush (compile/run error in the fusion window),
- a sanitizer error-mode trip (`StaticCheckError`; the sanitizer comes
  with the analysis plane).

so post-mortem debugging gets the last N runtime events — flush
reasons, cache hits, donation decisions — without re-running the
workload under a profiler.
"""
from __future__ import annotations

import collections
import os
import re
import threading
import time
from typing import Optional

from . import _state

_LOCK = threading.Lock()
_RING: Optional[collections.deque] = None
_DUMP_SEQ = 0


def _ring() -> collections.deque:
    global _RING
    if _RING is None:
        from .._core import flags
        cap = max(int(flags.flag_value("FLAGS_flight_recorder_capacity")),
                  1)
        _RING = collections.deque(maxlen=cap)
    return _RING


def _on_capacity_change(v):
    """Resize a live ring in place (keeping the newest entries) so a
    set_flags capacity change takes effect immediately, not at the
    next reset()."""
    global _RING
    with _LOCK:
        if _RING is not None:
            _RING = collections.deque(_RING, maxlen=max(int(v), 1))


from .._core import flags as _flags  # noqa: E402

_flags.watch_flag("FLAGS_flight_recorder_capacity", _on_capacity_change)


def note(kind: str, name: str, **detail):
    """Append one event. Callers gate on `_state.FLIGHT`; calling when
    off is a cheap no-op (so non-hot paths may call unconditionally)."""
    if not _state.FLIGHT:
        return
    with _LOCK:
        _ring().append((time.perf_counter_ns(), kind, name, detail))


def reset():
    global _RING
    with _LOCK:
        _RING = None     # re-read capacity flag on next use


def entries() -> list:
    """Copy of the raw ring: [(perf_ns, kind, name, detail), ...] —
    the distributed postmortem publishes this, rebased, to rank 0."""
    with _LOCK:
        return list(_RING) if _RING is not None else []


def _rank():
    """Trainer rank for dump tagging (None outside a launched job).
    Read per dump, not at import: the launcher sets the env after the
    worker process starts importing."""
    r = os.environ.get("PADDLE_TRAINER_ID")
    return int(r) if r and r.isdigit() else None


def record() -> str:
    """The current ring formatted as a report (oldest first)."""
    with _LOCK:
        entries = list(_RING) if _RING is not None else []
    now = time.perf_counter_ns()
    rank = _rank()
    who = (f"rank {rank} pid {os.getpid()}" if rank is not None
           else f"pid {os.getpid()}")
    lines = [f"== paddle_tpu flight record: {len(entries)} event(s), "
             f"{who} =="]
    for t, kind, name, detail in entries:
        rel = (t - now) / 1e9
        extra = " ".join(f"{k}={v}" for k, v in detail.items())
        lines.append(f"  {rel:+10.6f}s  {kind:<6} {name}"
                     + (f"  {extra}" if extra else ""))
    if not entries:
        lines.append("  (empty — was FLAGS_flight_recorder on while the "
                     "workload ran?)")
    return "\n".join(lines)


def _dump_dir() -> str:
    from .._core import flags
    return (flags.flag_value("FLAGS_flight_recorder_dir")
            or flags.flag_value("FLAGS_profiler_dir") or ".")


# auto-named dump files eligible for retention pruning: plain dumps,
# OOM postmortems, and monitor deep-capture traces (.json), tagged
# (group 1 = rank) or untagged. Distributed postmortem reports
# (flight_distributed_*) and any explicit-path dump never match, so
# retention can never eat them.
_PRUNABLE_RE = re.compile(
    r"^flight_(?:oom_|trace_)?(?:r(\d+)_)?\d+_\d+\.(?:txt|json)$")


def _prune_dumps(d: str, rank: Optional[int]):
    """Retention: keep the newest FLAGS_flight_max_dumps auto-named
    dumps in `d` BELONGING TO THIS RANK (rank-aware — a churning rank
    pruning only its own files can never evict another rank's
    postmortem from a shared dump dir). 0 disables pruning."""
    from .._core import flags
    keep = int(flags.flag_value("FLAGS_flight_max_dumps"))
    if keep <= 0:
        return
    mine = []
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        m = _PRUNABLE_RE.match(name)
        if m is None:
            continue
        r = int(m.group(1)) if m.group(1) is not None else None
        if r != rank:
            continue
        p = os.path.join(d, name)
        try:
            mine.append((os.path.getmtime(p), p))
        except OSError:
            continue
    if len(mine) <= keep:
        return
    mine.sort()            # oldest first
    for _, p in mine[:len(mine) - keep]:
        try:
            os.remove(p)
        except OSError:
            pass


def dump(reason: str = "", path: str = None) -> str:
    """Write the report to a file and return its path. The default
    filename is rank-tagged (`flight_r<rank>_<pid>_<seq>.txt` inside a
    launched job) so concurrent multi-process dumps into one shared
    FLAGS_flight_recorder_dir can never clobber each other; after each
    auto-named dump the oldest files beyond FLAGS_flight_max_dumps are
    pruned (this rank's only)."""
    global _DUMP_SEQ
    prune_dir = None
    rank = None
    if path is None:
        d = _dump_dir()
        os.makedirs(d, exist_ok=True)
        with _LOCK:
            _DUMP_SEQ += 1
            seq = _DUMP_SEQ
        rank = _rank()
        tag = f"r{rank}_" if rank is not None else ""
        path = os.path.join(d, f"flight_{tag}{os.getpid()}_{seq}.txt")
        prune_dir = d
    body = record()
    if reason:
        body = f"trigger: {reason}\n{body}"
    with open(path, "w") as f:
        f.write(body + "\n")
    if prune_dir is not None:
        _prune_dumps(prune_dir, rank)
    from . import metrics
    metrics.inc("flight.dumps")
    return path


def trace_path() -> str:
    """Auto-named path for a monitor deep-capture trace, beside the
    text dumps and under the same rank-aware retention (call
    prune_dumps() after writing it)."""
    global _DUMP_SEQ
    d = _dump_dir()
    os.makedirs(d, exist_ok=True)
    with _LOCK:
        _DUMP_SEQ += 1
        seq = _DUMP_SEQ
    rank = _rank()
    tag = f"r{rank}_" if rank is not None else ""
    return os.path.join(d, f"flight_trace_{tag}{os.getpid()}_{seq}.json")


def prune_dumps():
    """Public retention hook for callers that write auto-named files
    without going through dump() (the monitor's deep-capture trace)."""
    _prune_dumps(_dump_dir(), _rank())


def on_error(kind: str, message: str):
    """Auto-dump trigger (enforce error / sanitizer trip / failed
    flush). Gated by the caller on `_state.FLIGHT`; never raises — a
    dump failure must not mask the original error."""
    note("error", kind, message=message[:200])
    try:
        path = dump(reason=f"{kind}: {message[:200]}")
        import logging
        logging.getLogger("paddle_tpu_torch.observability").error(
            "flight record dumped to %s (%s)", path, kind)
    except Exception:
        pass
