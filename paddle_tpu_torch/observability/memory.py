"""Byte-domain telemetry plane: the counterpart of
``paddle_tpu/observability/memory.py``.

Four pillars, as in the reference:

- **live-buffer census**: a weakref registry of the payload
  ``torch.Tensor``s (bytes, dtype, shape, birth site) kept at the
  ``Tensor``-creation, in-place swap and lazy bind choke points. Views
  share their storage, so the bytes are counted once per storage
  (``untyped_storage().data_ptr()``): a storage enters the census with its
  first registered tensor and leaves with its last. Feeds the
  ``memory.live_bytes`` / ``memory.peak_bytes`` gauges and ``census(top)``.
  The census never holds a strong reference.
- **per-runner memory notes**: where the reference reads XLA's
  ``memory_analysis()`` once per compile, the port notes each runner once
  per build, at its first execution (segment, fused step): its argument
  and output bytes, and its temp bytes from ``torch.cuda.memory_stats()``
  deltas around that execution. The plane never resets the allocator's
  peak (that statistic is the user's), so the temp bytes are exact when
  the execution sets a new process peak and otherwise a lower bound
  (``temp_exact`` says which). On the CPU there is no allocator to read:
  temp bytes are 0 there.
- **donation savings accounting**: ``note_donated`` and ``donated_bytes``
  exist for parity, but nothing calls ``note_donated``. The port donates
  no buffer: torch frees a dead input by its reference count, and the
  optimizer writes its parameters in place (no copy to donate), so the
  figure stays 0.
- **OOM postmortem**: the three execute paths of the lazy window catch
  ``torch.cuda.OutOfMemoryError`` (and the ``exec::oom`` drill's
  ``ResourceExhausted``), write a postmortem naming the top live buffers
  with their birth sites, the failing runner's memory note and the
  watermark, and re-raise the typed ``base.core.ResourceExhaustedError``;
  the async worker latches the typed error, so the sync point raises the
  same class.

``device_bytes()`` reads ``torch.cuda.memory_allocated`` for each card the
process has used, and the census for the CPU.

Off-cost: ``FLAGS_memory_telemetry`` is watcher-cached into ``_state.MEM``;
off = one module-attribute read at every choke point, zero census and zero
registry work.
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from . import _state

# reentrant: a gc run while the lock is held can fire a dead tensor's
# weakref callback (_drop) on the same thread
_LOCK = threading.RLock()


class _Entry:
    """One storage in the census: its bytes and the first registered
    tensor's shape, dtype and birth site."""
    __slots__ = ("nbytes", "shape", "dtype", "site", "t_birth", "device",
                 "refs")


_CENSUS: Dict[Tuple, _Entry] = {}            # storage key -> entry
_BY_ID: Dict[int, Tuple] = {}                # id(tensor) -> (ref, key)

LIVE_BYTES = 0
PEAK_BYTES = 0
# no tensor of the port is sharded across devices within one process:
# the per-device watermark equals the global one
LIVE_PD_BYTES = 0
PEAK_PD_BYTES = 0
DONATED_BYTES = 0
ANALYSIS_CALLS = 0
OOM_POSTMORTEMS = 0
STATIC_PREDICTION: Optional[Dict] = None

_EXECS: "OrderedDict[Tuple, Dict]" = OrderedDict()
_EXEC_CAP = 512
_EXEC_SEQ = 0
_OOM_SEQ = 0


class _SiteTLS(threading.local):
    site = None


_SITE = _SiteTLS()


def set_site(site: str):
    """Birth-site hint for tensors registered on this thread until
    ``clear_site()`` (dispatch tags eager outputs ``eager:<op>``, the
    prefetcher ``io:h2d``)."""
    _SITE.site = site


def clear_site():
    _SITE.site = None


# ------------------------------------------------------------------ census

def _storage_key(val):
    """(device, data pointer) of a payload's storage, or None for what
    holds no real storage (meta and fake tensors, anything not a
    tensor)."""
    import torch
    if not isinstance(val, torch.Tensor):
        return None
    dev = val.device
    if dev.type == "meta" or getattr(val, "fake_mode", None) is not None:
        return None
    try:
        st = val.untyped_storage()
        return (dev.type, dev.index, st.data_ptr()), int(st.nbytes())
    except Exception:
        return None


def note_buffer(val, site: Optional[str] = None):
    """Register one payload. Callers gate on ``_state.MEM``; anything that
    is not a concrete tensor (pending values, fake tensors) is ignored."""
    k = id(val)
    hit = _BY_ID.get(k)
    if hit is not None and hit[0]() is val:
        return                  # already tracked: the first site wins
    sk = _storage_key(val)
    if sk is None:
        return
    key, nb = sk
    if site is None:
        site = _SITE.site or "tensor.create"
    global LIVE_BYTES, PEAK_BYTES, LIVE_PD_BYTES, PEAK_PD_BYTES
    with _LOCK:
        old = _BY_ID.pop(k, None)
        if old is not None:
            # id reuse beat the dead tensor's callback
            _release(k, old[1])
        e = _CENSUS.get(key)
        if e is None:
            e = _Entry()
            e.nbytes = nb
            e.shape = tuple(val.shape)
            e.dtype = str(val.dtype).replace("torch.", "")
            e.site = site
            e.t_birth = time.perf_counter()
            e.device = str(val.device)
            e.refs = set()
            _CENSUS[key] = e
            LIVE_BYTES += nb
            LIVE_PD_BYTES += nb
            if LIVE_BYTES > PEAK_BYTES:
                PEAK_BYTES = LIVE_BYTES
            if LIVE_PD_BYTES > PEAK_PD_BYTES:
                PEAK_PD_BYTES = LIVE_PD_BYTES
        e.refs.add(k)
        _BY_ID[k] = (weakref.ref(val, lambda _r, _k=k: _drop(_k)), key)
        live, peak = LIVE_BYTES, PEAK_BYTES
    _publish(live, peak)


def _release(k: int, key) -> None:
    """Detach tensor id ``k`` from its storage entry (under _LOCK); the
    storage leaves the census with its last tensor."""
    global LIVE_BYTES, LIVE_PD_BYTES
    e = _CENSUS.get(key)
    if e is None:
        return
    e.refs.discard(k)
    if not e.refs:
        del _CENSUS[key]
        LIVE_BYTES -= e.nbytes
        LIVE_PD_BYTES -= e.nbytes


def _drop(k: int):
    """Weakref callback: the tensor died."""
    with _LOCK:
        hit = _BY_ID.get(k)
        if hit is None or hit[0]() is not None:
            return              # replaced by an id-reuse insert
        del _BY_ID[k]
        _release(k, hit[1])
        live, peak = LIVE_BYTES, PEAK_BYTES
    _publish(live, peak)


def _publish(live: int, peak: int):
    """Mirror the totals into the consumers that are on (outside the
    census lock)."""
    if _state.METRICS:
        from . import metrics
        metrics.gauge("memory.live_bytes").set(live)
        metrics.gauge("memory.peak_bytes").set(peak)
    if _state.TRACE:
        from ..profiler import _add_counter_event
        _add_counter_event("memory.live_bytes", live)


def note_segment_outputs(pending, live, out_vals, sig=None, mesh=None):
    """Census registration of a flushed segment's live outputs: birth site
    ``seg@<sig tag>:<op>#<index>``."""
    try:
        tag = (hash(sig) & 0xFFFF) if sig is not None else 0
    except TypeError:
        tag = 0
    suffix = f"@{mesh}" if mesh else ""
    for (j, _s), val in zip(live, out_vals):
        note_buffer(val, f"seg@{tag:04x}:{pending[j].name}#{j}{suffix}")


def note_donated(nbytes: int):
    """Bytes handed over by donation (no caller in the port: see the
    module docstring)."""
    global DONATED_BYTES
    n = int(nbytes)
    with _LOCK:
        DONATED_BYTES += n
    if _state.METRICS:
        from . import metrics
        metrics.inc("memory.donated_bytes", n)


def note_static_prediction(pd_bytes: int, desc: str,
                           mesh: Optional[str] = None):
    """The newest static peak prediction, read back by the OOM postmortem
    (the static memory pass is the analysis plane's)."""
    global STATIC_PREDICTION
    STATIC_PREDICTION = {"pd_bytes": int(pd_bytes), "desc": str(desc),
                         "mesh": mesh}


def device_bytes() -> Dict[str, int]:
    """Live bytes per device, string-keyed (a json round trip keeps it):
    each card the process has used (``"0"``, ``"1"``, ...) from
    ``torch.cuda.memory_allocated``, and ``"cpu"`` from the census."""
    out: Dict[str, int] = {}
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            n = int(torch.cuda.memory_allocated(i))
            if n:
                out[str(i)] = n
    with _LOCK:
        cpu = sum(e.nbytes for e in _CENSUS.values()
                  if e.device == "cpu")
    if cpu or not out:
        out["cpu"] = cpu
    return out


def live_bytes() -> int:
    return LIVE_BYTES


def peak_bytes() -> int:
    return PEAK_BYTES


def per_device_bytes() -> int:
    return LIVE_PD_BYTES


def peak_per_device_bytes() -> int:
    return PEAK_PD_BYTES


def donated_bytes() -> int:
    return DONATED_BYTES


def census_size() -> int:
    return len(_CENSUS)


def reset_peak():
    """Re-anchor the census watermarks at the live totals (the allocator's
    own peak statistic is left alone)."""
    global PEAK_BYTES, PEAK_PD_BYTES
    with _LOCK:
        PEAK_BYTES = LIVE_BYTES
        PEAK_PD_BYTES = LIVE_PD_BYTES


def census(top: Optional[int] = None) -> List[Dict]:
    """Live storages, largest first: [{nbytes, shape, dtype, site,
    age_s}]. Metadata only; no payload reference escapes."""
    now = time.perf_counter()
    with _LOCK:
        rows = [{"nbytes": e.nbytes, "shape": list(e.shape),
                 "dtype": e.dtype, "site": e.site,
                 "age_s": round(now - e.t_birth, 3)}
                for e in _CENSUS.values()]
    rows.sort(key=lambda r: -r["nbytes"])
    return rows[:top] if top else rows


def reset():
    """Drop the census and zero every total."""
    global LIVE_BYTES, PEAK_BYTES, DONATED_BYTES, ANALYSIS_CALLS
    global OOM_POSTMORTEMS, LIVE_PD_BYTES, PEAK_PD_BYTES
    global STATIC_PREDICTION
    with _LOCK:
        _CENSUS.clear()
        _BY_ID.clear()
        _EXECS.clear()
        LIVE_BYTES = PEAK_BYTES = DONATED_BYTES = 0
        LIVE_PD_BYTES = PEAK_PD_BYTES = 0
        ANALYSIS_CALLS = OOM_POSTMORTEMS = 0
        STATIC_PREDICTION = None


# ------------------------------------------------ per-runner memory notes

def _tensor_bytes(vals) -> int:
    import torch
    n = 0
    for v in vals:
        if isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
    return n


def _alloc_stats(vals):
    """(current, peak) allocated bytes of the card the values live on, or
    None off the card."""
    import torch
    dev = next((v.device for v in vals
                if isinstance(v, torch.Tensor) and v.device.type == "cuda"),
               None)
    if dev is None:
        return None
    s = torch.cuda.memory_stats(dev)
    return (int(s.get("allocated_bytes.all.current", 0)),
            int(s.get("allocated_bytes.all.peak", 0)), dev)


def analyze(run, in_vals) -> Tuple[object, Dict]:
    """Run ``run()`` once (a runner's first execution) and note its memory:
    argument and output bytes, and temp bytes from the allocator's
    statistics around the call (see the module docstring). Counted: one
    call per runner build."""
    global ANALYSIS_CALLS
    with _LOCK:
        ANALYSIS_CALLS += 1
    if _state.METRICS:
        from . import metrics
        metrics.inc("memory.analysis_calls")
    before = _alloc_stats(in_vals)
    out = run()
    outs = out if isinstance(out, (list, tuple)) else [out]
    arg_b = _tensor_bytes(in_vals)
    out_b = _tensor_bytes(outs)
    temp, exact = 0, False
    if before is not None:
        import torch
        s = torch.cuda.memory_stats(before[2])
        peak1 = int(s.get("allocated_bytes.all.peak", 0))
        cur0, peak0 = before[0], before[1]
        if peak1 > peak0:
            temp, exact = max(peak1 - cur0 - out_b, 0), True
        else:
            cur1 = int(s.get("allocated_bytes.all.current", 0))
            temp = max(cur1 - cur0 - out_b, 0)
    info = {"temp_bytes": int(temp), "argument_bytes": int(arg_b),
            "output_bytes": int(out_b), "alias_bytes": 0,
            "generated_code_bytes": 0, "temp_exact": exact}
    return out, info


def exec_seq() -> int:
    """Monotonic cursor over note_executable calls."""
    return _EXEC_SEQ


def note_executable(stat: str, key, info: Dict):
    """Record one runner's memory note under its cache identity."""
    global _EXEC_SEQ
    try:
        k = (stat, key)
        hash(k)
    except TypeError:
        k = (stat, id(key))
    with _LOCK:
        _EXEC_SEQ += 1
        _EXECS[k] = dict(info, seq=_EXEC_SEQ)
        _EXECS.move_to_end(k)
        while len(_EXECS) > _EXEC_CAP:
            _EXECS.popitem(last=False)
    if _state.METRICS and "error" not in info:
        from . import metrics
        for field in ("temp_bytes", "argument_bytes", "output_bytes",
                      "generated_code_bytes"):
            v = info.get(field)
            if v:
                metrics.inc("compiles.bytes." + field[:-6], v)


def executable_stats() -> List[Dict]:
    with _LOCK:
        return [{"cache": k[0], **info} for k, info in _EXECS.items()]


def summary() -> Dict:
    """The byte-domain snapshot ``stats()`` and the frames carry."""
    execs = executable_stats()
    return {
        "live_bytes": LIVE_BYTES,
        "peak_bytes": PEAK_BYTES,
        "live_per_device_bytes": LIVE_PD_BYTES,
        "peak_per_device_bytes": PEAK_PD_BYTES,
        "donated_bytes": DONATED_BYTES,
        "census": census_size(),
        "analysis_calls": ANALYSIS_CALLS,
        "oom_postmortems": OOM_POSTMORTEMS,
        "per_device": device_bytes(),
        "static_prediction": dict(STATIC_PREDICTION)
        if STATIC_PREDICTION else None,
        "top": census(8),
        "executables": execs[-8:],
    }


# ---------------------------------------------------------- OOM postmortem

def is_oom(err: BaseException) -> bool:
    """A card's out-of-memory error, or the ``exec::oom`` drill's
    ``ResourceExhausted`` (both say RESOURCE_EXHAUSTED or are typed)."""
    import torch
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    return "RESOURCE_EXHAUSTED" in str(err) \
        or type(err).__name__ == "ResourceExhausted"


def on_oom(err: BaseException, where: str, mem_info: Optional[Dict] = None,
           top: int = 16):
    """Build the OOM postmortem and return the typed error to raise. An
    already-typed framework error passes through untouched."""
    from ..base.core import EnforceNotMet, ResourceExhaustedError
    if isinstance(err, EnforceNotMet):
        return err
    global OOM_POSTMORTEMS
    with _LOCK:
        OOM_POSTMORTEMS += 1
    top_rows = census(top) if _state.MEM else []
    try:
        path = _write_postmortem(where, err, top_rows, mem_info)
    except Exception:                                # pragma: no cover
        path = None
    if _state.METRICS:
        from . import metrics
        metrics.inc("memory.oom_postmortems")
    if _state.FLIGHT:
        from . import flight
        flight.note("oom", where, live_bytes=LIVE_BYTES,
                    peak_bytes=PEAK_BYTES)
    if top_rows:
        r = top_rows[0]
        head = (f"largest live buffer {r['nbytes']} B "
                f"{r['dtype']}{r['shape']} born at {r['site']}")
    else:
        head = ("census empty — was FLAGS_memory_telemetry on while "
                "the workload ran?")
    hint = (f"memory postmortem written to {path}" if path
            else "set FLAGS_memory_telemetry=true for a live-buffer "
                 "census in this report")
    e = ResourceExhaustedError(
        f"out of memory (RESOURCE_EXHAUSTED) at {where}: "
        f"live {LIVE_BYTES} B, peak {PEAK_BYTES} B, {head}",
        context=hint)
    e.postmortem_path = path
    e.__cause__ = err
    return e


def _write_postmortem(where: str, err: BaseException, top_rows: List[Dict],
                      mem_info: Optional[Dict]) -> str:
    """One readable report: watermark, the failing runner's memory note,
    the top live buffers with their birth sites, and the flight ring when
    it is armed. Filed beside (and pruned with) the flight dumps."""
    from . import flight
    global _OOM_SEQ
    lines = [f"== paddle_tpu_torch OOM postmortem ({where}) ==",
             f"error: RESOURCE_EXHAUSTED: {repr(err)[:500]}",
             f"watermark: live={LIVE_BYTES} B  peak={PEAK_BYTES} B  "
             f"donated_total={DONATED_BYTES} B  "
             f"census={census_size()} buffer(s)"]
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            lines.append(
                f"allocator: allocated={torch.cuda.memory_allocated()} B "
                f"reserved={torch.cuda.memory_reserved()} B")
    except Exception:                                # pragma: no cover
        pass
    sp = STATIC_PREDICTION
    if sp:
        lines.append(f"static predicted peak: {sp['pd_bytes']} B/device "
                     f"({sp['desc']}, mesh {sp['mesh'] or 'dp1'}) vs "
                     f"measured peak {PEAK_PD_BYTES} B/device")
    else:
        lines.append("static predicted peak: none recorded")
    if mem_info:
        pretty = " ".join(f"{k}={v}" for k, v in mem_info.items())
        lines.append(f"failing runner memory note: {pretty}")
    else:
        lines.append("failing runner memory note: unavailable (built "
                     "before FLAGS_memory_telemetry, or the build failed)")
    lines.append(f"top {len(top_rows)} live buffer(s) by size:")
    for i, r in enumerate(top_rows, 1):
        lines.append(f"  {i:>3}. {r['nbytes']:>12} B  "
                     f"{r['dtype']}{r['shape']}  {r['site']}  "
                     f"age={r['age_s']}s")
    if not top_rows:
        lines.append("  (none recorded)")
    lines.append("")
    lines.append(flight.record() if _state.FLIGHT
                 else "(flight recorder off — no event ring)")
    d = flight._dump_dir()
    os.makedirs(d, exist_ok=True)
    with _LOCK:
        _OOM_SEQ += 1
        seq = _OOM_SEQ
    rank = flight._rank()
    tag = f"r{rank}_" if rank is not None else ""
    path = os.path.join(d, f"flight_oom_{tag}{os.getpid()}_{seq}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    flight._prune_dumps(d, rank)
    return path
