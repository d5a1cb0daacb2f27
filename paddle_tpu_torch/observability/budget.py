"""Per-step time-budget profile: where a train step's host time goes.

The counterpart of ``paddle_tpu/observability/budget.py`` but for its
static diff (``static_diff``/``render_static_diff`` need the analysis
plane's perf checker, ``ROADMAP.md`` §1 item 9's analysis half: reading
either raises ``NotImplementedError``, ``AnalysisPlaneMissing``).

Spends the span telemetry: run a
workload with metrics on, take the span-histogram delta, and rank every
instrumented component (segment flush / compile / execute, per-op
replay, SOT guard evaluation, optimizer fused step, collectives,
resilience) against the measured wall time per step. Whatever the spans
do NOT account for is the **host gap** — Python dispatch, input feed,
cache-key hashing, autograd glue, and device wait — i.e. exactly the
overhead class "Exploring the limits of Concurrency in ML Training on
Google TPUs" (2011.03641) fingers once the accelerator is saturated.

`segment::flush` brackets its compile/execute children, so the table
reports the flush ENTRY as exclusive scheduling overhead
(flush − compile − execute − replay) to keep the ranking additive.

    python -m paddle_tpu_torch.observability budget --model lenet --steps 20
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

# known histogram -> (display name, parent whose span brackets this
# one). Children subtract out of their parent so the ranked entries sum
# to the accounted total without double counting; any other *_us
# histogram (comm.<op>_us, resilience.*) gets its own top-level row.
_KNOWN = {
    "segment.flush_us": ("segment::flush (scheduling)", None),
    "segment.compile_us": ("segment::compile", "segment.flush_us"),
    "segment.execute_us": ("segment::execute", "segment.flush_us"),
    "segment.replay_per_op_us": ("segment::replay_per_op", None),
    "optimizer.step_us": ("optimizer::fused_step", None),
    "sot.guard_eval_us": ("sot::guard_eval", None),
}


def collect(run_fn: Callable[[], None], steps: int,
            warmup: int = 3) -> Dict:
    """Run `run_fn` (ONE step per call) `steps` times with metrics on
    and return the ranked per-step budget dict. Compile warms up
    off-clock so the budget describes the steady state; the compile
    rows of the ranked table then show residual (cache-miss) compiles
    only.

    The memory AND compute telemetry planes are switched on for the
    whole run — including the warmup, so the warmup compiles capture
    their ``memory_analysis()`` / ``cost_analysis()`` — and the result
    gains a ``memory`` section (peak bytes, compiled temp footprint,
    donated bytes per step) plus a ``compute`` section: per-step FLOPs
    from the executed-runner counters, achieved GFLOP/s over the
    measured wall window, MFU against the per-chip peak
    (FLAGS_device_peak_flops, autodetected when 0), and the roofline
    verdict (arithmetic intensity = flops / bytes-accessed vs the
    ridge point) saying compute-bound vs memory-bound."""
    from . import enable, disable, stats
    from . import compute as _comptel
    from . import goodput as _goodtel
    from . import memory as _memtel
    from .._core.flags import flag_value, set_flags

    mem_was = flag_value("FLAGS_memory_telemetry")
    comp_was = flag_value("FLAGS_compute_telemetry")
    good_was = flag_value("FLAGS_goodput")
    planes = {}
    if not mem_was:
        planes["FLAGS_memory_telemetry"] = True
    if not comp_was:
        planes["FLAGS_compute_telemetry"] = True
    if not good_was:
        planes["FLAGS_goodput"] = True
    if planes:
        set_flags(planes)

    def stepped():
        # the goodput ledger's step boundary: outermost marks only, so
        # a workload that already runs under ElasticStep (whose run()
        # marks its own steps) nests instead of double counting. A
        # step that raises ABORTS (no ring entry, recovery state
        # unwound) instead of being recorded as completed.
        _goodtel.step_begin()
        try:
            run_fn()
        except BaseException:
            _goodtel.step_abort()
            raise
        _goodtel.step_end()
    try:
        seq0 = _memtel.exec_seq()
        cseq0 = _comptel.exec_seq()
        for _ in range(warmup):
            stepped()
        was_on = flag_value("FLAGS_observability")
        enable()
        # delta against a pre-run snapshot, NOT reset(): a process that
        # already has observability on (tests freeze-asserting
        # counters around this call) must not have its registry wiped
        before = stats()
        _memtel.reset_peak()
        donated0 = _memtel.donated_bytes()
        flops0 = _comptel.executed_flops()
        cbytes0 = _comptel.executed_bytes()
        calls0 = _comptel.COST_CALLS
        good0 = _goodtel.snapshot()
        t0 = time.perf_counter()
        for _ in range(steps):
            stepped()
        wall_us = (time.perf_counter() - t0) * 1e6
        good1 = _goodtel.snapshot()
        snap = _delta(before, stats())
        peak = _memtel.peak_bytes()
        peak_pd = _memtel.peak_per_device_bytes()
        live = _memtel.live_bytes()
        donated = _memtel.donated_bytes() - donated0
        execs = _memtel.executable_stats()
        flops = _comptel.executed_flops() - flops0
        cbytes = _comptel.executed_bytes() - cbytes0
        cost_calls = _comptel.COST_CALLS - calls0
        cexecs = [e for e in _comptel.executable_stats()
                  if e.get("seq", 0) > cseq0]
        peak_fl = _comptel.peak_flops()
        if not was_on:
            disable()
    finally:
        restore = {}
        if not mem_was:
            restore["FLAGS_memory_telemetry"] = False
        if not comp_was:
            restore["FLAGS_compute_telemetry"] = False
        if not good_was:
            restore["FLAGS_goodput"] = False
        if restore:
            set_flags(restore)
    out = _rank(snap, wall_us, steps)
    # job-level wall attribution over the measured window, from the
    # SAME ledger the spans feed (no second timing source); the bucket
    # additivity identity is asserted inside budget_section
    out["goodput"] = _goodtel.budget_section(good0, good1, steps)
    achieved = flops / (wall_us * 1e-6) if wall_us else 0.0
    out["compute"] = {
        "flops_per_step": round(flops / steps, 1),
        "gflops_per_s": round(achieved / 1e9, 3),
        "mfu": round(_comptel.mfu(achieved, peak_fl), 6),
        "peak_flops": peak_fl,
        # cost counts DURING the measured window: a warm steady
        # state makes ZERO (counted-once-per-runner-build contract,
        # counter-asserted in tests)
        "cost_analysis_calls_measured": int(cost_calls),
        **_comptel.roofline(flops, cbytes, peak=peak_fl),
        "executables": cexecs[-6:],
    }
    # prefer executables compiled DURING this collect (warmup included)
    # so another workload's entries in the process-global log can't
    # pollute the column; a fully-warm process (no new compiles — the
    # caches already hold this workload, analyzed earlier) falls back
    # to the whole log
    fresh = [e for e in execs if e.get("seq", 0) > seq0]
    execs = fresh or execs
    temps = [e.get("temp_bytes") or 0 for e in execs]
    out["memory"] = {
        "peak_bytes": int(peak),
        # shard-priced watermark: what the static mem-liveness pass
        # predicts, and what sizes a mesh against the HBM budget
        "peak_per_device_bytes": int(peak_pd),
        "live_bytes": int(live),
        "donated_bytes_per_step": round(donated / steps, 1),
        # largest temp allocation among the compiled executables this
        # workload runs — its steady-state compiled footprint
        "temp_bytes": int(max(temps)) if temps else 0,
        "executables": execs[-6:],
    }
    return out


def _delta(before: Dict, after: Dict) -> Dict:
    b_hists = before.get("histograms", {})
    hists = {}
    for k, h in after.get("histograms", {}).items():
        bh = b_hists.get(k, {})
        hists[k] = {"total": (h.get("total") or 0.0)
                    - (bh.get("total") or 0.0),
                    "count": (h.get("count") or 0)
                    - (bh.get("count") or 0)}
    b_ctrs = before.get("counters", {})
    counters = {k: v - b_ctrs.get(k, 0)
                for k, v in after.get("counters", {}).items()}
    return {"histograms": hists, "counters": counters,
            "step_cache_hit_rate": after.get("step_cache_hit_rate")}


def _rank(snap: Dict, wall_us: float, steps: int) -> Dict:
    hists = snap.get("histograms", {})
    entries: List[Dict] = []
    accounted = 0.0
    for hist, h in hists.items():
        if not hist.endswith("_us"):
            continue
        total, count = (h.get("total") or 0.0), (h.get("count") or 0)
        if not count and not total:
            continue
        name, parent = _KNOWN.get(hist, (hist[:-3].replace(".", "::"),
                                         None))
        entries.append({"name": name, "hist": hist,
                        "us_per_step": total / steps,
                        "calls_per_step": count / steps,
                        "_parent": parent})
    # make parents exclusive
    for e in entries:
        child_sum = sum(c["us_per_step"] for c in entries
                        if c["_parent"] == e["hist"])
        if child_sum:
            e["us_per_step"] = max(e["us_per_step"] - child_sum, 0.0)
    for e in entries:
        e.pop("_parent", None)
        accounted += e["us_per_step"]
    wall_per_step = wall_us / steps
    host_gap = max(wall_per_step - accounted, 0.0)
    entries.append({"name": "host gap (dispatch / input feed / "
                            "device wait — unspanned)",
                    "hist": None, "us_per_step": host_gap,
                    "calls_per_step": None})
    entries.sort(key=lambda e: -e["us_per_step"])
    for e in entries:
        e["pct_of_step"] = round(100.0 * e["us_per_step"] / wall_per_step,
                                 2) if wall_per_step else None
        e["us_per_step"] = round(e["us_per_step"], 2)
        if e["calls_per_step"] is not None:
            e["calls_per_step"] = round(e["calls_per_step"], 3)
    counters = snap.get("counters", {})
    return {
        "steps": steps,
        "wall_us_per_step": round(wall_per_step, 2),
        "accounted_us_per_step": round(accounted, 2),
        "host_gap_us_per_step": round(host_gap, 2),
        # span time in excess of wall time = work that ran CONCURRENTLY
        # with the step loop (the async flush worker's lane) — the
        # direct evidence the pipeline took dispatch off the critical
        # path rather than merely relabeling it
        "overlap_us_per_step": round(max(accounted - wall_per_step, 0.0),
                                     2),
        "entries": entries,
        "counters": {k: counters[k] for k in sorted(counters)
                     if k.startswith(("segment.", "cache.", "compiles.",
                                      "optimizer.", "sot.", "eager.",
                                      "fusion.", "comm.", "memory.",
                                      "compute.", "io.", "record."))},
        "step_cache_hit_rate": snap.get("step_cache_hit_rate"),
    }


# ------------------------------------------------------- static diff

class AnalysisPlaneMissing(NotImplementedError, AttributeError):
    """``static_diff`` and ``render_static_diff`` reconcile the analysis
    plane's static perf checker (``analysis/perf_checks``) against the
    meters; that plane is ``ROADMAP.md`` §1 item 9's analysis half. Reading
    either name raises this: a ``NotImplementedError`` for a caller, an
    ``AttributeError`` for ``hasattr``, so the module does not claim the
    names."""


def __getattr__(name: str):
    if name in ("static_diff", "render_static_diff"):
        raise AnalysisPlaneMissing(
            f"budget.{name} needs the analysis plane's perf checker "
            f"(analysis/perf_checks), ROADMAP.md section 1 item 9's "
            f"analysis half; not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB"):
        if abs(n) < 1024.0:
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.2f} GB"


def render(budget: Dict, title: str = "per-step budget") -> str:
    lines = [f"== {title} ==",
             f"  wall/step:      {budget['wall_us_per_step']:>12.1f} us",
             f"  accounted:      {budget['accounted_us_per_step']:>12.1f}"
             f" us",
             f"  host gap:       {budget['host_gap_us_per_step']:>12.1f}"
             f" us"]
    mem = budget.get("memory")
    if mem:
        lines.append(
            f"  memory:         peak {_fmt_bytes(mem['peak_bytes'])} | "
            f"temp {_fmt_bytes(mem['temp_bytes'])} | "
            f"donated/step {_fmt_bytes(mem['donated_bytes_per_step'])} |"
            f" live(end) {_fmt_bytes(mem['live_bytes'])}")
    comp = budget.get("compute")
    if comp and comp.get("flops_per_step"):
        bound = comp.get("bound") or "n/a"
        lines.append(
            f"  compute:        {comp['gflops_per_s']:.2f} GFLOP/s | "
            f"MFU {comp['mfu'] * 100.0:.3f}% of "
            f"{comp['peak_flops'] / 1e9:.0f} GFLOP/s peak | "
            f"AI {comp['arith_intensity']:.2f} FLOP/B vs ridge "
            f"{comp['ridge_intensity']:.2f} ({bound})")
    good = budget.get("goodput")
    if good:
        from . import goodput as _goodtel
        lines.append("  " + _goodtel.render_line(good))
    lines.append("  ranked components:")
    for e in budget["entries"]:
        calls = ("" if e["calls_per_step"] is None
                 else f"  x{e['calls_per_step']:g}/step")
        lines.append(f"    {e['us_per_step']:>10.1f} us "
                     f"{e['pct_of_step']:>6.2f}%  {e['name']}{calls}")
    return "\n".join(lines)
