"""The flag registry: the counterpart of ``paddle_tpu/_core/flags.py``.

A flag is a name, a typed default and a help line; an environment variable
of the flag's name overrides the default when the flag is defined.
``get_flags`` / ``set_flags`` read and write them from Python
(``paddle.get_flags`` / ``paddle.set_flags``), and ``watch_flag`` lets a
module keep a cached copy in step with ``set_flags``. The flags defined
here are those the compile path reads (``jit``, ``static``, ``ir``,
``inference``, ``onnx``), those of the steady-state runtime
(``_core/lazy.py``, ``_core/cache.py``, ``_core/async_flush.py``,
``jit/sot``, ``_core/persist.py``) and those of the native runtime and the
eager communication API (``_core/native.py``, ``distributed/store.py``,
``distributed/parallel.py``), those of the eager pipeline, the fault
injection, the retry policies and the distributed checkpoint
(``distributed/pipeline.py``, ``distributed/resilience``,
``distributed/checkpoint.py``), and those of the measurement plane (the
NaN/Inf scan of ``_core/dispatch.py``, ``profiler`` and the planes of
``observability``), with the reference's names and defaults except one:
``FLAGS_eager_fusion`` is off by default here (the card's stream already
runs ahead of the host; ``ROADMAP.md`` §3).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Iterable, List, Union

_LOCK = threading.RLock()
_REGISTRY: Dict[str, "Flag"] = {}
_WATCHERS: Dict[str, List[Callable]] = {}


class Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name: str, default: Any, help: str = ""):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help
        env = os.environ.get(name)
        self.value = _parse(env, self.type) if env is not None else default


def _parse(text: str, ty: type):
    if ty is bool:
        return text.lower() in ("1", "true", "yes", "on")
    return ty(text)


def define_flag(name: str, default: Any, help: str = "") -> Flag:
    """Defines ``name`` (once: a second definition returns the first)."""
    with _LOCK:
        if name not in _REGISTRY:
            _REGISTRY[name] = Flag(name, default, help)
        return _REGISTRY[name]


def _known(name: str) -> "Flag":
    if name not in _REGISTRY:
        raise ValueError(f"unknown flag: {name}")
    return _REGISTRY[name]


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    with _LOCK:
        return {name: _known(name).value for name in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    """Sets each flag, its value parsed to the flag's type; every name and
    value is checked before any flag changes. Watchers run after."""
    with _LOCK:
        updates = []
        for name, value in flags.items():
            flag = _known(name)
            parsed = _parse(value, flag.type) \
                if isinstance(value, str) and flag.type is not str \
                else flag.type(value)
            updates.append((flag, parsed))
        fire = []
        for flag, parsed in updates:
            flag.value = parsed
            fire += [(cb, parsed) for cb in _WATCHERS.get(flag.name, ())]
    for cb, value in fire:
        cb(value)


def watch_flag(name: str, callback: Callable) -> None:
    """Calls ``callback(value)`` now and after every ``set_flags`` of
    ``name``."""
    with _LOCK:
        value = _known(name).value
        _WATCHERS.setdefault(name, []).append(callback)
    callback(value)


def flag_value(name: str):
    return _REGISTRY[name].value


define_flag("FLAGS_dy2static_cache_limit", 64,
            "Max cached (signature -> executable) entries per "
            "to_static function before oldest eviction.")
define_flag("FLAGS_apply_ir_passes", True,
            "run the IR pass pipeline when compiling static Programs")
define_flag("FLAGS_ir_pass_disable", "",
            "Comma-separated IR pass names to skip in the pipeline.")
define_flag("FLAGS_enable_auto_layout", False,
            "Run the NHWC auto-layout pass in the static pipeline "
            "(transpose-sunk NHWC convs, auto_layout_pass.cc role).")
define_flag("FLAGS_jit_save_meta", True,
            "jit.save writes the .pdmeta named-IO sidecar used by the "
            "inference AnalysisPredictor.")
define_flag("FLAGS_allow_pickle_load", False,
            "Permit loading legacy pickle parameter files (pickle can "
            "execute code; PT_ALLOW_PICKLE_LOAD=1 is the env spelling).")
define_flag("FLAGS_inference_opt_level", 2,
            "Default inference Config optimization level.")
define_flag("FLAGS_inference_donate_inputs", False,
            "Default inference Config input-donation setting.")
define_flag("FLAGS_onnx_opset", 13,
            "Minimum default-domain opset version for ONNX export "
            "(raised per-op when an emitted op needs newer).")

# ---- the steady-state runtime (the reference's flags.py:168-252)
define_flag("FLAGS_lazy_max_segment_ops", 256,
            "Lazy fusion window: pending ops per segment before a forced "
            "flush (caps a segment's size and its peak trace memory).")
define_flag("FLAGS_lazy_enable", True,
            "Kill-switch for the lazy fusion window: when false, "
            "lazy_guard() becomes a no-op and ops dispatch eagerly.")
define_flag("FLAGS_eager_fusion", False,
            "Ambient fusion window: plain dygraph code (no lazy_guard) "
            "records into a segment that runs at the next sync point. Off "
            "by default in the port (the reference's default is on): the "
            "card's stream already gives the run-ahead the window gives "
            "the reference.")
define_flag("FLAGS_executable_cache_capacity", 1024,
            "LRU capacity for each runner cache (lazy segment, fused "
            "step, record-time metadata); 0 = unbounded.")
define_flag("FLAGS_record_fast_path", True,
            "Trace-stable record fast path: after a sealed segment's "
            "signature memo proves the op stream repeats, later "
            "iterations replay the retained op skeleton position by "
            "position, reusing its cached output metadata. Any mismatch "
            "falls back to the full record path for the rest of the "
            "segment.")
define_flag("FLAGS_step_replay_after", 3,
            "Whole-step promotion threshold: after this many consecutive "
            "clean skeleton replays of a sealed segment, its seal skips "
            "signature reconstruction (a step plan). 0 disables "
            "promotion.")
define_flag("FLAGS_async_flush", False,
            "Hand sealed lazy segments to a single-worker flush executor; "
            "results materialize through pending-value placeholders and "
            "worker errors re-raise at the next sync point.")
define_flag("FLAGS_sot_cache_entries", 8,
            "Max guarded fast-path entries kept per SotFunction.")
define_flag("FLAGS_sot_inline_depth", 8,
            "Max recursive bytecode-inline depth in the SOT executor.")
define_flag("FLAGS_sot_step_budget", 2_000_000,
            "Max interpreted bytecode steps per SOT frame before the "
            "frame falls back to native execution.")
define_flag("FLAGS_sot_guard_size_cap", 64,
            "Largest container/array value-guarded by SOT; larger "
            "inputs refuse the fast path instead.")
define_flag("FLAGS_guard_log", False,
            "Print each SOT guard miss (the failing guards).")
define_flag("FLAGS_executable_cache_dir", "",
            "Persistent compile cache directory ('' = off): the traced "
            "graphs of to_static and of SOT's fast path are stored under a "
            "digest of their cache key, with a checksum and the torch, CUDA "
            "and device stamps, and a later process loads them instead of "
            "tracing again; inductor's FX-graph and AOTAutograd caches go "
            "to its 'inductor' subdirectory while it is set.")
define_flag("FLAGS_executable_cache_disk_max_mb", 512,
            "Persistent compile cache disk budget in MB: after each store, "
            "the oldest entries are pruned until the directory fits (0 = "
            "unbounded).")

# ---- the native runtime and the eager communication API
define_flag("FLAGS_host_alloc_chunk_kb", 256,
            "Native host allocator pool chunk size in KB "
            "(csrc/allocator.cc pt_alloc_create).")
define_flag("FLAGS_tcp_store_timeout_s", 300.0,
            "TCPStore client connect/get timeout in seconds.")
define_flag("FLAGS_fuse_buffer_size_mb", 25,
            "DataParallel gradient-fusion bucket size in MB "
            "(reducer comm_buffer_size default).")
define_flag("FLAGS_dp_broadcast_params", True,
            "DataParallel broadcasts parameters from rank 0 at wrap "
            "time so replicas start identical.")

# ---- the eager pipeline (the reference's flags.py:430-436, :667)
define_flag("FLAGS_pipeline_stash_warn_mb", 0,
            "Warn when a pipeline runtime's activation stash exceeds "
            "this many MB (0 = off).")
define_flag("FLAGS_pipeline_max_inflight", 0,
            "Hard cap on stashed in-flight micro-batches per pipeline "
            "rank (0 = unlimited; exceeding raises).")
define_flag("FLAGS_zb_w_extra_delay", 0,
            "Extra micro-batches of weight-grad (W) deferral in the "
            "ZeroBubble schedule beyond the warmup depth.")

# ---- fault injection, retries and the checkpoint (:354-378, :678)
define_flag("FLAGS_fault_inject", "",
            "Deterministic fault-injection plan ('' = off): "
            "'seed=N;site[@occ]=kind[(arg)][:prob];...' where site is a "
            "named injection point (store::get/set/add/wait, pg::init, "
            "comm::<op>, segment::compile, exec::oom, step::N, "
            "ckpt::save, ckpt::load, member::leave, member::join, "
            "preempt::notice; trailing * wildcards match) and kind is "
            "fail | die | delay(s) | stuck(s) | oom. See "
            "distributed/resilience/faults.py.")
define_flag("FLAGS_retry_max_attempts", 3,
            "RetryPolicy default attempt budget for transient failures "
            "(TCPStore ops, process-group bring-up, host collectives, "
            "checkpoint I/O).")
define_flag("FLAGS_retry_backoff_s", 0.05,
            "RetryPolicy base backoff delay in seconds (exponential "
            "with deterministic jitter).")
define_flag("FLAGS_checkpoint_keep", 3,
            "CheckpointManager: verified checkpoint generations kept on "
            "disk (older generations pruned after each save; load "
            "falls back to the newest verified older generation when "
            "the latest fails its checksum).")
define_flag("FLAGS_ckpt_strict_load", True,
            "Distributed checkpoint load fails on missing/unexpected "
            "keys instead of loading the intersection.")

# ---- elastic resilience (:370, :378, :384, :390-403, :439-441)
define_flag("FLAGS_elastic_max_retries", 2,
            "ElasticStep: rollback-and-rerun attempts per training step "
            "before the failure propagates.")
define_flag("FLAGS_checkpoint_interval_steps", 0,
            "AdaptiveTrainer: auto-checkpoint every N step boundaries "
            "through the retention manager (0 = off); a trainer built "
            "with an explicit checkpoint_every overrides the flag.")
define_flag("FLAGS_elastic_grow_chunk_kb", 512,
            "grow_world state broadcast: TCPStore chunk size in KiB for "
            "the survivor->joiner state transfer (each chunk is "
            "sha256-checksummed; the whole payload is verified before "
            "unpickling).")
define_flag("FLAGS_elastic_heartbeat_interval_s", 0.5,
            "ElasticManager heartbeat/watch interval in seconds.")
define_flag("FLAGS_elastic_eviction_debounce", 3,
            "ElasticManager: consecutive missed/stale heartbeat probes "
            "before a node is evicted from membership (one slow scan must "
            "not publish a member::leave epoch; 1 evicts on the first "
            "miss).")

# True while FLAGS_fault_inject names a plan: the gate the runtime's hot
# paths (the lazy window's compile and execute sites, the elastic step,
# the trainer's boundary poll) read without importing ``resilience``
FAULT_INJECT_ACTIVE = False


def _sync_fault_inject_gate(value):
    global FAULT_INJECT_ACTIVE
    FAULT_INJECT_ACTIVE = bool(str(value).strip())


watch_flag("FLAGS_fault_inject", _sync_fault_inject_gate)

# ---- context parallelism and the distributed tooling (:156-173, :427,
# :447-449, :662). The reference's alias FLAGS_pg_timeout needs an alias
# table, which this registry does not have: use FLAGS_comm_task_timeout_s.
define_flag("FLAGS_comm_task_timeout_s", 1800.0,
            "CommTaskManager watchdog timeout per collective (the "
            "reference's FLAGS_pg_timeout role).")
define_flag("FLAGS_comm_idle_poll_limit", 10,
            "CommContext: consecutive 60s zero-progress polls before a "
            "transfer is declared dead (its gloo group's timeout is this "
            "many minutes).")
define_flag("FLAGS_launch_max_restarts", 0,
            "Launcher: restarts-with-rerank before giving up "
            "(elastic manager behavior).")
define_flag("FLAGS_recompute_segments", 2,
            "Default segment count for the recompute program pass.")
define_flag("FLAGS_pg_native_transport", True,
            "Allow CommContext's transport (a gloo group); false makes "
            "CommContext.create_negotiated return None on every rank.")
define_flag("FLAGS_watchdog_check_interval_s", 1.0,
            "CommTaskManager watchdog poll interval in seconds.")
define_flag("FLAGS_auto_tuner_max_trials", 0,
            "Auto-tuner default measured-trial count (0 = cost-model "
            "ranking only).")
define_flag("FLAGS_launch_log_dir", "log",
            "Default --log_dir for paddle.distributed.launch.")

# ---- the measurement plane (the reference's flags.py:123-138, :187, :277,
# :465-628): the NaN/Inf scan, the profiler and the observability planes
define_flag("FLAGS_check_nan_inf", False,
            "Scan op outputs for NaN/Inf after each eager op (debug).")

# Watcher-kept gate: dispatch.apply reads it (with the profiler's per-op
# hook) to take each op out of the fusion window while the scan is armed.
NAN_CHECK_ACTIVE = False


def _sync_nan_check_gate(value):
    global NAN_CHECK_ACTIVE
    NAN_CHECK_ACTIVE = bool(value)


watch_flag("FLAGS_check_nan_inf", _sync_nan_check_gate)
define_flag("FLAGS_check_nan_inf_level", 0,
            "NaN/Inf scan action: 0 raise, 1 warn and continue.")
define_flag("FLAGS_profiler_dir", "",
            "Directory for chrome-trace exports ('' = cwd).")
define_flag("FLAGS_host_tracer_level", 1,
            "Host tracer detail: 0 off, 1 ops, 2 ops+python ranges.")
define_flag("FLAGS_profiler_max_events", 1_000_000,
            "Host tracer event-buffer cap (oldest dropped beyond it).")
define_flag("FLAGS_profiler_fused_runtime", False,
            "Profiler keeps the fusion window ON while recording: no "
            "per-op host events (op::*), the trace instead carries the "
            "fused-runtime spans (segment flush/compile/execute, fused "
            "step, optimizer) the steady-state hot path actually runs.")

define_flag("FLAGS_distributed_telemetry", False,
            "Cross-rank telemetry plane: each rank periodically "
            "publishes a compact frame (metrics/span-histogram deltas, "
            "step index, mesh epoch, recent span events) through the "
            "TCPStore under __telem/ keys, and rank 0 merges them into "
            "a cluster step table (per-rank skew, straggler flags), a "
            "comm-overlap report, and a merged per-rank chrome trace. "
            "Off = one module-level check per step, zero registry and "
            "zero store work.")
define_flag("FLAGS_distributed_telemetry_interval", 1,
            "Telemetry plane: steps between frame publications (1 = "
            "every step boundary).")
define_flag("FLAGS_distributed_telemetry_events", 4096,
            "Telemetry plane: span events buffered per rank between "
            "frame publications (oldest dropped beyond it).")
define_flag("FLAGS_telemetry_straggler_factor", 1.25,
            "Step-table straggler flag: a rank is flagged when its "
            "per-step time exceeds the step's cross-rank median by "
            "this factor (and by FLAGS_telemetry_straggler_min_us).")
define_flag("FLAGS_telemetry_straggler_min_us", 1000.0,
            "Step-table straggler flag: minimum absolute skew "
            "(slowest minus median, us) before a rank is flagged — "
            "filters factor-trips on micro-second steps.")
define_flag("FLAGS_telemetry_postmortem_grace_s", 3.0,
            "Distributed flight postmortem: how long rank 0 polls the "
            "store for survivor rings before writing the aggregated "
            "report with whatever arrived.")
define_flag("FLAGS_observability", False,
            "Collect runtime metrics (counters/gauges/histograms) at "
            "the fused-runtime instrumentation points; off = the hot "
            "paths pay one module-level check and zero registry work.")
define_flag("FLAGS_memory_telemetry", False,
            "Byte-domain telemetry plane (observability/memory.py): "
            "live-buffer census with birth-site provenance at the "
            "Tensor-creation and lazy bind choke points, per-runner "
            "argument/output/temp bytes cached on the runner-cache entry, "
            "donation savings accounting, and OOM postmortems at the "
            "execute sites. Off = one module-level check per choke "
            "point, zero census and zero registry work.")
define_flag("FLAGS_compute_telemetry", False,
            "Compute-efficiency telemetry plane (observability/"
            "compute.py): each runner's FLOPs (torch's FlopCounterMode "
            "over its first execution, with the port's formulas for its "
            "attention ops) and bytes, counted once per runner build and "
            "cached on the runner-cache entry, per-execution FLOP counters "
            "(compute.flops.{segment,fused_step,optimizer}), MFU/roofline "
            "columns in the budget tool, and source-attributed device "
            "profiles (each recorded op runs under a record_function "
            "carrying its file:line). Off = one module-level check per "
            "site, zero registry and zero counting work.")
define_flag("FLAGS_device_peak_flops", 0.0,
            "Per-device peak FLOP/s the MFU column divides by. 0 = "
            "autodetect: a CUDA card from its name (published dense bf16 "
            "peaks: H100 SXM 989T, H100 PCIe 756T, A100 312T), the CPU "
            "from a nominal cores x 2.5 GHz x 16 fp32-FLOPs/cycle "
            "AVX2-FMA envelope (CPU MFU is a relative meter, not an "
            "absolute one).")
define_flag("FLAGS_device_peak_membw", 0.0,
            "Per-device peak memory bandwidth in bytes/s for the "
            "roofline ridge point (peak_flops / peak_membw). 0 = "
            "autodetect: a CUDA card from its name (H100 SXM 3.35TB/s, "
            "H100 PCIe 2TB/s, A100 1.555-2.039TB/s), the CPU from a "
            "nominal 25.6 GB/s two-channel DDR4 envelope.")
define_flag("FLAGS_memory_budget_bytes", 0,
            "Per-device memory budget in bytes for the cross-rank memory "
            "column: budget --distributed flags the rank whose peak is "
            "nearest this budget (0 = unknown; the highest absolute "
            "peak is flagged instead).")
define_flag("FLAGS_goodput", False,
            "Goodput plane (observability/goodput.py): per-process "
            "wall-clock attribution ledger partitioning the job "
            "timeline into exclusive states (productive execute, "
            "compile, input wait, comm wait, host gap, checkpoint "
            "I/O, recovery, idle) with bucket additivity asserted, a "
            "bounded step-time ring feeding anomaly detection, and a "
            "hang watchdog that captures stacks + dumps the flight "
            "ring when no step progress happens within "
            "FLAGS_goodput_hang_factor x the median step time. Off = "
            "one module-level check per probe, zero ring mutations.")
define_flag("FLAGS_goodput_hang_factor", 8.0,
            "Goodput hang watchdog: the job is declared hung when no "
            "probe-visible progress happens within this factor x the "
            "rolling median step time (floored by "
            "FLAGS_goodput_hang_min_s).")
define_flag("FLAGS_goodput_hang_min_s", 1.0,
            "Goodput hang watchdog: floor on the dynamic timeout so "
            "micro-second steps cannot arm a hair-trigger deadline "
            "over a legitimate recompile.")
define_flag("FLAGS_goodput_hang_poll_s", 0.25,
            "Goodput hang watchdog: watchdog-thread poll interval in "
            "seconds (bounds detection latency beyond the timeout).")
define_flag("FLAGS_goodput_spike_factor", 3.0,
            "Goodput anomaly detection: a step slower than this "
            "factor x the rolling median counts "
            "goodput.anomalies.step_spike (same factor watches loss "
            "divergence via note_loss).")
define_flag("FLAGS_goodput_ring", 128,
            "Goodput step-time ring capacity (rolling median window "
            "for the spike and hang thresholds).")
define_flag("FLAGS_flight_max_dumps", 32,
            "Flight-recorder dump retention: per-rank cap on "
            "flight_*.txt files kept in FLAGS_flight_recorder_dir "
            "(oldest pruned first after each dump; rank-aware so one "
            "rank's churn cannot evict another rank's postmortem; "
            "0 = unlimited).")
define_flag("FLAGS_flight_recorder", False,
            "Keep a bounded ring buffer of recent runtime events "
            "(spans, flushes, cache decisions) and dump a readable "
            "report on enforce errors, failed flushes, and sanitizer "
            "error-mode trips.")
define_flag("FLAGS_flight_recorder_capacity", 512,
            "Flight-recorder ring size (events kept).")
define_flag("FLAGS_flight_recorder_dir", "",
            "Directory for flight-record dumps ('' = FLAGS_profiler_dir "
            "or cwd).")
define_flag("FLAGS_monitor", False,
            "Live monitoring plane (observability/timeseries.py): a "
            "daemon sampler records counter rates (steps/s, tokens/s, "
            "compiles, cache hit rate), byte/census gauges, goodput "
            "fractions and per-step MFU into bounded per-series rings "
            "every FLAGS_monitor_interval_s, feeding the /metrics "
            "exporter and the online regression watchdog. Off = one "
            "module-level check per step hook, zero registry work, no "
            "sampler thread, no bound port.")
define_flag("FLAGS_monitor_interval_s", 1.0,
            "Monitor sampler period in seconds (each tick appends one "
            "timestamped sample per series).")
define_flag("FLAGS_monitor_port", 0,
            "Monitor HTTP exporter port serving /metrics (Prometheus "
            "text exposition), /healthz, /snapshot and "
            "/timeseries?name=. 0 = no HTTP endpoint (sampler rings "
            "still record for in-process readers).")
define_flag("FLAGS_monitor_host", "127.0.0.1",
            "Monitor exporter bind address. Loopback by default — "
            "bind a routable interface explicitly to let an external "
            "Prometheus scrape the job.")
define_flag("FLAGS_monitor_ring", 512,
            "Monitor per-series ring capacity (samples kept per "
            "series; at the default 1 s interval ~8.5 min of trend).")
define_flag("FLAGS_monitor_regression_factor", 1.5,
            "Online regression watchdog: a headline series (step "
            "duration, tokens/s, goodput fraction) deviating past "
            "this factor from its EWMA baseline, sustained for "
            "FLAGS_monitor_regression_steps consecutive samples, "
            "counts monitor.regressions and leaves a flight note "
            "with baseline-vs-current evidence.")
define_flag("FLAGS_monitor_regression_steps", 5,
            "Consecutive deviating samples required before the "
            "regression watchdog fires (debounce against one-off "
            "recompiles or input stalls).")
define_flag("FLAGS_monitor_deep_capture_steps", 0,
            "When > 0, a fired regression arms a one-shot deep "
            "capture: the profiler (fused_runtime) traces the next K "
            "steps and the trace is dumped beside the flight ring "
            "(subject to the same rank-aware retention).")
