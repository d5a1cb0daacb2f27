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
``distributed/checkpoint.py``), with the reference's names and defaults
except one:
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
            "named injection point (ckpt::save, ckpt::load; trailing * "
            "wildcards match) and kind is fail | die | delay(s) | "
            "stuck(s) | oom. See distributed/resilience/faults.py.")
define_flag("FLAGS_retry_max_attempts", 3,
            "RetryPolicy default attempt budget for transient failures "
            "(checkpoint I/O).")
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
