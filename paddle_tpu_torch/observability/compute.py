"""Compute-efficiency telemetry plane: FLOPs accounting, MFU, roofline (the
counterpart of ``paddle_tpu/observability/compute.py``).

Four pillars, as in the reference:

- **per-runner cost**: the reference reads XLA's ``cost_analysis()`` once
  per compile. The port has no compiler to ask; it counts each runner once
  per build, on the runner's first execution (the segment runner, the
  fused forward+backward), under ``torch.utils.flop_counter.FlopCounterMode``
  and a byte counter: no extra run. ``COST_CALLS`` counts these; the
  result sits on the runner-cache entry (``ExecCache.note_cost``) and is
  pruned with it.

  ``FlopCounterMode`` counts matrix products, convolutions and the ops
  that have a formula. The port registers one for each of its attention
  ops (``paddle_tpu_torch::flash_*``, ``varlen_*``, ``flashmask_*``),
  counting model FLOPs as ``bench.py`` and the MFU of ``PERF.md`` do: the
  forward 4·BH·Sq·Sk·D, the dK/dV kernel 4·BH·Sq·Sk·D and the dQ kernel
  4·BH·Sq·Sk·D, the dense products whether causal or not and no
  recompute; the varlen forms count each segment's own Sq_i·Sk_i, the
  flashmask forms the dense Sq·Sk. That is not torch's own SDPA formula,
  which also counts the backward's recompute of the scores (14·BH·S²·D a
  step against these 12). XLA's count also takes in elementwise FLOPs;
  this one does not, so it is at most the reference's.

  ``bytes_accessed`` is the port's own count: every op's input and output
  tensor bytes as the op runs, each op on its own. XLA's figure counts the
  fused program's memory traffic instead, so the two differ wherever XLA
  fuses.
- **per-execution FLOP counters**: each execution of a counted runner adds
  its FLOPs to ``compute.flops.{segment,fused_step}`` (and
  ``compute.bytes_accessed``).
- **MFU / roofline**: ``peak_flops()`` resolves ``FLAGS_device_peak_flops``
  (0 = autodetect: a card from ``torch.cuda.get_device_name()`` against a
  table of published dense bf16 peaks, else the reference's CPU envelope).
- **source-attributed device profiles**: while the plane is on, a runner
  built under it runs each recorded op inside
  ``torch.profiler.record_function("<op>[<file>:<line>]")`` from the op's
  record-time call site; the profiler's trace reader maps each device
  kernel to its enclosing scope through the launch's CPU-side parent
  (``note_source``), and ``source_of`` answers by kernel name.

Off-cost: ``FLAGS_compute_telemetry`` is watcher-cached into
``_state.COMPUTE``; off = one module-attribute read per site, zero registry
and zero counting work.
"""
from __future__ import annotations

import os
import re
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from . import _state

_LOCK = threading.Lock()

# runner cost counts (one per runner build)
COST_CALLS = 0

FLOPS_EXECUTED = 0
BYTES_ACCESSED = 0
_SITE_FLOPS: Dict[str, int] = {}

_EXECS: "OrderedDict" = OrderedDict()
_EXEC_CAP = 512
_EXEC_SEQ = 0

# device kernel name -> "op@file:line" (note_source); bounded drop-oldest
_KERNEL_SRC: "OrderedDict[str, str]" = OrderedDict()
_KERNEL_SRC_CAP = 16384

_RATE_T0 = None
_RATE_FLOPS = 0


# ------------------------------------------------------- attention formulas

def _dense_attention_flops(q, k, *args, out_val=None, **kw) -> int:
    """4·BH·Sq·Sk·D for ``[BH, S, D]`` operands (one attention kernel)."""
    bh, sq, d = q.shape
    return 4 * bh * sq * k.shape[1] * d


def _varlen_attention_flops(q, k, v, *rest, out_val=None, **kw) -> int:
    """4·H·D·Σ Sq_i·Sk_i over the segments of ``[T, H, D]`` packed
    operands: the segment ids (``seg_q``, ``seg_k``, pads negative) are
    read, as the count is of this run's data."""
    import torch
    tensors = [x for x in rest if isinstance(x, torch.Tensor)]
    if isinstance(rest[0], torch.Tensor) and rest[0].shape == v.shape:
        tensors = tensors[3:]           # a backward: do, lse, delta first
    seg_q, seg_k = tensors[0], tensors[2]
    sq = seg_q[seg_q >= 0].long()
    sk = seg_k[seg_k >= 0].long()
    if not sq.numel() or not sk.numel():
        return 0
    n = int(max(int(sq.max()), int(sk.max()))) + 1
    pairs = int((torch.bincount(sq, minlength=n)
                 * torch.bincount(sk, minlength=n)).sum())
    _, h, d = q.shape
    return 4 * h * d * pairs


_FORMULAS_DONE = False


def _ensure_formulas():
    """Register the attention ops' formulas with the flop counter (once,
    at the first count: the ops exist once their modules are imported)."""
    global _FORMULAS_DONE
    if _FORMULAS_DONE:
        return
    import torch
    from torch.utils.flop_counter import register_flop_formula
    from ..ops.cuda import library
    library.ops()
    ns = getattr(torch.ops, library.NAMESPACE)
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                 "flashmask_fwd", "flashmask_bwd_dkv", "flashmask_bwd_dq"):
        register_flop_formula(getattr(ns, name),
                              get_raw=True)(_dense_attention_flops)
    for name in ("varlen_fwd", "varlen_bwd_dkv", "varlen_bwd_dq"):
        register_flop_formula(getattr(ns, name),
                              get_raw=True)(_varlen_attention_flops)
    _FORMULAS_DONE = True


def _byte_counter_mode():
    """A dispatch mode summing each op's input and output tensor bytes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class _ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in tree_flatten((args, kwargs, out))[0]:
                if isinstance(x, torch.Tensor):
                    self.nbytes += x.numel() * x.element_size()
            return out

    return _ByteCounter()


def analyze(run, n_devices: int = 1):
    """Run ``run()`` once (a runner's first execution) under the flop and
    byte counters; returns ``(result, info)``. Counted: one call per runner
    build."""
    global COST_CALLS
    from torch.utils.flop_counter import FlopCounterMode
    _ensure_formulas()
    with _LOCK:
        COST_CALLS += 1
    if _state.METRICS:
        from . import metrics
        metrics.inc("compute.cost_analysis_calls")
    fc = FlopCounterMode(display=False)
    bc = _byte_counter_mode()
    with fc, bc:
        out = run()
    info = {"flops": int(fc.get_total_flops()),
            "bytes_accessed": int(bc.nbytes),
            "transcendentals": 0, "n_devices": int(n_devices)}
    return out, info


def exec_seq() -> int:
    return _EXEC_SEQ


def note_executable(stat: str, key, info: Dict):
    """Record one runner's count under its cache identity (bounded)."""
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


def note_execution(info: Optional[Dict], site: str):
    """One execution of a counted runner: add its FLOPs and bytes to the
    totals (and the ``compute.flops.<site>`` counters when metrics are
    on). Callers gate on ``_state.COMPUTE``; an uncounted runner (built
    before the plane was on) is a no-op."""
    if not info or "error" in info:
        return
    flops = info.get("flops", 0)
    nbytes = info.get("bytes_accessed", 0)
    global FLOPS_EXECUTED, BYTES_ACCESSED
    with _LOCK:
        FLOPS_EXECUTED += flops
        BYTES_ACCESSED += nbytes
        _SITE_FLOPS[site] = _SITE_FLOPS.get(site, 0) + flops
    if _state.METRICS:
        from . import metrics
        if flops:
            metrics.inc("compute.flops." + site, flops)
        if nbytes:
            metrics.inc("compute.bytes_accessed", nbytes)
    if _state.TRACE and flops:
        _emit_rate(flops)


def count_cached(cache, key, site: str):
    """Price one execution of a cached runner from its entry's count."""
    note_execution(cache.cost_info(key), site)


def _emit_rate(flops: int):
    """Achieved-GFLOP/s counter track while a profiler records (host
    rate over at least 1 ms)."""
    global _RATE_T0, _RATE_FLOPS
    now = time.perf_counter()
    with _LOCK:
        if _RATE_T0 is None:
            _RATE_T0, _RATE_FLOPS = now, flops
            return
        _RATE_FLOPS += flops
        dt = now - _RATE_T0
        if dt < 1e-3:
            return
        gflops = _RATE_FLOPS / dt / 1e9
        _RATE_T0, _RATE_FLOPS = now, 0
    from ..profiler import _add_counter_event
    _add_counter_event("compute.achieved_gflops", gflops, key="gflops")


def executed_flops() -> int:
    return FLOPS_EXECUTED


def executed_bytes() -> int:
    return BYTES_ACCESSED


def site_flops() -> Dict[str, int]:
    with _LOCK:
        return dict(_SITE_FLOPS)


def executable_stats() -> List[Dict]:
    with _LOCK:
        return [{"cache": k[0], **info} for k, info in _EXECS.items()]


def reset():
    """Zero every total and drop the logs."""
    global COST_CALLS, FLOPS_EXECUTED, BYTES_ACCESSED
    global _RATE_T0, _RATE_FLOPS
    with _LOCK:
        COST_CALLS = 0
        FLOPS_EXECUTED = BYTES_ACCESSED = 0
        _SITE_FLOPS.clear()
        _EXECS.clear()
        _KERNEL_SRC.clear()
        _RATE_T0, _RATE_FLOPS = None, 0


# --------------------------------------------------------- peak / roofline

# published dense bf16 peaks (FLOP/s, bytes/s) by a substring of the
# device's name, newest first. Each name is a whole card: the SXM H100
# calls itself "H100 80GB HBM3", the PCIe and NVL cards say so. A card
# that is not here raises rather than being priced as another one.
_CUDA_PEAKS = (
    ("h100 80gb hbm3", 989e12, 3.35e12),
    ("h100 sxm", 989e12, 3.35e12),
    ("h100 nvl", 835e12, 3.9e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("a100-sxm4-80gb", 312e12, 2.039e12),
    ("a100 80gb pcie", 312e12, 1.935e12),
    ("a100-sxm4-40gb", 312e12, 1.555e12),
    ("a100-pcie-40gb", 312e12, 1.555e12),
)

# the reference's CPU fallbacks: a nominal AVX2-FMA envelope per core and
# two-channel DDR4 bandwidth (a relative meter on one box, not absolute)
_CPU_GHZ = 2.5e9
_CPU_FLOPS_PER_CYCLE = 16          # 8 fp32 lanes x FMA
_CPU_MEMBW = 25.6e9


def _cuda_peak(name: str, which: int) -> float:
    """The table's peak (``which`` 1: FLOP/s, 2: bytes/s) of the CUDA
    device ``name``; a device the table lacks raises ``ValueError``
    naming the flag that sets it."""
    kind = name.lower()
    for row in _CUDA_PEAKS:
        if row[0] in kind:
            return row[which]
    flag = ("FLAGS_device_peak_flops" if which == 1
            else "FLAGS_device_peak_membw")
    raise ValueError(f"no published peak for the CUDA device {name!r}: "
                     f"set {flag}")


def _device_name() -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def peak_flops() -> float:
    """Per-device peak FLOP/s: ``FLAGS_device_peak_flops``, or the
    autodetect when the flag is 0 (the CPU's envelope without a card; a
    card missing from the table raises ``ValueError``)."""
    from .._core.flags import flag_value
    v = float(flag_value("FLAGS_device_peak_flops"))
    if v > 0:
        return v
    name = _device_name()
    if name is None:
        return (os.cpu_count() or 1) * _CPU_GHZ * _CPU_FLOPS_PER_CYCLE
    return _cuda_peak(name, 1)


def peak_membw() -> float:
    """Per-device peak memory bandwidth (bytes/s) for the roofline ridge:
    ``FLAGS_device_peak_membw``, or the autodetect (as ``peak_flops``)."""
    from .._core.flags import flag_value
    v = float(flag_value("FLAGS_device_peak_membw"))
    if v > 0:
        return v
    name = _device_name()
    if name is None:
        return _CPU_MEMBW
    return _cuda_peak(name, 2)


def mfu(achieved_flops_per_s: float,
        peak: Optional[float] = None) -> float:
    """Model-FLOPs-utilization: achieved / per-device peak."""
    peak = peak_flops() if peak is None else float(peak)
    if peak <= 0:
        return 0.0
    return achieved_flops_per_s / peak


def roofline(flops: int, bytes_accessed: int,
             peak: Optional[float] = None,
             membw: Optional[float] = None) -> Dict:
    """Arithmetic intensity (FLOP per byte accessed) against the ridge
    point peak_flops/peak_membw."""
    peak = peak_flops() if peak is None else float(peak)
    membw = peak_membw() if membw is None else float(membw)
    intensity = flops / bytes_accessed if bytes_accessed else 0.0
    ridge = peak / membw if membw else 0.0
    bound = None
    if flops:
        bound = "compute-bound" if intensity >= ridge else "memory-bound"
    return {"arith_intensity": round(intensity, 3),
            "ridge_intensity": round(ridge, 3),
            "bound": bound}


def summary() -> Dict:
    """The FLOP-domain snapshot ``stats()`` and the frames carry."""
    return {
        "cost_analysis_calls": COST_CALLS,
        "flops_executed": FLOPS_EXECUTED,
        "bytes_accessed": BYTES_ACCESSED,
        "site_flops": site_flops(),
        "peak_flops": peak_flops(),
        "executables": executable_stats()[-8:],
        "provenance_entries": len(_KERNEL_SRC),
    }


# ------------------------------------------------- source attribution

# the scope a runner opens around one recorded op: <op>[<file>:<line>]
_SCOPE_RE = re.compile(r"^([\w.\-]+)\[([^\[\]]+:\d+)\]$")


def scope_name(op_name: str, src: Optional[str]) -> str:
    """The ``record_function`` name of one recorded op: ``<op>[<file>:
    <line>]`` (``<op>[?:0]`` when no call site was captured), rendered back
    as ``op@file:line`` by ``parse_scope``."""
    return f"{op_name}[{src or '?:0'}]"


def parse_scope(name: str) -> Optional[str]:
    """``op@file:line`` of a scope name ``scope_name`` made, or None."""
    m = _SCOPE_RE.match(name)
    if m is None:
        return None
    return f"{m.group(1)}@{m.group(2)}"


def note_source(kernel_name: str, src: str):
    """Map a device kernel's name to the ``op@file:line`` that launched it
    (the profiler's trace reader calls this for each attributed kernel)."""
    with _LOCK:
        _KERNEL_SRC[kernel_name] = src
        _KERNEL_SRC.move_to_end(kernel_name)
        while len(_KERNEL_SRC) > _KERNEL_SRC_CAP:
            _KERNEL_SRC.popitem(last=False)


def source_of(event_name: str) -> Optional[str]:
    """``op@file:line`` provenance for a device kernel's name (the last
    launch seen), or None."""
    return _KERNEL_SRC.get(event_name)


def provenance_size() -> int:
    return len(_KERNEL_SRC)
