"""The port's telemetry planes in one process, against the JAX package's
(``paddle_tpu_torch/observability``: ``compute``, ``memory``, ``goodput``,
``timeseries``, ``exporter``, ``distributed``'s codec and aggregator): the
counterpart of the single-process tests of ``tests/test_compute_telemetry.py``,
``test_memory_telemetry.py``, ``test_goodput.py``, ``test_monitor.py`` and
``test_distributed_telemetry.py``.

- Each plane's off-cost: with its flag off, a chain and a train step (the
  async flush on) do zero registry mutations and none of the plane's work
  (no count, no census entry, no ring append, no sampler, no port, no
  frame).
- Compute: one count per runner build, priced on every later execution,
  the count on the cache entry and pruned with it; the attention ops'
  formulas (4·BH·Sq·Sk·D for each kernel, each segment's own Sq_i·Sk_i for
  the varlen forms); a 2-layer GPT step's executed FLOPs equal to the
  analytic count T·(6(12·L·h² + v·h) + 12·L·s·h); MFU and the roofline give
  the reference's numbers; the ``<op>[<file>:<line>]`` scopes of a runner
  built under the plane reach a ``torch.profiler`` trace.
- Memory: the census's births with their sites, weakref hygiene, views
  counted once per storage, one note per runner build, the donation figure
  pinned at 0, the OOM drill (sync and async) typed with its postmortem,
  the prefetcher's ``io::h2d`` span and the flight dumps' retention.
- Goodput: additivity, the probes (``io::input_wait``, ``ckpt::save`` /
  ``load``), the recovery bucket against ``resilience.recovery_us``, the
  abort unwind, the spike / NaN / divergence watches, the hang drill, the
  off-thread spans, and the cross-rank goodput report.
- Monitor: the Prometheus text (and the reference's rendering of the same
  registry), ``/metrics``, ``/healthz`` (503 on a hang), ``/snapshot``,
  the rings, the EWMA watchdog and its flight evidence, ``top``.
- The pure functions hold the reference's results on the same inputs:
  ``mfu``, ``roofline``, the goodput partition (``bucket_of``,
  ``check_additivity``), ``sanitize``, the frame codec (a frame encoded by
  one package decodes in the other), the clock rebase, the overlap report
  and the step table.

Left out: ``test_per_chip_pricing_under_dryrun_mesh`` and
``test_static_flop_model_cross_validated_tp_layer`` (an ambient SPMD mesh:
``ROADMAP.md`` §1 item 9.1), ``test_static_diff_compute_flops_no_false_clean``,
``test_static_flop_model_cross_validated_lenet`` and ``test_op_flops_rule_table``
(the perf checker's static FLOP model, the analysis plane),
``test_named_scope_provenance_round_trip`` (XLA's HLO ``op_name``; its
counterpart here is the record_function scope test),
``test_bn_running_stats_update_in_window`` and
``test_gpt_step_reaches_fused_steady_state`` (``analysis.trace_step``),
``test_flash_attention_records_into_window`` (the window's record of the
port's attention is held by ``tests/test_torch_lazy_gpt.py``), and
``test_donation_accounting_and_census_stability``: the port donates no
buffer (torch frees by reference count, the optimizer writes in place), so
its figure is pinned at 0 instead. The cross-rank tests are
``tests/test_torch_telemetry_ranks.py``.

Tolerances: counts and partitions compare exactly; wall-clock figures
within the reference's own bounds.
"""
import contextlib
import gc
import glob
import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu.observability import compute as rcomptel
from paddle_tpu.observability import distributed as rdtel
from paddle_tpu.observability import exporter as rexporter
from paddle_tpu.observability import goodput as rgoodput
from paddle_tpu.observability import metrics as rmetrics
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch._core import async_flush, lazy
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import flags as pt_flags
from paddle_tpu_torch.base.core import ResourceExhaustedError
from paddle_tpu_torch.observability import _state
from paddle_tpu_torch.observability import compute as comptel
from paddle_tpu_torch.observability import distributed as dtel
from paddle_tpu_torch.observability import (exporter, flight, goodput,
                                            metrics, timeseries)
from paddle_tpu_torch.observability import memory as memtel


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@contextlib.contextmanager
def flag(name, value):
    old = pt_flags.flag_value(name)
    pt_flags.set_flags({name: value})
    try:
        yield
    finally:
        pt_flags.set_flags({name: old})


@contextlib.contextmanager
def flags(**kw):
    with contextlib.ExitStack() as st:
        for k, v in kw.items():
            st.enter_context(flag("FLAGS_" + k, v))
        yield


def _chain(x, n=8):
    with pt.framework.lazy_guard():
        y = x
        for _ in range(n):
            y = y * 1.0001 + 0.0001
    return y.numpy()


def _mlp_step_fn(batch=8, window=True):
    pt.seed(0)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    opt = pt.optimizer.Adam(1e-3, parameters=net.parameters())
    r = np.random.RandomState(0)
    x = pt.to_tensor(r.randn(batch, 8).astype("float32"))
    y = pt.to_tensor(r.randint(0, 4, (batch,)).astype("int64"))

    def step():
        with pt.framework.lazy_guard():
            loss = F.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        return float(loss)
    return step


def _mlp_flops(batch=8):
    """Matmul FLOPs of one MLP step: the forward's two products, the
    backward's weight gradients of both and the input gradient of the
    second (the batch needs none)."""
    l1, l2 = 2 * batch * 8 * 16, 2 * batch * 16 * 4
    return 3 * l1 - l1 + 3 * l2


def _lenet_step_fn(batch=8):
    from paddle_tpu_torch.vision.models import LeNet
    pt.seed(0)
    model = LeNet()
    opt = pt.optimizer.Adam(1e-3, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = pt.to_tensor(rng.randn(batch, 1, 28, 28).astype(np.float32))
    y = pt.to_tensor(rng.randint(0, 10, (batch,)).astype(np.int64))

    def step():
        with pt.framework.lazy_guard():
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        return float(loss)
    return step, model


# ================================================================ compute

@pytest.fixture
def compute_on():
    # from a clean plane: no count or cached runner another test left
    comptel.reset()
    lazy.clear_segment_cache()
    pt.set_flags({"FLAGS_compute_telemetry": True})
    try:
        yield
    finally:
        pt.set_flags({"FLAGS_compute_telemetry": False})
        comptel.reset()


def test_compute_telemetry_off_is_free():
    """Capped chain and a fused train step with the async flush on, plane
    off: zero registry mutations, zero counts, zero FLOPs."""
    step = _mlp_step_fn()
    x = pt.to_tensor(np.ones((16, 16), "float32"))
    step()
    _chain(x, 32)
    with flags(async_flush=True, lazy_max_segment_ops=16):
        before = metrics.MUTATIONS
        calls0, flops0 = comptel.COST_CALLS, comptel.executed_flops()
        for _ in range(3):
            _chain(x, 32)
            step()
        async_flush.drain()
        assert metrics.MUTATIONS == before
        assert comptel.COST_CALLS == calls0
        assert comptel.executed_flops() == flops0
    async_flush.drain(raise_latched=False)


def test_cost_counted_once_per_runner_build(compute_on):
    """Entering the plane re-keys the caches; the fused step's runner is
    counted once, at its first execution, and every later execution is
    priced from the count on its cache entry with no further count. The
    port's optimizer update is no runner: its FLOPs (none a matmul) are
    not counted."""
    step = _mlp_step_fn()
    step()
    calls = comptel.COST_CALLS
    assert calls == 1
    sites0 = comptel.site_flops()
    assert sites0.get("fused_step") == _mlp_flops()
    flops0 = comptel.executed_flops()
    for _ in range(3):
        step()
    assert comptel.COST_CALLS == calls
    assert (comptel.executed_flops() - flops0) / 3 == _mlp_flops()
    infos = [lazy._FUSED_CACHE.cost_info(k) for k in list(lazy._FUSED_CACHE)]
    assert any(i and i["flops"] == _mlp_flops() for i in infos), infos
    assert all(i["bytes_accessed"] > 0 for i in infos if i)


def test_entering_the_plane_rekeys_only_stale_runners():
    lazy.clear_segment_cache()
    step = _mlp_step_fn()
    step()                                   # a runner built uncounted
    assert lazy.COST_STALE
    epoch = lazy.MESH_EPOCH
    with flag("FLAGS_compute_telemetry", True):
        assert lazy.MESH_EPOCH == epoch + 1 and not lazy.COST_STALE
        step()
    with flag("FLAGS_compute_telemetry", True):
        assert lazy.MESH_EPOCH == epoch + 1   # nothing stale: no re-key
    comptel.reset()


def test_cost_info_pruned_with_entry():
    from paddle_tpu_torch._core.cache import ExecCache
    c = ExecCache()
    with flag("FLAGS_executable_cache_capacity", 2):
        c["a"] = 1
        c.note_cost("a", {"flops": 10})
        c.note_memory("a", {"temp_bytes": 1})
        c["b"] = 2
        c.note_cost("b", {"flops": 20})
        c["c"] = 3
        assert "a" not in c
        assert c.cost_info("a") is None and c.memory_info("a") is None
        assert c.cost_info("b")["flops"] == 20
    c.clear()
    assert c.cost_info("b") is None


def _attention(name, *args):
    from torch.utils.flop_counter import FlopCounterMode
    from paddle_tpu_torch.ops.cuda import library
    comptel._ensure_formulas()
    op = getattr(getattr(torch.ops, library.NAMESPACE), name)
    with FlopCounterMode(display=False) as fc:
        op(*args)
    return fc.get_total_flops()


def test_attention_flop_formulas():
    """#1-#3: 4·BH·Sq·Sk·D each, causal or not; the varlen forms count each
    segment's own Sq_i·Sk_i; the flashmask forms the dense product."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    bh, s, d = 4, 64, 16
    q = torch.randn(bh, s, d)
    dense = 4 * bh * s * s * d
    for causal in (True, False):
        assert _attention("flash_fwd", q, q, q, causal, 0.25, s, 0) == dense
    out, lse = fa.flash_fwd_op(q, q, q, True, 0.25, s, 0)
    delta = fa.attention_delta(out, out)
    assert _attention("flash_bwd_dkv", q, q, q, out, lse, delta, True,
                      0.25, s, 0) == dense
    assert _attention("flash_bwd_dq", q, q, q, out, lse, delta, True, 0.25,
                      s, 0) == dense
    lens = [5, 27, 32]
    h, t = 2, sum(lens)
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32)
    plan = fv.varlen_plan(cu, cu, t, t, True)
    qv = torch.randn(t, h, d)
    got = _attention("varlen_fwd", qv, qv, qv, plan.seg_q, plan.pos_q,
                     plan.seg_k, plan.pos_k, plan.qlo, plan.qhi, plan.klo,
                     plan.khi, True, 0.25)
    assert got == 4 * h * d * sum(n * n for n in lens)


def _gpt_cfg():
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                     num_heads=2, max_position_embeddings=64,
                     dtype="float32")


def test_gpt_step_flops_equal_the_analytic_count(compute_on):
    """A 2-layer GPT's fused step: executed FLOPs equal
    T·(6(12·L·h² + v·h) + 12·L·s·h), the count ``bench.py`` and the MFU of
    ``PERF.md`` use (no position table, no recompute)."""
    from paddle_tpu_torch.models.gpt import (GPTForPretraining,
                                             GPTPretrainingCriterion)
    cfg = _gpt_cfg()
    pt.seed(0)
    model = GPTForPretraining(cfg)
    crit = GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    b, s = 2, 64
    r = np.random.RandomState(0)
    x = pt.to_tensor(r.randint(0, 256, (b, s)).astype("int64"))
    y = pt.to_tensor(r.randint(0, 256, (b, s)).astype("int64"))

    def step():
        with pt.framework.lazy_guard():
            loss = crit(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        return float(loss)

    step()
    f0 = comptel.executed_flops()
    step()
    h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    want = b * s * (6 * (12 * L * h * h + v * h) + 12 * L * s * h)
    assert comptel.executed_flops() - f0 == want


def test_mfu_and_roofline_match_the_reference():
    from conftest import with_flag
    with flag("FLAGS_device_peak_flops", 1e12), \
            with_flag("FLAGS_device_peak_flops", 1e12):
        assert comptel.peak_flops() == 1e12
        assert comptel.mfu(5e11) == 0.5 == rcomptel.mfu(5e11)
        assert comptel.mfu(0.0) == 0.0
        with flag("FLAGS_device_peak_membw", 1e11), \
                with_flag("FLAGS_device_peak_membw", 1e11):
            for fl, by in ((1000, 50), (100, 50), (0, 0), (7, 3)):
                assert comptel.roofline(fl, by) == rcomptel.roofline(fl, by)
            r = comptel.roofline(flops=1000, bytes_accessed=50)
            assert r == {"arith_intensity": 20.0, "ridge_intensity": 10.0,
                         "bound": "compute-bound"}
    assert comptel.roofline(0, 0)["bound"] is None
    assert comptel.peak_flops() > 0 and comptel.peak_membw() > 0
    # the CPU fallback is the reference's envelope
    assert comptel.peak_flops() == (os.cpu_count() or 1) * 2.5e9 * 16
    assert comptel.peak_membw() == 25.6e9


def test_cuda_peak_table(monkeypatch):
    """Each card by its own name; a card the table lacks raises, naming
    the flag, instead of being priced as the CPU or as another card."""
    assert comptel._cuda_peak("NVIDIA H100 80GB HBM3", 1) == 989e12
    assert comptel._cuda_peak("NVIDIA H100 PCIe", 1) == 756e12
    assert comptel._cuda_peak("NVIDIA H100 NVL", 1) == 835e12
    assert comptel._cuda_peak("NVIDIA H100 80GB HBM3", 2) == 3.35e12
    assert comptel._cuda_peak("NVIDIA A100-SXM4-80GB", 1) == 312e12
    monkeypatch.setattr(comptel, "_device_name", lambda: "NVIDIA L40S")
    with pytest.raises(ValueError, match="FLAGS_device_peak_flops"):
        comptel.peak_flops()
    with pytest.raises(ValueError, match="FLAGS_device_peak_membw"):
        comptel.peak_membw()
    with flag("FLAGS_device_peak_flops", 3.6e14):
        assert comptel.peak_flops() == 3.6e14


def test_budget_gains_compute_columns():
    from paddle_tpu_torch.observability import budget
    out = budget.collect(_mlp_step_fn(batch=4096), steps=4)
    comp = out["compute"]
    assert comp["flops_per_step"] == _mlp_flops(4096)
    assert 0 < comp["mfu"] < 1 and comp["gflops_per_s"] > 0
    assert comp["arith_intensity"] > 0
    assert comp["bound"] in ("compute-bound", "memory-bound")
    assert comp["cost_analysis_calls_measured"] == 0
    text = budget.render(out)
    assert "MFU" in text and "GFLOP/s" in text and "ridge" in text
    comptel.reset()


def test_op_scopes_of_a_runner_reach_the_profiler(compute_on):
    """A runner built under the plane runs each op in an
    ``<op>[<file>:<line>]`` scope from its record-time call site (this
    file), which ``torch.profiler`` records."""
    from torch.profiler import ProfilerActivity, profile
    x = pt.to_tensor(np.ones((8, 16), "float32"))
    w = pt.to_tensor(np.ones((16, 4), "float32"))

    def run():
        with pt.framework.lazy_guard():
            y = pt.matmul(x, w) + 1.0
        return y.numpy()

    run()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        run()
    names = {e.name for e in p.events()}
    mine = [n for n in names if comptel.parse_scope(n)
            and "test_torch_telemetry.py" in n]
    assert any(n.startswith("matmul[") for n in mine), sorted(names)[:20]
    assert comptel.parse_scope("matmul[/a/b.py:3]") == "matmul@/a/b.py:3"


def test_frame_carries_compute_section(compute_on):
    class _Store:
        def set(self, k, v):
            pass

    step = _mlp_step_fn()
    step()
    pub = dtel.TelemetryPublisher(_Store(), rank=0, world_size=1)
    try:
        pub.on_step(1)
        step()
        pub.on_step(2)
        comp = pub.frames[-1]["compute"]
        assert comp["peak"] > 0 and comp["flops"] == _mlp_flops()
        assert "mfu" in comp and "gflops" in comp
    finally:
        pub.shutdown()


# ================================================================ memory

@pytest.fixture
def mem_on():
    pt.set_flags({"FLAGS_memory_telemetry": True})
    try:
        yield
    finally:
        pt.set_flags({"FLAGS_memory_telemetry": False})
        memtel.reset()


def test_memory_telemetry_off_is_free():
    step, _ = _lenet_step_fn()
    step()
    memtel.reset()
    with flag("FLAGS_async_flush", True):
        before = metrics.MUTATIONS
        calls0 = memtel.ANALYSIS_CALLS
        for _ in range(3):
            step()
        async_flush.drain()
        assert metrics.MUTATIONS == before
        assert memtel.census_size() == 0
        assert memtel.ANALYSIS_CALLS == calls0
    async_flush.drain(raise_latched=False)


def test_census_tracks_births_with_provenance(mem_on):
    x = pt.to_tensor(np.ones((32, 32), "float32"))
    with pt.framework.lazy_guard():
        y = x
        for _ in range(4):
            y = y * 1.0001 + 0.0001
    z = x * 3.0                                   # an eager op
    y.numpy()
    sites = [r["site"] for r in memtel.census()]
    assert "tensor.create" in sites
    assert any(s.startswith("seg@") and "#" in s for s in sites), sites
    assert any(s.startswith("eager:") for s in sites), sites
    assert memtel.live_bytes() == sum(r["nbytes"]
                                      for r in memtel.census())
    assert memtel.peak_bytes() >= memtel.live_bytes()
    assert z is not None


def test_census_weakref_hygiene(mem_on):
    x = pt.to_tensor(np.ones((64, 64), "float32"))
    with pt.framework.lazy_guard():
        y = x * 2.0
    y.numpy()
    live0, n0 = memtel.live_bytes(), memtel.census_size()
    del y
    gc.collect()
    assert memtel.census_size() == n0 - 1
    assert memtel.live_bytes() == live0 - 64 * 64 * 4
    assert x is not None


def test_no_tensor_kept_alive_by_telemetry(mem_on):
    import weakref
    t = pt.to_tensor(np.ones((16, 16), "float32"))
    wt, wp = weakref.ref(t), weakref.ref(t._payload)
    del t
    gc.collect()
    assert wt() is None and wp() is None


def test_views_are_counted_once_per_storage(mem_on):
    base = torch.ones(64, 64)
    a = pt.Tensor(base)
    n0, live0 = memtel.census_size(), memtel.live_bytes()
    b = pt.Tensor(base[:8])                      # a view: same storage
    assert (memtel.census_size(), memtel.live_bytes()) == (n0, live0)
    del a
    gc.collect()
    assert memtel.live_bytes() == live0           # the view keeps it
    del b, base
    gc.collect()
    assert memtel.live_bytes() == live0 - 64 * 64 * 4


def test_donation_is_pinned_at_zero(mem_on):
    """The port donates no buffer (torch frees a dead input by its
    reference count; the optimizer writes in place), so the reference's
    donation accounting has nothing to count."""
    step, _ = _lenet_step_fn()
    step()
    n0 = memtel.census_size()
    for _ in range(3):
        step()
        gc.collect()
    assert memtel.donated_bytes() == 0
    assert memtel.census_size() <= n0 + 2


def test_memory_note_once_per_runner_build(mem_on):
    x = pt.to_tensor(np.ones((17, 23), "float32"))
    calls0 = memtel.ANALYSIS_CALLS
    _chain(x, 6)
    after = memtel.ANALYSIS_CALLS
    assert after == calls0 + 1
    for _ in range(3):
        _chain(x, 6)
    assert memtel.ANALYSIS_CALLS == after
    infos = [lazy._SEG_CACHE.memory_info(k) for k in list(lazy._SEG_CACHE)]
    infos = [i for i in infos if i is not None]
    assert any(i["argument_bytes"] == 17 * 23 * 4 and
               i["output_bytes"] == 17 * 23 * 4 for i in infos), infos


def test_fused_step_noted(mem_on):
    step, _ = _lenet_step_fn(batch=9)
    calls0 = memtel.ANALYSIS_CALLS
    step()
    assert "fused_step" in {e["cache"] for e in memtel.executable_stats()}
    after = memtel.ANALYSIS_CALLS
    assert after == calls0 + 1
    step()
    assert memtel.ANALYSIS_CALLS == after


def test_oom_drill_sync_postmortem(mem_on, tmp_path):
    planted = pt.to_tensor(np.zeros((512, 512), "float32"))  # 1 MiB
    x = pt.to_tensor(np.ones((8, 8), "float32"))
    with flags(flight_recorder=True, flight_recorder_dir=str(tmp_path),
               fault_inject="exec::oom=oom"):
        with pytest.raises(ResourceExhaustedError) as ei:
            with pt.framework.lazy_guard():
                (x * 2.0).numpy()
    path = ei.value.postmortem_path
    assert path and os.path.exists(path)
    body = open(path).read()
    assert "RESOURCE_EXHAUSTED" in body
    assert "1048576" in body and "tensor.create" in body
    assert "watermark" in body
    assert isinstance(ei.value, MemoryError)
    assert planted is not None


def test_oom_drill_async_typed_at_sync_point(mem_on, tmp_path):
    planted = pt.to_tensor(np.zeros((256, 256), "float32"))
    with flags(flight_recorder_dir=str(tmp_path), async_flush=True,
               lazy_max_segment_ops=8, fault_inject="exec::oom=oom"):
        x = pt.to_tensor(np.ones((8, 8), "float32"))
        with pytest.raises(ResourceExhaustedError) as ei:
            with pt.framework.lazy_guard():
                y = x
                for _ in range(12):   # a cap seal: the worker fires
                    y = y + 1.0
            y.numpy()
        assert ei.value.postmortem_path
        assert "262144" in open(ei.value.postmortem_path).read()
    async_flush.drain(raise_latched=False)
    assert planted is not None


def test_is_oom_knows_the_card_and_the_drill():
    from paddle_tpu_torch.distributed.resilience.faults import (
        FaultPlan, ResourceExhausted, TransientFault)
    assert memtel.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    plan = FaultPlan("exec::oom=oom")
    with pytest.raises(ResourceExhausted) as ei:
        plan.fire("exec::oom")
    assert memtel.is_oom(ei.value)
    assert not isinstance(ei.value, TransientFault)
    assert not memtel.is_oom(RuntimeError("shape mismatch"))


def test_budget_gains_byte_columns():
    from paddle_tpu_torch.observability import budget
    x = pt.to_tensor(np.ones((16, 16), "float32"))
    out = budget.collect(lambda: _chain(x, 4), steps=3, warmup=1)
    mem = out["memory"]
    for key in ("peak_bytes", "temp_bytes", "donated_bytes_per_step",
                "live_bytes"):
        assert key in mem
    assert mem["peak_bytes"] > 0
    assert "memory:" in budget.render(out)
    memtel.reset()


def test_frame_carries_watermark(mem_on):
    class _Store:
        def set(self, k, v):
            pass

    t = pt.to_tensor(np.ones((32, 32), "float32"))
    pub = dtel.TelemetryPublisher(_Store(), rank=0, world_size=1)
    try:
        pub.on_step(1)
        mem = pub.frames[-1]["mem"]
        assert mem["live"] > 0 and mem["peak"] >= mem["live"]
        assert mem["census"] >= 1 and mem["per_device"]["cpu"] > 0
    finally:
        pub.shutdown()
    assert t is not None


def test_h2d_span_prices_input_feed():
    from paddle_tpu_torch.io import DevicePrefetcher
    with flag("FLAGS_observability", True):
        before = metrics.snapshot()["histograms"].get(
            "io.h2d_us", {}).get("count") or 0
        batches = [np.ones((4, 8), "float32") for _ in range(3)]
        out = list(DevicePrefetcher(iter(batches), depth=2))
        assert len(out) == 3
        snap = metrics.snapshot()["histograms"]["io.h2d_us"]
        assert (snap["count"] or 0) >= before + 3
    obs.reset()


def test_flight_dump_retention_rank_aware(tmp_path):
    foreign = tmp_path / "flight_r7_123_1.txt"
    foreign.write_text("foreign rank postmortem")
    distd = tmp_path / "flight_distributed_r0_99.txt"
    distd.write_text("distributed report")
    with flags(flight_recorder=True, flight_recorder_dir=str(tmp_path),
               flight_max_dumps=3):
        flight.note("test", "retention")
        paths = [flight.dump(reason="retention test") for _ in range(6)]
    names = sorted(os.listdir(tmp_path))
    own = [n for n in names if flight._PRUNABLE_RE.match(n)
           and not n.startswith("flight_r7_")]
    assert len(own) == 3, names
    assert os.path.basename(paths[-1]) in names
    assert os.path.basename(paths[0]) not in names
    assert foreign.name in names and distd.name in names
    flight.reset()


def test_flight_max_dumps_zero_disables_pruning(tmp_path):
    with flags(flight_recorder=True, flight_recorder_dir=str(tmp_path),
               flight_max_dumps=0):
        flight.note("test", "retention")
        for _ in range(5):
            flight.dump(reason="no pruning")
    own = [n for n in os.listdir(tmp_path) if flight._PRUNABLE_RE.match(n)]
    assert len(own) == 5
    flight.reset()


# =============================================================== goodput

@pytest.fixture
def goodput_on():
    with flag("FLAGS_goodput", True):
        yield
    obs.reset()


def test_goodput_off_is_zero_work(tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.resilience import ElasticStep
    from paddle_tpu_torch.io import DevicePrefetcher
    assert _state.GOODPUT is False
    w = pt.create_parameter([4, 4], "float32")
    elastic = ElasticStep(optimizer=pt.optimizer.SGD(0.0, parameters=[w]))
    x = pt.to_tensor(np.ones((8, 8), "float32"))
    with flag("FLAGS_async_flush", True):
        elastic.run(lambda: _chain(x))
        async_flush.drain()
        before = metrics.MUTATIONS
        ring0 = goodput.RING_MUTATIONS
        for _ in range(5):
            elastic.run(lambda: _chain(x))
        for _ in DevicePrefetcher(iter([np.ones((4, 4), "float32")])):
            pass
        CheckpointManager(str(tmp_path), keep=1).save(
            {"w": np.zeros((4, 4), "float32")}, step=0)
        async_flush.drain()
        assert metrics.MUTATIONS == before
        assert goodput.RING_MUTATIONS == ring0
        assert not goodput.LEDGER._started
    async_flush.drain(raise_latched=False)
    elastic.shutdown()


def test_bucket_additivity_lenet_budget(monkeypatch):
    """Over a LeNet budget run the buckets sum to the measured wall within
    5%, and the budget renders its goodput line from the same ledger."""
    from paddle_tpu_torch.observability import budget
    from paddle_tpu_torch.observability.__main__ import _lenet_step
    monkeypatch.setenv("BUDGET_BATCH", "8")
    out = budget.collect(_lenet_step(), steps=4, warmup=2)
    g = out["goodput"]
    assert g["additivity_ok"]
    total = sum(g["buckets_us_per_step"].values())
    assert total == pytest.approx(g["wall_us_per_step"], rel=0.01)
    assert total == pytest.approx(out["wall_us_per_step"], rel=0.05)
    assert g["buckets_us_per_step"]["execute"] > 0
    assert "goodput:" in budget.render(out)
    assert not _state.GOODPUT


def test_snapshot_additivity_and_stats_section(goodput_on):
    x = pt.to_tensor(np.ones((8, 8), "float32"))
    for _ in range(3):
        goodput.step_begin()
        _chain(x)
        goodput.step_end(loss=1.0)
    snap = goodput.snapshot()
    assert goodput.check_additivity(snap)
    assert snap["steps"] == 3 and snap["median_step_us"] > 0
    with flag("FLAGS_observability", True):
        sec = obs.stats()["goodput"]
    assert sec["goodput_frac"] is not None and sec["additivity_ok"]


def test_goodput_partition_matches_the_reference():
    names = ["segment::execute", "segment::compile", "segment::replay_step",
             "segment::flush[materialize]", "comm::all_reduce", "io::h2d",
             "io::input_wait", "ckpt::save", "ckpt::load",
             "optimizer::fused_step", "resilience::replan", "sot::guard_eval",
             "my_event"]
    assert [goodput.bucket_of(n) for n in names] == \
        [rgoodput.bucket_of(n) for n in names]
    snaps = [{"buckets": {"execute": 10.0, "host": 5.0}, "wall_us": 15.0},
             {"buckets": {"execute": 10.0, "host": 5.0}, "wall_us": 30.0},
             {"buckets": {}, "wall_us": 0.0}]
    for s in snaps:
        assert goodput.check_additivity(s) == rgoodput.check_additivity(s)


def test_input_wait_probe_feeds_histogram_and_bucket(goodput_on):
    from paddle_tpu_torch.io import DevicePrefetcher

    def slow_src():
        for _ in range(3):
            time.sleep(0.02)
            yield np.ones((4, 4), "float32")

    with flag("FLAGS_observability", True):
        h0 = metrics.snapshot()["histograms"].get(
            "io.input_wait_us", {"count": 0})["count"]
        b0 = goodput.snapshot()["buckets"]["input_wait"]
        for _ in DevicePrefetcher(slow_src()):
            pass
        h = metrics.snapshot()["histograms"]["io.input_wait_us"]
        assert h["count"] > h0 and h["max"] >= 15000.0
        assert goodput.snapshot()["buckets"]["input_wait"] - b0 >= 15000.0


def test_ckpt_spans_time_and_bytes(goodput_on, tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)
    state = {"w": pt.to_tensor(np.ones((64, 64), "float32"))}
    with flags(observability=True, distributed_telemetry=True):
        dtel.shutdown()
        save_state_dict(state, str(tmp_path / "ckpt"))
        load_state_dict(state, str(tmp_path / "ckpt"))
        hists = metrics.snapshot()["histograms"]
        assert hists["ckpt.save_us"]["count"] == 1
        assert hists["ckpt.load_us"]["count"] == 1
        events = dtel._drain_events()
    saves = [e for e in events if e[0] == "ckpt::save"]
    loads = [e for e in events if e[0] == "ckpt::load"]
    assert saves and saves[0][3] >= 64 * 64 * 4
    assert loads and loads[0][3] >= 64 * 64 * 4
    assert goodput.snapshot()["buckets"]["ckpt_io"] > 0
    dtel.shutdown()


def test_recovery_bucket_matches_recovery_us(goodput_on):
    from paddle_tpu_torch.distributed.resilience import ElasticStep
    w = pt.create_parameter([8, 8], "float32")
    elastic = ElasticStep(optimizer=pt.optimizer.SGD(0.0, parameters=[w]))
    x = pt.to_tensor(np.ones((8, 8), "float32"))
    h0 = metrics.snapshot()["histograms"].get(
        "resilience.recovery_us", {"count": 0, "total": 0.0})
    r0 = goodput.snapshot()["buckets"]["recovery"]
    rb0 = metrics.counter("resilience.rollbacks").value
    with flag("FLAGS_fault_inject", "step::2=fail"):
        for _ in range(4):
            elastic.run(lambda: _chain(x))
    rec = metrics.snapshot()["histograms"]["resilience.recovery_us"]
    assert rec["count"] == (h0["count"] or 0) + 1
    got = goodput.snapshot()["buckets"]["recovery"] - r0
    assert got == pytest.approx((rec["total"] or 0) - (h0["total"] or 0),
                                rel=0.15, abs=500.0)
    assert metrics.counter("resilience.rollbacks").value == rb0 + 1
    elastic.shutdown()


def test_step_abort_unwinds_ledger_state(goodput_on):
    from paddle_tpu_torch.distributed.resilience import ElasticStep
    from paddle_tpu_torch.distributed.resilience.faults import TransientFault
    w = pt.create_parameter([4, 4], "float32")
    elastic = ElasticStep(optimizer=pt.optimizer.SGD(0.0, parameters=[w]),
                          max_retries=0)
    with flag("FLAGS_fault_inject", "step::1@*=fail"):
        with pytest.raises(TransientFault):
            elastic.run(lambda: 0)
    assert goodput.LEDGER._step_depth == 0
    assert goodput.LEDGER._recover_depth == 0
    elastic.shutdown()


def test_step_spike_anomaly(goodput_on):
    x = pt.to_tensor(np.ones((4, 4), "float32"))
    c0 = metrics.counter("goodput.anomalies.step_spike").value
    with flag("FLAGS_goodput_spike_factor", 3.0):
        for i in range(8):
            goodput.step_begin()
            _chain(x, 2)
            if i == 7:
                time.sleep(0.05)
            goodput.step_end()
    assert metrics.counter("goodput.anomalies.step_spike").value >= c0 + 1


def test_nan_watch_rides_the_nan_scan(goodput_on):
    c0 = metrics.counter("goodput.anomalies.nan").value
    with flags(check_nan_inf=True, check_nan_inf_level=1):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = pt.to_tensor(np.zeros((4,), "float32"))
            (t / 0.0).numpy()
    assert metrics.counter("goodput.anomalies.nan").value >= c0 + 1


def test_loss_divergence_watch(goodput_on):
    d0 = metrics.counter("goodput.anomalies.loss_divergence").value
    n0 = metrics.counter("goodput.anomalies.nan").value
    for _ in range(6):
        goodput.note_loss(1.0)
    goodput.note_loss(100.0)
    assert metrics.counter("goodput.anomalies.loss_divergence").value \
        == d0 + 1
    goodput.note_loss(float("nan"))
    assert metrics.counter("goodput.anomalies.nan").value == n0 + 1


def test_hang_drill_stuck_collective(goodput_on, tmp_path, monkeypatch):
    """An injected stuck collective is detected within the hang factor x
    the median step (plus the poll), with a stack-carrying flight dump,
    and the job goes on."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.communication import all_reduce
    from paddle_tpu_torch.distributed.process_group import Group
    monkeypatch.setattr(tdist, "all_reduce", lambda *a, **k: None)
    g = Group([0, 1], pg=object())
    x = pt.to_tensor(np.ones((8, 8), "float32"))
    t = pt.to_tensor(np.ones((64, 64), "float32"))
    stuck_s, factor = 1.0, 5.0
    hangs0 = metrics.counter("goodput.hangs").value
    steps0 = goodput.LEDGER.steps
    with flags(flight_recorder=True, flight_recorder_dir=str(tmp_path),
               goodput_hang_factor=factor, goodput_hang_min_s=0.01,
               goodput_hang_poll_s=0.02, retry_backoff_s=0.001,
               fault_inject=f"comm::all_reduce@4=stuck({stuck_s})"):
        for _ in range(6):
            goodput.step_begin()
            _chain(x)
            time.sleep(0.015)
            try:
                all_reduce(t, group=g)
            except Exception:
                pass                    # the stuck attempt's timeout
            goodput.step_end()
    assert goodput.LEDGER.steps == steps0 + 6
    assert metrics.counter("goodput.hangs").value >= hangs0 + 1
    hang = goodput.LEDGER.last_hang
    assert hang["bucket"] == "comm_wait" and "--- thread" in hang["stacks"]
    median_s = goodput.LEDGER.median_us() / 1e6
    assert hang["timeout_s"] <= factor * median_s * 1.5 + 1e-6
    assert hang["latency_s"] <= hang["timeout_s"] + 3 * 0.02 + 0.25
    assert hang["latency_s"] < stuck_s
    dumps = glob.glob(os.path.join(str(tmp_path), "flight_*.txt"))
    assert any("--- thread" in open(p).read() for p in dumps)


def test_offthread_spans_do_not_enter_the_partition(goodput_on):
    from paddle_tpu_torch.observability.spans import span

    def worker():
        with span("segment::execute", hist="segment.execute_us"):
            time.sleep(0.02)

    snap0 = goodput.snapshot()
    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    snap = goodput.snapshot()
    assert snap["buckets"]["execute"] == snap0["buckets"]["execute"]
    assert snap["offthread_us"].get("execute", 0.0) - \
        snap0["offthread_us"].get("execute", 0.0) >= 15000.0


def _frame(mod, rank, seq, **kw):
    base = {"v": mod.FRAME_VERSION, "rank": rank, "pid": 1000 + rank,
            "seq": seq, "step": seq, "mesh_epoch": 0, "t_wall": 1000.0,
            "t_perf_us": 0.0, "counters": {}, "hists": {}, "spans": [],
            "marks": []}
    base.update(kw)
    return base


def _both(build):
    """``build(module)`` run on both packages' ``distributed`` modules."""
    return build(dtel), build(rdtel)


def test_straggler_verdict_gains_input_bound_case():
    def build(mod):
        agg = mod.TelemetryAggregator()
        for s in (1, 2, 3):
            agg.add_frame(_frame(mod, 0, s, marks=[[s, s * 1e4, 1e4]],
                                 goodput={"buckets": {"execute": 8000.0,
                                                      "host": 2000.0},
                                          "steps": 1}))
            agg.add_frame(_frame(mod, 1, s, marks=[[s, s * 1e5, 1e5]],
                                 goodput={"buckets": {
                                     "execute": 10000.0,
                                     "input_wait": 80000.0,
                                     "host": 10000.0}, "steps": 1}))
        agg.add_frame(_frame(mod, 1, 4, step=2,
                             goodput={"buckets": {"execute": 1.0},
                                      "steps": 1}))
        table = agg.step_table()
        return (table, agg.goodput_report(), mod.render_step_table(table))

    (table, report, text), want = _both(build)
    assert (table, report, text) == want
    row = [r for r in table["steps"] if r["straggler"] is not None][0]
    assert row["straggler"] == 1 and row["straggler_via"] == "wall"
    assert row["straggler_compute"] == "input_bound"
    assert report["ranks"]["1"]["input_bound"] is True
    assert "input_bound" in text


def test_frames_carry_goodput_and_cluster_report(goodput_on):
    from paddle_tpu_torch.distributed.resilience import ElasticStep
    from paddle_tpu_torch.distributed.store import TCPStore
    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                     timeout=10)
    try:
        with flag("FLAGS_distributed_telemetry", True):
            pub = dtel.init(store, rank=0, world_size=1)
            w = pt.create_parameter([4, 4], "float32")
            elastic = ElasticStep(
                optimizer=pt.optimizer.SGD(0.0, parameters=[w]))
            x = pt.to_tensor(np.ones((8, 8), "float32"))
            for _ in range(5):
                elastic.run(lambda: _chain(x))
            pub.flush()
            agg = dtel.TelemetryAggregator()
            agg.poll_store(store, [0])
        assert any(f.get("goodput") for f in agg.frames(0))
        col = agg.step_table()["goodput"]["ranks"]["0"]
        assert col["goodput_frac"] is not None
        report = agg.goodput_report()
        assert report["cluster"]["total_chip_s"] > 0
        r0 = report["ranks"]["0"]
        assert sum(r0["buckets_us"].values()) == pytest.approx(
            r0["total_us"], rel=0.01)
        assert "cluster goodput report" in dtel.render_goodput(report)
        elastic.shutdown()
    finally:
        dtel.shutdown()
        store.close()


# =============================================================== monitor

@pytest.fixture
def monitor_on():
    timeseries.reset()
    with flags(monitor_interval_s=3600.0, monitor_port=0, monitor=True):
        yield
    exporter.stop()
    timeseries.reset()


def _feed_steps(n=4, dur_s=0.01, tokens=128):
    for _ in range(n):
        timeseries.on_step(0)
        timeseries.note_tokens(tokens)
    with timeseries._LOCK:
        timeseries._WIN_DUR_S += n * dur_s
        timeseries._WIN_N += n


def _tick(prev, at):
    real_time = timeseries.time.time
    timeseries.time.time = lambda: at
    try:
        timeseries.sample_once(prev)
    finally:
        timeseries.time.time = real_time


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*\{[a-zA-Z0-9_=\",. \-/()\[\]:]*\} "
    r"-?[0-9.e+\-]+$")


def test_metrics_prometheus_validity(monitor_on):
    metrics.inc("cache.fused_step.hit", 3)
    metrics.inc("weird-name.with.dots", 2)
    metrics.gauge("some.gauge").set(7)
    metrics.observe("step.flush_us", 123.0)
    prev = {}
    _feed_steps(4)
    _tick(prev, 100.0)
    _feed_steps(4)
    _tick(prev, 101.0)
    lines = exporter.render_metrics().strip().splitlines()
    assert lines
    types = {}
    for ln in lines:
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split()
            assert name not in types
            types[name] = kind
        else:
            assert _SAMPLE_RE.match(ln), ln
            assert ln.split("{", 1)[0] in types
            assert 'rank="0"' in ln
    assert types["paddle_tpu_weird_name_with_dots_total"] == "counter"
    assert types["paddle_tpu_cache_fused_step_hit_total"] == "counter"
    assert types["paddle_tpu_some_gauge"] == "gauge"
    assert types["paddle_tpu_step_flush_us_count"] == "counter"
    assert types["paddle_tpu_monitor_steps_per_s"] == "gauge"
    assert types["paddle_tpu_monitor_tokens_per_s"] == "gauge"
    assert types["paddle_tpu_monitor_mem_peak_bytes"] == "gauge"
    line = next(ln for ln in lines
                if ln.startswith("paddle_tpu_monitor_steps_per_s{"))
    assert abs(float(line.rsplit(" ", 1)[1]) - 4.0) < 0.5
    metrics.reset()


def test_prometheus_rendering_matches_the_reference():
    """The same registry and no monitor rings: the same exposition, and
    ``sanitize`` gives the reference's names."""
    for name in ("a.b-c", "x..y", "9lives", "ok_name", "sp ace/slash"):
        assert exporter.sanitize(name) == rexporter.sanitize(name)
    snap = {"counters": {"cache.segment.hit": 5, "comm.bytes.all_reduce":
                         4096},
            "gauges": {"memory.live_bytes": 1024},
            "histograms": {"segment.flush_us": {"count": 2, "total": 31.5,
                                                "min": 1.0, "max": 30.5,
                                                "avg": 15.75}}}
    for mod, reg in ((exporter, metrics), (rexporter, rmetrics)):
        reg.reset()
        for k, v in snap["counters"].items():
            reg.inc(k, v)
        for k, v in snap["gauges"].items():
            reg.gauge(k).set(v)
        reg.observe("segment.flush_us", 1.0)
        reg.observe("segment.flush_us", 30.5)
    from paddle_tpu.observability import timeseries as rtimeseries
    timeseries.reset()
    rtimeseries.reset()
    got = exporter.render_metrics()
    want = rexporter.render_metrics()
    metrics.reset()
    rmetrics.reset()

    def mine(text):
        """The lines of the names set here (each package's runner caches
        register counters of their own)."""
        keep = ("cache_segment_hit", "comm_bytes_all_reduce",
                "memory_live_bytes", "segment_flush_us")
        return [ln for ln in text.splitlines() if any(k in ln for k in keep)]

    assert mine(got) == mine(want) and len(mine(got)) == 10


def test_http_endpoints_and_healthz_503(monitor_on):
    port = exporter.start(0)
    _feed_steps(2)
    _tick({}, 10.0)

    def get(path):
        try:
            resp = urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10)
            return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    code, body = get("/metrics")
    assert code == 200 and "# TYPE" in body
    code, body = get("/healthz")
    h = json.loads(body)
    assert code == 200 and h["ok"] and h["membership_epoch"] >= 0
    assert h["steps"] == 2 and h["last_step_age_s"] is not None
    code, body = get("/snapshot")
    snap = json.loads(body)
    assert code == 200 and snap["monitor"]["steps"] == 2
    assert "counters" in snap
    code, body = get("/timeseries")
    assert code == 200 and "mem_peak_bytes" in json.loads(body)["series"]
    code, body = get("/timeseries?name=mem_peak_bytes")
    assert code == 200 and json.loads(body)["samples"]
    assert get("/nonsense")[0] == 404
    old = goodput.LEDGER.last_hang
    goodput.LEDGER.last_hang = {"bucket": "comm_wait", "timeout_s": 8.0,
                                "latency_s": 9.1, "t_wall": 1.0}
    try:
        code, body = get("/healthz")
        assert code == 503
        assert json.loads(body)["hang"]["bucket"] == "comm_wait"
    finally:
        goodput.LEDGER.last_hang = old


def test_exporter_bound_by_flag_and_torn_down():
    timeseries.reset()
    with flags(monitor_interval_s=3600.0, monitor_port=0):
        with flag("FLAGS_monitor", True):
            assert timeseries.sampler_alive()
            assert exporter.bound_port() is None
        assert not timeseries.sampler_alive()
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    with flags(monitor_interval_s=3600.0, monitor_port=free):
        with flag("FLAGS_monitor", True):
            assert exporter.bound_port() == free
        assert exporter.bound_port() is None
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{free}/healthz",
                                   timeout=2)
    timeseries.reset()


def test_ring_bounding(monitor_on):
    with flag("FLAGS_monitor_ring", 8):
        prev = {}
        for i in range(30):
            _feed_steps(1)
            _tick(prev, 100.0 + i)
        samples = timeseries.series("steps_per_s")
        assert len(samples) == 8
        assert samples[-1][0] == 129.0 and samples[0][0] == 122.0


def test_ewma_watchdog_fire_and_no_fire(monitor_on):
    wd = timeseries._Regression(factor=1.5, steps=3)
    base = metrics.counter("monitor.regressions").value
    for i in range(10):
        wd.judge("step_time_ms", 10.0 + 0.1 * (i % 2), float(i))
    assert not timeseries.REGRESSIONS
    for i in range(2):
        wd.judge("step_time_ms", 20.0, 10.0 + i)
    for i in range(5):
        wd.judge("step_time_ms", 10.0, 12.0 + i)
    assert not timeseries.REGRESSIONS
    for i in range(10):
        wd.judge("step_time_ms", 20.0, 20.0 + i)
    assert len(timeseries.REGRESSIONS) == 1
    ev = timeseries.REGRESSIONS[0]
    assert ev["series"] == "step_time_ms"
    assert ev["current"] == 20.0 and ev["baseline"] < 12.0
    assert metrics.counter("monitor.regressions").value == base + 1
    for i in range(10):
        wd.judge("tokens_per_s", 1000.0, 40.0 + i)
    for i in range(10):
        wd.judge("tokens_per_s", 400.0, 50.0 + i)
    assert len(timeseries.REGRESSIONS) == 2


def test_seeded_slowdown_fires_once_with_flight_evidence(monitor_on,
                                                         tmp_path):
    with flags(flight_recorder=True, flight_recorder_dir=str(tmp_path)):
        prev = {}
        for i in range(8):
            _feed_steps(4, dur_s=0.010)
            _tick(prev, 100.0 + i)
        for i in range(10):
            _feed_steps(4, dur_s=0.025)
            _tick(prev, 110.0 + i)
        assert len(timeseries.REGRESSIONS) == 1
        ev = timeseries.REGRESSIONS[0]
        assert ev["series"] == "step_time_ms"
        assert ev["current"] >= 2.0 * ev["baseline"]
        notes = [e for e in flight.entries()
                 if e[1] == "monitor" and e[2] == "regression"]
        assert len(notes) == 1
        assert notes[0][3]["baseline"] == ev["baseline"]
    flight.reset()


def test_monitor_off_is_free_across_lenet_loop():
    step, _ = _lenet_step_fn()
    with flag("FLAGS_async_flush", True):
        step()
        async_flush.drain()
        assert not _state.MONITOR
        before = metrics.MUTATIONS
        for _ in range(3):
            step()
        async_flush.drain()
        assert metrics.MUTATIONS == before
        ts = sys.modules.get("paddle_tpu_torch.observability.timeseries")
        assert ts is None or not ts.sampler_alive()
        assert exporter.bound_port() is None


def test_flight_retention_covers_deep_capture_traces(tmp_path):
    with flags(flight_recorder_dir=str(tmp_path), flight_max_dumps=2):
        keep = tmp_path / "explicit_trace.json"
        keep.write_text("{}")
        protected = tmp_path / "flight_distributed_1_1.txt"
        protected.write_text("postmortem")
        paths = []
        for i in range(4):
            p = flight.trace_path()
            with open(p, "w") as f:
                f.write("{}")
            os.utime(p, (1000 + i, 1000 + i))
            paths.append(p)
            flight.prune_dumps()
        survivors = sorted(str(p) for p in tmp_path.glob("flight_trace_*"))
        assert survivors == sorted(paths[-2:])
        assert keep.exists() and protected.exists()
        flight.dump(reason="mixed-pool")
        auto = [n.name for n in tmp_path.glob("flight_*")
                if flight._PRUNABLE_RE.match(n.name)]
        assert len(auto) == 2


def test_prunable_pattern():
    m = flight._PRUNABLE_RE.match
    assert m("flight_12345_1.txt")
    assert m("flight_r3_12345_2.txt").group(1) == "3"
    assert m("flight_oom_r1_99_1.txt").group(1) == "1"
    assert m("flight_trace_12345_3.json")
    assert not m("flight_distributed_12345_1.txt")
    assert not m("flight_trace_12345_3.txt.bak")


def _fake_dump(path, rank, durs_us, *, mfu=None, peak=None, goodput=None):
    marks, t = [], 1000.0
    for i, d in enumerate(durs_us, start=1):
        t += d
        marks.append([i, t, d])
    frame = {"v": dtel.FRAME_VERSION, "rank": rank, "pid": 1000 + rank,
             "seq": 1, "step": len(durs_us), "mesh_epoch": 0,
             "t_wall": 2000.0, "t_perf_us": t, "counters": {},
             "hists": {}, "spans": [], "marks": marks}
    if mfu is not None:
        frame["compute"] = {"mfu": mfu, "gflops": 1.0, "flops": 10,
                            "peak": 1e9}
    if peak is not None:
        frame["mem"] = {"live": peak // 2, "peak": peak, "donated": 0,
                        "census": 3}
    if goodput is not None:
        frame["goodput"] = {"buckets": goodput, "steps": len(durs_us)}
    with open(path, "w") as f:
        json.dump({"rank": rank, "frames": [frame]}, f)


def test_cluster_rows_and_top_render(tmp_path):
    _fake_dump(tmp_path / "telem_rank0.json", 0, [10000.0] * 4, mfu=0.41,
               peak=64 << 20,
               goodput={"execute": 36000.0, "input_wait": 4000.0})
    _fake_dump(tmp_path / "telem_rank1.json", 1, [30000.0] * 4, mfu=0.12,
               peak=96 << 20,
               goodput={"execute": 40000.0, "comm_wait": 80000.0})

    def build(mod, exp):
        agg = mod.TelemetryAggregator()
        for p in sorted(tmp_path.glob("telem_rank*.json")):
            agg.add_dump(str(p))
        rows = exp.cluster_rows(agg)
        return rows, exp.render_top(rows, title="test"), agg

    rows, text, agg = build(dtel, exporter)
    want_rows, want_text, _ = build(rdtel, rexporter)
    assert rows == want_rows
    assert text.replace("paddle_tpu_torch", "paddle_tpu") == want_text
    assert [r["rank"] for r in rows] == [0, 1]
    assert abs(rows[0]["steps_per_s"] - 100.0) < 1.0
    assert rows[1]["straggler_steps"] >= 1
    assert "r0" in text and "YES" in text
    exporter.attach_cluster(agg)
    try:
        body = exporter.render_metrics()
        assert 'paddle_tpu_cluster_mfu{rank="1"} 0.12' in body
    finally:
        exporter.detach_cluster()


def test_top_cli_from_dumped_frames(tmp_path, capsys):
    _fake_dump(tmp_path / "telem_rank0.json", 0, [5000.0] * 3)
    _fake_dump(tmp_path / "telem_rank1.json", 1, [5200.0] * 3)
    from paddle_tpu_torch.observability.__main__ import main
    assert main(["top", "--store", str(tmp_path), "--count", "1"]) == 0
    out = capsys.readouterr().out
    assert "paddle_tpu top [" in out and "r0" in out and "r1" in out
    assert main(["top", "--count", "1"]) == 2


# =================================================== cross-rank, pure math

def test_telemetry_off_is_zero_work():
    from paddle_tpu_torch.distributed.resilience import ElasticStep
    from paddle_tpu_torch.distributed.store import TCPStore
    store = TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                     timeout=10)
    try:
        pub = dtel.init(store, rank=0, world_size=1)
        assert _state.DIST is False
        w = pt.create_parameter([4, 4], "float32")
        elastic = ElasticStep(optimizer=pt.optimizer.SGD(0.0,
                                                         parameters=[w]))
        x = pt.to_tensor(np.ones((4, 4), "float32"))
        elastic.run(lambda: _chain(x, 1))
        before = metrics.MUTATIONS
        for _ in range(5):
            elastic.run(lambda: _chain(x, 1))
        assert metrics.MUTATIONS == before
        assert pub._seq == 0 and len(pub.frames) == 0
        assert store.try_get("__telem/seq/0", timeout=0.05) is None
        elastic.shutdown()
    finally:
        dtel.shutdown()
        store.close()


def test_frame_codec_roundtrip_and_version():
    frame = _frame(dtel, 3, 7, marks=[[7, 1000.0, 250.0]],
                   spans=[["comm::all_reduce", 500.0, 100.0, 4096]],
                   hists={"comm.all_reduce_us": [100.0, 1]},
                   counters={"comm.calls.all_reduce": 1})
    assert dtel.decode_frame(dtel.encode_frame(frame)) == frame
    assert dtel.FRAME_VERSION == rdtel.FRAME_VERSION
    assert dtel.encode_frame(frame) == rdtel.encode_frame(frame)
    bad = dict(frame, v=99)
    with pytest.raises(ValueError, match="version"):
        dtel.decode_frame(dtel.encode_frame(bad))


def test_clock_rebase_and_anchor_match_the_reference():
    def build(mod):
        agg = mod.TelemetryAggregator()
        agg.add_frame(_frame(mod, 0, 1, t_wall=1000.0, t_perf_us=0.0,
                             spans=[["segment::execute", 100.0, 50.0, 0]]))
        agg.add_frame(_frame(mod, 1, 1, t_wall=1002.5, t_perf_us=0.0,
                             spans=[["segment::execute", 100.0, 50.0, 0]]))
        agg.add_frame(_frame(mod, 0, 2, t_wall=1001.0, t_perf_us=1e6))
        return (agg.clock_offsets(), agg.merged_trace(),
                mod.clock_anchor(agg.frames(0)[-1]))

    got, want = _both(build)
    assert got == want
    offs, trace, anchor = got
    assert offs[1] == pytest.approx(2.5e6)
    assert anchor == pytest.approx(1000.0 * 1e6)
    by_pid = {e["pid"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X"}
    assert by_pid[1]["ts"] == pytest.approx(100.0 + 2.5e6)


def test_interval_union_and_overlap():
    u = dtel._interval_union([(0, 10), (5, 20), (30, 40)])
    assert u == [[0, 20], [30, 40]]
    assert dtel._overlap_len([[0, 20]], [[10, 30]]) == 10
    assert dtel._overlap_len([[0, 5]], [[5, 10]]) == 0


@pytest.mark.parametrize("case", ["overlap", "serialized"])
def test_overlap_report_matches_the_reference(case):
    compute_at = 300.0 if case == "overlap" else 400.0

    def build(mod):
        agg = mod.TelemetryAggregator()
        agg.add_frame(_frame(
            mod, 0, 1, marks=[[1, 1000.0, 1000.0]],
            spans=[["comm::all_reduce", 100.0, 300.0, 1_000_000],
                   ["segment::execute", compute_at, 300.0, 0]]))
        rep = agg.overlap_report()
        return rep, mod.render_overlap(rep)

    got, want = _both(build)
    assert got == want
    rep = got[0]
    if case == "overlap":
        assert rep["total"]["overlap_frac"] == pytest.approx(1 / 3, abs=1e-3)
        assert rep["total"]["gbps"] == pytest.approx(3.333, abs=0.01)
    else:
        assert rep["total"]["overlap_frac"] == 0.0


@pytest.mark.parametrize("case", ["wall", "comm_wait", "uniform", "family",
                                  "memory", "compute"])
def test_step_table_matches_the_reference(case):
    def build(mod):
        agg = mod.TelemetryAggregator()
        for r in range(4):
            if case == "wall":
                d = 50_000.0 if r == 2 else 10_000.0
                f = _frame(mod, r, 1, marks=[[1, 1e5, d], [2, 2e5, d]])
            elif case == "comm_wait":
                f = _frame(mod, r, 1, marks=[[1, 1e5, 5e4]],
                           spans=[["comm::all_reduce", 55_000.0,
                                   1_000.0 if r == 2 else 41_000.0, 4096]])
            elif case == "uniform":
                f = _frame(mod, r, 1, marks=[[1, 1e5, 1e4 + r]])
            elif case == "family":
                f = _frame(mod, r, 1, marks=[[1, 1e5, 1e4]],
                           hists={"comm.all_reduce_us": [1000.0 * (r + 1), 1],
                                  "telemetry.publish_us": [500.0, 1]})
            elif case == "memory":
                f = _frame(mod, r, 1, marks=[[1, 1e5, 900.0]],
                           mem={"live": 500 * (r + 1),
                                "peak": 1000 * (r + 1), "donated": 0,
                                "census": 3})
            else:
                f = _frame(mod, r, 1, marks=[[1, 1e5,
                                              5e3 if r == 2 else 1e3]],
                           compute={"flops": 1000, "peak": 1e12,
                                    "gflops": 50.0 if r == 2 else 500.0,
                                    "mfu": 0.05 if r == 2 else 0.5})
            agg.add_frame(f)
        table = agg.step_table()
        return table, mod.render_step_table(table)

    got, want = _both(build)
    assert got == want
    table = got[0]
    if case == "wall":
        assert [row["straggler"] for row in table["steps"]] == [2, 2]
    elif case == "comm_wait":
        assert table["steps"][0]["straggler_via"] == "comm_wait"
    elif case == "uniform":
        assert table["straggler_counts"] == {}
    elif case == "family":
        assert table["families"]["comm"]["slowest"] == 3
        assert "telemetry" not in table["families"]
    elif case == "memory":
        assert table["memory"]["nearest_budget"] == 3
    else:
        assert table["steps"][0]["straggler_compute"] == "idle"


def test_fusion_window_break_counter():
    with flag("FLAGS_observability", True):
        obs.reset()
        with flag("FLAGS_lazy_max_segment_ops", 8):
            x = pt.to_tensor(np.ones((4, 4), "float32"))
            _chain(x, 20)
        snap = obs.stats()
        assert snap["counters"]["fusion.window_breaks"] >= 1
        assert snap["counters"]["fusion.window_breaks.segment_cap"] >= 1
        assert snap["fusion_window_breaks"] == \
            snap["counters"]["fusion.window_breaks"]
        obs.reset()
        _chain(pt.to_tensor(np.ones((4, 4), "float32")), 1)
        assert metrics.snapshot()["counters"].get(
            "fusion.window_breaks", 0) == 0
    obs.reset()


def test_comm_bytes_counted_once_per_call(monkeypatch):
    """A collective that fails once at its fault site and is retried
    counts its call and its bytes once."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.communication import all_reduce
    from paddle_tpu_torch.distributed.process_group import Group
    calls = []
    monkeypatch.setattr(tdist, "all_reduce",
                        lambda *a, **k: calls.append(1))
    with flags(observability=True, retry_backoff_s=0.001,
               fault_inject="comm::all_reduce@1=fail"):
        obs.reset()
        t = pt.to_tensor(np.ones((32, 32), "float32"))
        all_reduce(t, group=Group([0, 1], pg=object()))
        snap = metrics.snapshot()["counters"]
        assert snap["resilience.retries"] == 1 and len(calls) == 1
        assert snap["comm.calls.all_reduce"] == 1
        assert snap["comm.bytes.all_reduce"] == 4096
    obs.reset()


def test_comm_span_carries_bytes(monkeypatch):
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed.communication import all_reduce
    from paddle_tpu_torch.distributed.process_group import Group
    monkeypatch.setattr(tdist, "all_reduce", lambda *a, **k: None)
    with flag("FLAGS_distributed_telemetry", True):
        dtel.shutdown()
        t = pt.to_tensor(np.ones((16, 16), "float32"))
        all_reduce(t, group=Group([0, 1], pg=object()))
        comm = [e for e in dtel._drain_events()
                if e[0] == "comm::all_reduce"]
        assert len(comm) == 1 and comm[0][3] == 1024
    dtel.shutdown()


def test_flight_dump_rank_tagged(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "5")
    with flags(flight_recorder=True, flight_recorder_dir=str(tmp_path)):
        flight.reset()
        flight.note("span", "x::y", dur_us=1.0)
        path = flight.dump(reason="test")
        assert os.path.basename(path).startswith("flight_r5_")
        assert "rank 5 pid" in open(path).read()
    monkeypatch.delenv("PADDLE_TRAINER_ID")
    with flags(flight_recorder=True, flight_recorder_dir=str(tmp_path)):
        path = flight.dump()
        assert "_r" not in os.path.basename(path).split("flight_")[1]
    flight.reset()


def test_planes_on_and_off_are_bit_equal():
    """Telemetry must not change the numbers: a 2-layer GPT's windowed
    steps with every plane on (the first one counted under the flop and
    byte counters) give the losses and parameters of its twin's with every
    plane off, bit for bit."""
    from paddle_tpu_torch.models.gpt import (GPTForPretraining,
                                             GPTPretrainingCriterion)
    cfg = _gpt_cfg()
    r = np.random.RandomState(1)
    x = pt.to_tensor(r.randint(0, 256, (2, 64)).astype("int64"))
    y = pt.to_tensor(r.randint(0, 256, (2, 64)).astype("int64"))
    crit = GPTPretrainingCriterion()
    planes = dict(observability=True, compute_telemetry=True,
                  memory_telemetry=True, goodput=True, flight_recorder=True)
    runs = []
    for on in (False, True):
        with flags(**(planes if on else {})):
            pt.seed(0)
            model = GPTForPretraining(cfg)
            opt = pt.optimizer.AdamW(1e-3, parameters=model.parameters())
            losses = []
            for _ in range(3):
                with pt.framework.lazy_guard():
                    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
                        loss = crit(model(x), y)
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                losses.append(float(loss))
            runs.append((losses, [p.numpy() for p in model.parameters()]))
    comptel.reset()
    memtel.reset()
    obs.reset()
    assert runs[0][0] == runs[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_fast_path_records_name_their_call_site(compute_on):
    """Under the compute plane a skeleton-replayed record names its call
    site too (the Python prong takes the fast path: the native one records
    none), so a runner built from replayed records has every scope."""
    x = pt.to_tensor(np.ones((4, 4), "float32"))
    ctx_ops = []
    fast0 = lazy.FAST_OPS
    with pt.framework.lazy_guard() as ctx:
        for _ in range(4):
            y = (x * 2.0 + 1.0).sum()
            ctx_ops.append(list(ctx.pending))
            float(y.numpy())
    assert lazy.FAST_OPS > fast0
    assert all(getattr(p, "src", None) and "test_torch_telemetry.py" in p.src
               for ops in ctx_ops for p in ops)
