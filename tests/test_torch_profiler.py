"""The port's profiler against the JAX package's
(``paddle_tpu_torch/profiler``: ``__init__``, ``statistic``, ``xplane``),
and ``FLAGS_check_nan_inf``'s scan (``_core/dispatch.py``): the counterpart
of ``tests/test_profiler.py``.

- The host tracer (``RecordEvent``, the summary table, per-op ``op::``
  events with the window bypassed, interned thread ids, the tracer level
  changed mid-recording, the passive disabled path), the scheduler's
  states and cycles (each export holds its own cycle), the chrome export
  and ``load_profiler_result``.
- The device tracer: ``ProfilerTarget.GPU`` starts ``torch.profiler`` with
  CUDA activities (no card here: a logged warning and no device events,
  as the reference's failed ``start_trace``), ``ProfilerTarget.TPU``
  raises; each scheduler cycle gets its own device events; the Kineto
  reader (``xplane.from_trace``) rebases a synthetic trace onto the host
  clock through the anchor, finds each kernel's launch and its
  ``<op>[<file>:<line>]`` scope, and a kernel's launch falls inside the
  host span that made it.
- The same results as the reference from ``make_scheduler`` and
  ``statistic.summary`` on the same events.
- The NaN/Inf scan raises with the reference's message and this file's
  ``file:line``, warns at level 1, takes each op out of the window, and
  scans a flushed segment's outputs.
- The comm watchdog times out and recovers (``distributed/watchdog.py``).

Left out: none of ``tests/test_profiler.py``; its
``test_device_trace_ingestion`` needs a device tracer, which on this box
has no card to trace (the Kineto reader is held on a synthetic trace, and
phase 26 of ``chip_smoke.py`` runs the tracer on the card).
"""
import contextlib
import json
import re
import threading
import time
import warnings

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu import profiler as rprof
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import flags as pt_flags
from paddle_tpu_torch.profiler import xplane


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


def test_record_event_and_summary(capsys):
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
    p.start()
    with prof.RecordEvent("my_section"):
        time.sleep(0.01)
    with prof.RecordEvent("my_section"):
        time.sleep(0.005)
    p.stop()
    names = [e["name"] for e in p.events()]
    assert names.count("my_section") == 2
    assert "my_section" in p.summary()


def test_profiler_captures_op_events_and_bypasses_the_window():
    """Per-op mode: each op dispatches alone (a window open on the thread
    lands first, ``per_op_mode``) inside its ``op::<name>`` event."""
    x = pt.to_tensor(np.ones((8, 8), np.float32))
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
    p.start()
    with pt.framework.lazy_guard() as ctx:
        y = pt.matmul(x, x) + 1.0
        assert not ctx.pending        # nothing recorded
    _ = y.numpy()
    p.stop()
    op_names = {e["name"] for e in p.events()
                if e["name"].startswith("op::")}
    assert any("matmul" in n for n in op_names), op_names


def test_scheduler_state_machine_matches_the_reference():
    kw = dict(closed=1, ready=1, record=2, repeat=1, skip_first=1)
    sched, rsched = prof.make_scheduler(**kw), rprof.make_scheduler(**kw)
    states = [sched(i) for i in range(6)]
    S = prof.ProfilerState
    assert states == [S.CLOSED, S.CLOSED, S.READY, S.RECORD,
                      S.RECORD_AND_RETURN, S.CLOSED]
    for kw in ({"closed": 0, "ready": 0, "record": 3},
               {"closed": 2, "ready": 1, "record": 1, "repeat": 2}):
        a = [prof.make_scheduler(**kw)(i).name for i in range(12)]
        b = [rprof.make_scheduler(**kw)(i).name for i in range(12)]
        assert a == b, kw


def test_chrome_trace_export(tmp_path):
    p = prof.Profiler()
    p.start()
    with prof.RecordEvent("traced"):
        pass
    p.stop()
    path = p.export(str(tmp_path / "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    assert any(e["name"] == "traced" for e in trace["traceEvents"])
    loaded = prof.load_profiler_result(path)
    assert loaded == trace


def test_export_chrome_tracing_handler(tmp_path):
    p = prof.Profiler(on_trace_ready=prof.export_chrome_tracing(
        str(tmp_path), worker_name="w"))
    p.start()
    with prof.RecordEvent("handled"):
        pass
    p.stop()
    files = list(tmp_path.glob("w_step*.pt.trace.json"))
    assert len(files) == 1
    assert any(e["name"] == "handled" for e in
               prof.load_profiler_result(str(files[0]))["traceEvents"])


def test_profiler_step_cycle_fires_on_trace_ready():
    fired = []
    p = prof.Profiler(
        scheduler=prof.make_scheduler(closed=0, ready=0, record=2,
                                      repeat=1),
        on_trace_ready=lambda pr: fired.append(pr.step_num))
    p.start()
    for _ in range(2):
        with prof.RecordEvent("step_work"):
            pass
        p.step()
    p.stop()
    assert fired


def test_profiler_cycles_do_not_accumulate_events():
    p = prof.Profiler(scheduler=prof.make_scheduler(
        closed=1, ready=0, record=1, repeat=3))
    p.start()
    counts = []
    for _ in range(6):
        with prof.RecordEvent("work"):
            pass
        if p.current_state == prof.ProfilerState.RECORD_AND_RETURN:
            counts.append(len([e for e in p.events()
                               if e["name"] == "work"]))
        p.step()
    p.stop()
    assert counts and all(c == 1 for c in counts)


class _FakeKineto:
    """``torch.profiler.profile`` stand-in: each stopped trace exports
    a trace whose device events are named after its count."""
    started = 0

    def __init__(self, activities=None):
        _FakeKineto.started += 1
        self.n = _FakeKineto.started

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(_kineto_trace(kernel=f"kernel_cycle{self.n}"), f)


def _kineto_trace(kernel="gemm_kernel", anchor_ts=5000.0, scope=None):
    """A Kineto trace: the anchor, a host scope, the launch (cuda_runtime)
    and the kernel it launched (correlation 7)."""
    scope = scope or "matmul[/work/train.py:12]"
    return {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": xplane.ANCHOR,
         "pid": 1, "tid": 1, "ts": anchor_ts, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": scope,
         "pid": 1, "tid": 1, "ts": anchor_ts + 100.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": anchor_ts + 120.0, "dur": 5.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": kernel, "pid": 0, "tid": 7,
         "ts": anchor_ts + 130.0, "dur": 40.0,
         "args": {"correlation": 7, "stream": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": anchor_ts + 110.0, "dur": 20.0}]}


def _fake_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", _FakeKineto)


def test_scheduler_cycle_boundary_device_attribution(monkeypatch):
    """Each RECORD_AND_RETURN handler sees its own cycle's device trace."""
    _fake_cuda(monkeypatch)
    _FakeKineto.started = 0
    seen = []
    p = prof.Profiler(
        targets=[prof.ProfilerTarget.CPU, prof.ProfilerTarget.GPU],
        scheduler=prof.make_scheduler(closed=0, ready=0, record=1,
                                      repeat=2),
        on_trace_ready=lambda pr: seen.append(
            [e["name"] for e in pr.device_events()]))
    p.start()
    p.step()
    p.step()
    p.stop()
    assert seen[:2] == [["kernel_cycle1"], ["kernel_cycle2"]]


def test_device_events_rebased_with_launch_and_source(monkeypatch,
                                                      tmp_path):
    """A device event lands on the host timeline through the anchor, with
    its launch time and the recorded op's ``op@file:line``;
    ``device_summary``, ``source_summary`` and the export carry them."""
    _fake_cuda(monkeypatch)
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU,
                               prof.ProfilerTarget.GPU])
    p.start()
    with prof.RecordEvent("host step"):
        pass
    base = p._trace_start_perf_us
    p.stop()
    ev = p.device_events()[0]
    assert ev["ts"] == pytest.approx(base + 130.0)
    assert ev["launch_ts"] == pytest.approx(base + 120.0)
    assert ev["dur"] == pytest.approx(40.0)
    assert ev["src"] == "matmul@/work/train.py:12"
    assert p.device_summary()[ev["name"]]["calls"] == 1
    assert "matmul@" in p.source_summary()
    path = p.export(str(tmp_path / "t.json"))
    devs = [e for e in json.load(open(path))["traceEvents"]
            if e["cat"] == "device"]
    assert devs and devs[0]["args"]["src"] == "matmul@/work/train.py:12"


def test_kineto_reader_on_a_synthetic_trace(tmp_path):
    """``ingest`` reads the newest trace of a directory: times relative to
    the anchor, the stream as the lane, the launch through its
    correlation, and the scope open on the launching thread."""
    with open(tmp_path / "a.pt.trace.json", "w") as f:
        json.dump(_kineto_trace(anchor_ts=1e9), f)
    events, why = xplane.ingest(str(tmp_path))
    assert why == ""
    assert events == [{"name": "gemm_kernel", "tid": "stream 7",
                       "start_ns": 130000, "dur_ns": 40000,
                       "launch_ns": 120000,
                       "src": "matmul@/work/train.py:12"}]
    # a launch after its scope closed is not attributed to it
    t = _kineto_trace()
    t["traceEvents"][2]["ts"] = 5000.0 + 200.0
    evs, _ = xplane.from_trace(t)
    assert "src" not in evs[0]
    assert xplane.ingest(str(tmp_path / "none"))[0] == []
    no_anchor = {"traceEvents": _kineto_trace()["traceEvents"][1:]}
    assert xplane.from_trace(no_anchor) == ([], "the trace holds no "
                                            "clock anchor")


def test_a_kernel_launch_falls_inside_its_host_span(monkeypatch):
    """After the rebase a kernel's launch lies inside the host span that
    was open when it was launched: the host span and the trace's scope
    are both placed on the ``perf_counter`` clock."""
    _fake_cuda(monkeypatch)
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU,
                               prof.ProfilerTarget.GPU],
                      fused_runtime=True)
    p.start()
    base = p._trace_start_perf_us
    # a host span covering [base + 90, base + 160) us
    prof._add_span_event("segment::execute", base + 90.0, 70.0)
    p.stop()
    span = next(e for e in p.events() if e["name"] == "segment::execute")
    ev = p.device_events()[0]
    assert span["ts"] <= ev["launch_ts"] <= span["ts"] + span["dur"]
    assert ev["ts"] >= ev["launch_ts"]


def test_tpu_target_raises_and_gpu_without_a_card_warns(caplog):
    with pytest.raises(ValueError, match="TPU"):
        prof.Profiler(targets=[prof.ProfilerTarget.TPU])
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU,
                               prof.ProfilerTarget.GPU])
    with caplog.at_level("WARNING"):
        p.start()
        with prof.RecordEvent("host only"):
            pass
        p.stop()
    assert p.device_events() == []
    assert any("device trace" in r.message for r in caplog.records)
    assert any(e["name"] == "host only" for e in p.events())


def test_interned_thread_ids_never_merge_lanes(tmp_path):
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
    p.start()

    def work():
        with prof.RecordEvent("thread_work"):
            time.sleep(0.002)

    t = threading.Thread(target=work, name="worker-thread")
    with prof.RecordEvent("main_work"):
        t.start()
        t.join(timeout=30)
    p.stop()
    evs = {e["name"]: e for e in p.events()}
    tid_main = evs["main_work"]["tid"]
    tid_worker = evs["thread_work"]["tid"]
    assert tid_main != tid_worker
    assert all(isinstance(t, int) and 0 < t < 1 << 16
               for t in (tid_main, tid_worker))
    path = p.export(str(tmp_path / "threads.json"))
    meta = [e for e in json.load(open(path))["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "thread_name"]
    assert "worker-thread" in {e["args"]["name"] for e in meta}


def test_tracer_level_change_mid_recording():
    """Raising FLAGS_host_tracer_level from 0 mid-cycle installs the
    per-op hook at once."""
    with flag("FLAGS_host_tracer_level", 0):
        p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
        p.start()
        x = pt.to_tensor(np.ones((4, 4), np.float32))
        _ = (x * 2.0).numpy()
        pt.set_flags({"FLAGS_host_tracer_level": 1})
        _ = pt.matmul(x, x).numpy()
        p.stop()
    names = [e["name"] for e in p.events() if e["name"].startswith("op::")]
    assert any("matmul" in n for n in names)
    assert not any("multiply" in n for n in names)


def test_record_event_disabled_path_is_passive():
    ev = prof.RecordEvent("idle")
    ev.begin()
    assert ev._t0 is None
    ev.end()
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
    p.start()
    p.stop()
    assert not any(e["name"] == "idle" for e in p.events())


def test_counter_events_only_while_recording():
    prof._add_counter_event("memory.live_bytes", 123)
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU])
    p.start()
    prof._add_counter_event("memory.live_bytes", 456.7)
    prof._add_counter_event("compute.achieved_gflops", 0.25, key="gflops")
    p.stop()
    cs = [e for e in p.events() if e.get("ph") == "C"]
    assert [c["args"] for c in cs] == [{"bytes": 456},
                                       {"gflops": 0.25}]


def test_statistic_summary_matches_the_reference(capsys):
    from paddle_tpu.profiler import statistic as rstat
    from paddle_tpu_torch.profiler import statistic
    events = [{"name": "a", "dur": 10.0}, {"name": "b", "dur": 30.0},
              {"name": "a", "dur": 5.0}, {"name": "c", "ph": "C"},
              {"name": "a_very_long_name_" * 4, "dur": 1.0}]
    for key in list(statistic.SortedKeys) + [None]:
        rkey = None if key is None else rstat.SortedKeys[key.name]
        for unit in ("ms", "us", "s"):
            assert statistic.summary(events, key, unit) == \
                rstat.summary(events, rkey, unit)


# ------------------------------------------------------ the NaN/Inf scan

def test_nan_inf_checker_flag_raises_with_the_call_site():
    with flag("FLAGS_check_nan_inf", True):
        with pytest.raises(FloatingPointError) as ei:
            pt.log(pt.to_tensor(np.array([-1.0], np.float32)))
    msg = str(ei.value)
    assert re.match(r"NaN/Inf detected in output 0 of op '\w*log\w*' @ "
                    r".*test_torch_profiler\.py:\d+$", msg), msg


def test_nan_inf_message_matches_the_reference():
    """The same op on the same input: the reference's message (its op name
    and output index) and a call site in this file on both sides."""
    import paddle_tpu as ref
    from conftest import with_flag
    msgs = []
    with flag("FLAGS_check_nan_inf", True):
        with pytest.raises(FloatingPointError) as ei:
            pt.sqrt(pt.to_tensor(np.array([-4.0], np.float32)))
        msgs.append(str(ei.value))
    with with_flag("FLAGS_check_nan_inf", True):
        with pytest.raises(FloatingPointError) as ei:
            ref.sqrt(ref.to_tensor(np.array([-4.0], np.float32)))
        msgs.append(str(ei.value))
    heads = [m.split(" @ ")[0] for m in msgs]
    assert heads[0] == heads[1], msgs
    assert all("test_torch_profiler.py:" in m for m in msgs), msgs


def test_nan_inf_warns_at_level_one():
    with flag("FLAGS_check_nan_inf", True), \
            flag("FLAGS_check_nan_inf_level", 1):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = pt.log(pt.to_tensor(np.array([-1.0, 1.0], np.float32)))
        assert np.isnan(out.numpy()[0])
    assert any("NaN/Inf detected in output 0" in str(x.message) for x in w)


def test_nan_scan_takes_each_op_out_of_the_window():
    x = pt.to_tensor(np.ones((2, 2), np.float32))
    with flag("FLAGS_check_nan_inf", True):
        with pt.framework.lazy_guard() as ctx:
            y = x * 2.0
            assert not ctx.pending
    assert float(y.sum().numpy()) == 8.0


def test_nan_scan_of_a_flushed_segment_names_the_op_and_its_line():
    """Recorded before the flag went on (under the compute plane, which
    captures each record's call site), the segment's outputs are scanned
    at the flush, naming the producing op and where it was recorded."""
    x = pt.to_tensor(np.array([1.0, -1.0], np.float32))
    with pytest.raises(FloatingPointError) as ei:
        with flag("FLAGS_compute_telemetry", True), \
                pt.framework.lazy_guard():
            with flag("FLAGS_check_nan_inf", True):
                pass
            y = pt.sqrt(x) + 0.0
            with flag("FLAGS_check_nan_inf", True):
                float(y.sum().numpy())
    msg = str(ei.value)
    assert "lazy segment output" in msg and "'add" in msg
    assert "test_torch_profiler.py:" in msg, msg


def test_nan_scan_off_costs_no_sync():
    """Off, the scan reads nothing: an infinite output passes."""
    out = pt.log(pt.to_tensor(np.array([0.0], np.float32)))
    assert np.isinf(out.numpy()[0])


# ----------------------------------------------------------- the watchdog

def test_comm_watchdog_times_out_and_recovers():
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager
    fired = []
    mgr = CommTaskManager(check_interval=0.05,
                          on_timeout=lambda t: fired.append(t.name))
    mgr.register("step", timeout=0.15)
    for _ in range(3):
        time.sleep(0.05)
        mgr.heartbeat("step")
    assert not fired
    deadline = time.time() + 5.0
    while not fired and time.time() < deadline:
        time.sleep(0.05)
    assert fired == ["step"]
    assert mgr.timed_out("step")
    mgr.heartbeat("step")
    assert not mgr.timed_out("step")
    mgr.shutdown()


def test_watchdog_firing_dumps_the_flight_ring(tmp_path):
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager
    from paddle_tpu_torch.observability import flight
    with flag("FLAGS_flight_recorder", True), \
            flag("FLAGS_flight_recorder_dir", str(tmp_path)):
        flight.reset()
        mgr = CommTaskManager(check_interval=0.02,
                              on_timeout=lambda t: None)
        mgr.register("stuck", timeout=0.05)
        deadline = time.time() + 5.0
        while not list(tmp_path.glob("flight_*.txt")) \
                and time.time() < deadline:
            time.sleep(0.02)
        mgr.shutdown()
    body = list(tmp_path.glob("flight_*.txt"))[0].read_text()
    assert "watchdog: task 'stuck'" in body and "--- thread" in body
    flight.reset()
