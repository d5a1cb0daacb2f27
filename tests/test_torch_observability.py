"""The port's fused-runtime telemetry against the JAX package's
(``paddle_tpu_torch/observability``: ``__init__``, ``metrics``, ``spans``,
``flight``, ``budget``, ``__main__``, and the hot sites of ``_core/lazy.py``,
``_core/cache.py``, ``_core/autograd.py``, ``optimizer/optimizer.py``): the
counterpart of the tests of ``tests/test_observability.py``.

- The registry (counters, gauges, histograms, in-place reset, threads), the
  flag gates and ``set_flags``'s all-or-nothing check.
- Off-cost: with every plane off, an elementwise chain, a LeNet step under
  the window and the eager GPT step (under the window and op by op) make
  zero registry mutations.
- The window's counters on the same chain and the same LeNet steps as the
  reference's (the same numpy weights and inputs): flushes, flush reasons,
  runner-cache hits and misses, builds, window breaks, fused steps and
  optimizer steps; ``stats()`` has the reference's keys, and ``_derived``
  gives the reference's numbers on the same counters.
- The profiler's fused-runtime trace of a LeNet step (``segment::flush``
  with its build and execute children, ``optimizer::fused_step``), the
  flight recorder's dumps (a failed flush, an ``EnforceNotMet``), a NaN
  trip in the fused step dropping its trace, the ring's live capacity and
  bound, the CLI (``stats``, ``budget``) and ``budget.collect``.

Left out: ``test_sanitizer_sweeps_live_in_registry`` (the sanitizer's
segment sweep is the analysis plane's, ``ROADMAP.md`` §1 item 9).

Tolerances: counters compare exactly; losses where one run is the
reference's within 1e-5 relative.
"""
import contextlib
import json
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from conftest import with_flag
from paddle_tpu import observability as robs
from paddle_tpu.vision.models import LeNet as RLeNet
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import flags as pt_flags
from paddle_tpu_torch._core import lazy
from paddle_tpu_torch.observability import _state, flight, metrics
from paddle_tpu_torch.vision.models import LeNet

RTOL = 1e-5


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


@pytest.fixture
def obs_on():
    with flag("FLAGS_observability", True):
        obs.reset()
        yield
    obs.reset()


def _chain(pkg, x, n=8):
    """``n`` multiply-adds of ``x`` read back: in the port inside
    ``lazy_guard()`` (its ambient window is off), in the reference under
    its ambient window."""
    if pkg is pt:
        with pt.framework.lazy_guard():
            y = x
            for _ in range(n):
                y = y * 1.001 + 0.1
            return y.numpy()
    y = x
    for _ in range(n):
        y = y * 1.001 + 0.1
    return np.asarray(y._value)


# ------------------------------------------------------------- registry

def test_counter_gauge_histogram_snapshot(obs_on):
    metrics.counter("t.c").inc()
    metrics.counter("t.c").inc(4)
    metrics.gauge("t.g").set(2.5)
    for v in (3.0, 7.0, 100.0):
        metrics.histogram("t.h").observe(v)
    snap = metrics.snapshot()
    assert snap["counters"]["t.c"] == 5
    assert snap["gauges"]["t.g"] == 2.5
    h = snap["histograms"]["t.h"]
    assert (h["count"], h["min"], h["max"]) == (3, 3.0, 100.0)
    assert h["avg"] == pytest.approx(110.0 / 3)


def test_reset_zeroes_in_place(obs_on):
    """The runner caches hold Counter objects: reset zeroes the object."""
    c = metrics.counter("t.held")
    c.inc(3)
    obs.reset()
    assert c.value == 0
    c.inc()
    assert metrics.snapshot()["counters"]["t.held"] == 1


def test_threaded_increments(obs_on):
    c = metrics.counter("t.threads")

    def worker():
        for _ in range(1000):
            c.inc()

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert c.value == 8000


def test_set_flags_partial_failure_is_atomic():
    """A misspelt name in the dict writes nothing, so no watcher-kept gate
    goes stale."""
    before = pt_flags.flag_value("FLAGS_observability")
    with pytest.raises(ValueError):
        pt.set_flags({"FLAGS_observability": True,
                      "FLAGS_definitely_not_a_flag": 1})
    assert pt_flags.flag_value("FLAGS_observability") == before
    assert _state.METRICS == bool(before)


def test_flag_gate_sync():
    assert not _state.METRICS and not _state.ACTIVE
    with flag("FLAGS_observability", True):
        assert _state.METRICS and _state.ACTIVE
    assert not _state.METRICS
    with flag("FLAGS_flight_recorder", True):
        assert _state.FLIGHT and _state.ACTIVE
    assert not _state.FLIGHT and not _state.ACTIVE


def test_every_plane_has_the_reference_flags():
    """The planes' flags carry the reference's names and defaults."""
    from paddle_tpu._core import flags as rflags
    names = [n for n in rflags._REGISTRY
             if n.startswith(("FLAGS_distributed_telemetry",
                              "FLAGS_telemetry_", "FLAGS_observability",
                              "FLAGS_memory_telemetry",
                              "FLAGS_compute_telemetry",
                              "FLAGS_device_peak_", "FLAGS_goodput",
                              "FLAGS_flight_", "FLAGS_monitor",
                              "FLAGS_check_nan_inf", "FLAGS_profiler_",
                              "FLAGS_host_tracer_level"))]
    assert len(names) >= 30
    for n in names:
        assert pt_flags.flag_value(n) == rflags.flag_value(n), n


# ------------------------------------------------- zero work when off

def test_off_mode_zero_registry_work():
    """Every plane off: the chain does zero registry mutations."""
    x = pt.to_tensor(np.ones((8, 8), "float32"))
    assert not _state.ACTIVE
    _chain(pt, x)                  # warm the caches off-meter
    before = metrics.MUTATIONS
    for _ in range(5):
        _chain(pt, x)
    assert metrics.MUTATIONS == before


# -------------------------------------------------- runtime counters

def _flush_counts(pkg, reset, stats):
    x = pkg.to_tensor(np.ones((5, 7), "float32"))
    reset()
    vals = []
    for _ in range(2):
        if pkg is pt:
            with pt.framework.lazy_guard():
                y = (x * 2.0 + 1.0).sum()
                vals.append(float(y.numpy()))
        else:
            y = (x * 2.0 + 1.0).sum()
            vals.append(float(y.numpy()))
    return vals, stats()


def test_segment_flush_counters_match_the_reference(obs_on):
    """The same cold-then-warm flush: the same counters, builds, hit rate
    and histogram counts as the reference's."""
    lazy.clear_segment_cache()
    got_vals, got = _flush_counts(pt, obs.reset, obs.stats)
    from paddle_tpu._core import lazy as rlazy
    with with_flag("FLAGS_observability", True), \
            with_flag("FLAGS_static_checks", "off"):
        rlazy.clear_segment_cache()
        want_vals, want = _flush_counts(ref, robs.reset, robs.stats)
    robs.reset()
    assert got_vals == want_vals
    keys = ("segment.flushes", "segment.flush_reason.materialize",
            "cache.segment.miss", "cache.segment.hit", "compiles.segment")
    assert {k: got["counters"][k] for k in keys} == \
        {k: want["counters"][k] for k in keys}
    assert got["counters"]["segment.flushes"] == 2
    assert got["compiles"] == want["compiles"] == 1
    assert got["cache_hit_rate"] == want["cache_hit_rate"] == 0.5
    for h in ("segment.flush_us", "segment.compile_us",
              "segment.execute_us"):
        assert got["histograms"][h]["count"] == \
            want["histograms"][h]["count"]


def test_eager_ops_counter_when_window_off(obs_on):
    before = obs.stats()["counters"].get("eager.ops", 0)
    x = pt.to_tensor(np.ones((4, 4), "float32"))
    _ = (x * 3.0).numpy()
    assert obs.stats()["counters"]["eager.ops"] > before


@pytest.mark.parametrize("keys", ["off", "planes"])
def test_stats_keys_match_the_reference(keys):
    """``stats()`` has the reference's keys, with every plane off and with
    the memory, compute and goodput planes on (each adds its section, with
    the reference's keys)."""
    planes = {} if keys == "off" else {
        "FLAGS_memory_telemetry": True, "FLAGS_compute_telemetry": True,
        "FLAGS_goodput": True}
    with contextlib.ExitStack() as st:
        for k, v in planes.items():
            st.enter_context(flag(k, v))
            st.enter_context(with_flag(k, v))
        got, want = obs.stats(), robs.stats()
    assert set(got) == set(want)
    for sec in ("memory", "compute", "goodput"):
        if sec in want:
            assert set(got[sec]) == set(want[sec]), sec
    from paddle_tpu.observability import budget as rbudget
    from paddle_tpu_torch.observability import budget
    assert set(rbudget._KNOWN) == set(budget._KNOWN)


def test_derived_matches_the_reference():
    counters = {"cache.segment.hit": 6, "cache.segment.miss": 2,
                "cache.fused_step.hit": 9, "cache.fused_step.miss": 1,
                "compiles.segment": 2, "compiles.fused_step": 1,
                "fusion.window_breaks": 3, "segment.flushes": 12}
    assert obs._derived(counters) == robs._derived(counters)
    assert obs._derived({}) == robs._derived({})


# ------------------------------------------- steady-state acceptance

def _lenet_weights():
    pt.seed(0)
    return {k: v.numpy().copy() for k, v in LeNet().state_dict().items()}


def _lenet_step_fn(pkg, weights, window):
    """A LeNet Adam step of the same weights and batch in either package;
    the port's runs inside ``lazy_guard()`` when ``window``."""
    model = (LeNet if pkg is pt else RLeNet)()
    model.set_state_dict({k: pkg.to_tensor(v) for k, v in weights.items()})
    opt = pkg.optimizer.Adam(1e-3, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = pkg.to_tensor(rng.randn(16, 1, 28, 28).astype(np.float32))
    y = pkg.to_tensor(rng.randint(0, 10, (16,)).astype(np.int64))
    fn = F if pkg is pt else RF

    def body():
        loss = fn.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    def step():
        if pkg is pt and window:
            with pt.framework.lazy_guard():
                loss = body()
            return float(loss)
        return float(body().numpy())
    return step


_LENET = {}


def _lenet_runs():
    """The port's and the reference's stats after 2 cold and 10 warm LeNet
    steps (once per module)."""
    if not _LENET:
        w = _lenet_weights()
        with flag("FLAGS_observability", True):
            lazy.clear_segment_cache()
            step = _lenet_step_fn(pt, w, True)
            obs.reset()
            losses = [step() for _ in range(2)]
            cold = obs.stats()
            losses += [step() for _ in range(10)]
            _LENET["pt"] = (losses, cold, obs.stats())
        obs.reset()
        from paddle_tpu._core import lazy as rlazy
        with with_flag("FLAGS_observability", True), \
                with_flag("FLAGS_static_checks", "off"):
            rlazy.clear_segment_cache()
            step = _lenet_step_fn(ref, w, True)
            robs.reset()
            losses = [step() for _ in range(2)]
            cold = robs.stats()
            losses += [step() for _ in range(10)]
            _LENET["ref"] = (losses, cold, robs.stats())
        robs.reset()
    return _LENET["pt"], _LENET["ref"]


def test_lenet_steady_state_stats():
    """After two cold steps the step cache serves the loop (hit rate >=
    0.8) and the builds froze, as in the reference."""
    (_, cold, snap), _ = _lenet_runs()
    assert cold["compiles"] > 0
    assert snap["compiles"] == cold["compiles"]
    assert snap["step_cache_hit_rate"] >= 0.8
    assert snap["counters"]["autograd.fused_steps"] == 12
    assert snap["counters"]["optimizer.steps"] == 12


def test_lenet_counters_match_the_reference():
    """The same 12 LeNet steps: the same losses (1e-5) and the same window
    counters as the reference's (its fused optimizer update is a compiled
    executable and the port's is not, so ``compiles.optimizer`` and the
    optimizer's cache stay out of the comparison)."""
    (got_l, _, got), (want_l, _, want) = _lenet_runs()
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL)
    keys = ("segment.flushes", "segment.flush_reason.backward_fused",
            "cache.fused_step.hit", "cache.fused_step.miss",
            "compiles.fused_step", "autograd.fused_steps",
            "optimizer.steps")
    assert {k: got["counters"].get(k, 0) for k in keys} == \
        {k: want["counters"].get(k, 0) for k in keys}
    assert got["fusion_window_breaks"] == want["fusion_window_breaks"] == 0
    assert got["step_cache_hit_rate"] == want["step_cache_hit_rate"]


def test_lenet_step_makes_zero_mutations_with_planes_off():
    """The acceptance off-cost: a windowed LeNet step with every plane off
    does no registry work."""
    step = _lenet_step_fn(pt, _lenet_weights(), True)
    step()
    before = metrics.MUTATIONS
    for _ in range(3):
        step()
    assert metrics.MUTATIONS == before


@pytest.mark.parametrize("window", [True, False])
def test_gpt_step_makes_zero_mutations_with_planes_off(window):
    """The eager GPT step (2 layers, O1 bf16, AdamW), under the window and
    op by op, does no registry work with every plane off."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTPretrainingCriterion)
    cfg = GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                    num_heads=2, max_position_embeddings=64,
                    dtype="float32")
    pt.seed(0)
    model = GPTForPretraining(cfg)
    crit = GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    r = np.random.RandomState(0)
    x = pt.to_tensor(r.randint(0, 256, (2, 64)).astype("int64"))
    y = pt.to_tensor(r.randint(0, 256, (2, 64)).astype("int64"))

    def step():
        with contextlib.ExitStack() as st:
            if window:
                st.enter_context(pt.framework.lazy_guard())
            with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = crit(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        return float(loss)

    step()
    before = metrics.MUTATIONS
    for _ in range(2):
        step()
    assert metrics.MUTATIONS == before


def test_lenet_trace_spans(obs_on, tmp_path):
    """A fused-runtime chrome trace of LeNet steps shows
    ``segment::flush[backward_fused]`` with its build and cached-execute
    children, the optimizer's span and a host event."""
    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                           RecordEvent)
    lazy.clear_segment_cache()
    step = _lenet_step_fn(pt, _lenet_weights(), True)
    with Profiler(targets=[ProfilerTarget.CPU], fused_runtime=True) as p:
        with RecordEvent("train_loop"):
            for _ in range(3):            # step 1 cold, 2-3 warm
                step()
    path = p.export(str(tmp_path / "lenet.trace.json"))
    trace = json.load(open(path))["traceEvents"]
    spans = [e for e in trace if e.get("cat") == "runtime"]
    names = [e["name"] for e in spans]
    assert "segment::flush[backward_fused]" in names
    assert "segment::compile" in names
    assert "segment::execute" in names
    assert "optimizer::fused_step" in names
    fl = next(e for e in spans
              if e["name"] == "segment::flush[backward_fused]")
    assert fl["args"]["reason"] == "backward_fused"
    assert fl["args"]["ops"] > 0
    assert any(e["name"] == "train_loop" for e in trace)


# ------------------------------------------------------ flight recorder

def test_flight_recorder_dump_on_flush_failure(tmp_path, monkeypatch):
    """A failed flush dumps the ring; the report holds the healthy flush's
    span and the failing one's, tagged with the error."""
    def boom(pending, live):
        raise RuntimeError("seeded flush failure")

    with flag("FLAGS_flight_recorder", True), \
            flag("FLAGS_flight_recorder_dir", str(tmp_path)), \
            flag("FLAGS_observability", True):
        obs.reset()
        x = pt.to_tensor(np.ones((3, 3), "float32"))
        with pt.framework.lazy_guard():
            float((x * 2.0).sum().numpy())
        monkeypatch.setattr(lazy, "_build_segment_fn", boom)
        with pytest.raises(RuntimeError, match="seeded flush failure"):
            with pt.framework.lazy_guard():
                y = x * 5.0 + 1.0                 # fresh signature
                float(y.sum().numpy())
        monkeypatch.undo()
        dumps = list(tmp_path.glob("flight_*.txt"))
        assert dumps, "flush failure did not dump a flight record"
        body = dumps[0].read_text()
        assert "flush_failed" in body
        assert "seeded flush failure" in body
        assert "segment::flush" in body
        assert any("segment::flush" in ln and "error=" in ln
                   for ln in body.splitlines())
        assert obs.stats()["counters"]["flight.dumps"] >= 1
    obs.reset()


def test_flight_recorder_dump_on_enforce(tmp_path):
    from paddle_tpu_torch.base.core import InvalidArgumentError
    with flag("FLAGS_flight_recorder", True), \
            flag("FLAGS_flight_recorder_dir", str(tmp_path)):
        flight.reset()
        flight.note("span", "segment::flush[test]", dur_us=1.0)
        with pytest.raises(InvalidArgumentError):
            raise InvalidArgumentError("seeded enforce", "hint")
        dumps = list(tmp_path.glob("flight_*.txt"))
        assert dumps
        body = dumps[0].read_text()
        assert "enforce" in body and "seeded enforce" in body
    flight.reset()


def test_fused_backward_nan_trip_drops_trace(obs_on):
    """A NaN/Inf trip inside the fused step drops the consumed trace, as a
    failed build does."""
    x = pt.to_tensor(np.ones((2, 2), "float32"))
    x.stop_gradient = False
    with pt.framework.lazy_guard() as ctx:
        y = (x * float("nan")).sum()
        # on after recording: with it on at record time every op
        # dispatches alone
        with flag("FLAGS_check_nan_inf", True):
            with pytest.raises(FloatingPointError, match="fused-step"):
                y.backward()
        assert not ctx.pending
        assert float((x.detach() + 1.0).sum().numpy()) == 8.0


def test_flight_capacity_change_is_live():
    with flag("FLAGS_flight_recorder", True), \
            flag("FLAGS_flight_recorder_capacity", 8):
        flight.reset()
        for i in range(8):
            flight.note("span", f"c{i}")
        pt.set_flags({"FLAGS_flight_recorder_capacity": 3})
        rec = obs.flight_record()
        assert "3 event(s)" in rec and "c7" in rec and "c4" not in rec
    flight.reset()


def test_flight_ring_is_bounded():
    with flag("FLAGS_flight_recorder", True), \
            flag("FLAGS_flight_recorder_capacity", 8):
        flight.reset()
        for i in range(50):
            flight.note("span", f"e{i}")
        rec = obs.flight_record()
        assert "e49" in rec and "e0 " not in rec
        assert rec.count("span") <= 9
    flight.reset()


# ----------------------------------------------------------------- CLI

def test_cli_chain_json(capsys):
    from paddle_tpu_torch.observability.__main__ import main
    with flag("FLAGS_observability", False):
        assert main(["--steps", "3", "--json", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
    snap = json.loads(out.strip().splitlines()[-1])
    assert snap["counters"]["segment.flushes"] >= 3
    assert "compiles" in snap and "cache_hit_rate" in snap
    obs.reset()
    pt.set_flags({"FLAGS_observability": False})


def test_stats_without_enable_is_well_formed():
    snap = obs.stats()
    assert set(snap) >= {"counters", "gauges", "histograms", "compiles",
                         "cache_hit_rate", "step_cache_hit_rate"}


# -------------------------------------------------------------- budget

def test_budget_mode_ranks_components(capsys):
    """``budget`` ranks the span histograms into a per-step table whose
    entries (host gap included) sum to the wall time."""
    from paddle_tpu_torch.observability.__main__ import main
    assert main(["budget", "--model", "chain", "--steps", "3", "--json",
                 "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "chain" and out["steps"] == 3
    assert out["wall_us_per_step"] > 0
    names = [e["name"] for e in out["entries"]]
    assert any("host gap" in n for n in names)
    assert any(n.startswith("segment::") for n in names)
    total = sum(e["us_per_step"] for e in out["entries"])
    want = out["accounted_us_per_step"] + out["host_gap_us_per_step"]
    assert abs(total - want) < max(1.0, 0.01 * want)
    costs = [e["us_per_step"] for e in out["entries"]]
    assert costs == sorted(costs, reverse=True)
    obs.reset()


def test_budget_distributed_takes_a_card_a_rank(capsys):
    """On the card (the default device) ``budget --distributed`` runs one
    rank a card: more ranks than cards are refused before any rank
    starts, naming ``--device cpu``; it never falls back to the CPU."""
    from paddle_tpu_torch.observability.__main__ import main
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert main(["budget", "--distributed", "--nranks", str(cards + 1),
                 "--steps", "1"]) == 2
    err = capsys.readouterr().err
    assert f"{cards} are present" in err and "--device cpu" in err
    assert main(["budget", "--distributed", "--device", "tpu",
                 "--steps", "1"]) == 2


def test_budget_collect_restores_metrics_flag():
    from paddle_tpu_torch.observability import budget as budget_mod
    x = pt.to_tensor(np.ones((4, 4), "float32"))

    def step():
        _chain(pt, x, 1)

    with flag("FLAGS_observability", False):
        out = budget_mod.collect(step, steps=2, warmup=1)
        assert not obs.enabled()
    assert out["wall_us_per_step"] > 0
    assert out["host_gap_us_per_step"] <= out["wall_us_per_step"]
    obs.reset()


def test_budget_rank_matches_the_reference():
    """``budget._rank`` and ``render`` give the reference's table on the
    same histogram delta."""
    from paddle_tpu.observability import budget as rbudget
    from paddle_tpu_torch.observability import budget
    snap = {"histograms": {
        "segment.flush_us": {"total": 900.0, "count": 3},
        "segment.compile_us": {"total": 300.0, "count": 1},
        "segment.execute_us": {"total": 450.0, "count": 2},
        "optimizer.step_us": {"total": 120.0, "count": 3},
        "comm.all_reduce_us": {"total": 60.0, "count": 3}},
        "counters": {"segment.flushes": 3, "other.x": 1},
        "step_cache_hit_rate": 0.5}
    got, want = budget._rank(snap, 1500.0, 3), rbudget._rank(snap, 1500.0, 3)
    assert got == want
    assert budget.render(got) == rbudget.render(want)


def test_static_diff_waits_for_the_analysis_plane():
    from paddle_tpu_torch.observability import budget
    with pytest.raises(NotImplementedError, match="item 9"):
        budget.static_diff(lambda: None)
    with pytest.raises(NotImplementedError, match="item 9"):
        budget.render_static_diff({})
