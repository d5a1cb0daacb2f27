"""The port's elastic resilience runtime in one process, against the JAX
package's (``paddle_tpu_torch/distributed/resilience``,
``fleet/elastic.py``, ``observability/metrics.py``,
``analysis/distributed_checks.py``): the counterpart of the
single-process tests of ``tests/test_resilience.py`` and the elastic rows
of ``tests/test_engine_tuner_elastic.py``.

- Rollback: a LeNet trained under ``ElasticStep`` with injected step
  faults (``step::N=fail``, ``stuck``), a ``segment::compile`` fault under
  ``lazy_guard()`` and collective faults is bit-equal to the port's
  uninterrupted run, whose losses are the reference's within 1e-5 (the
  same numpy weights and inputs on both sides); the exhausted budget
  raises and counts ``resilience.gave_up``; rank death without a handler
  propagates, with one it shrinks the world, and its budget bounds the
  loop.
- The store's sites are retried (``store::get``), ``try_get`` is never a
  site, ``add`` is not retried, barrier rounds wrap; with
  ``FLAGS_fault_inject`` off the registry does no work at all
  (``metrics.MUTATIONS`` frozen).
- ``plan_shrink``, ``plan_grow``, ``_shrunk_placements``,
  ``mesh_for_plan``, ``stage_rank_map`` and ``Replanner``'s tuner tier and
  dp fallback equal the reference's results on the reference's cases;
  ``check_reshard`` and ``check_pipeline_schedule`` give the reference's
  diagnostics (checkers, severities, count) on the same plans.
- ``AdaptiveTrainer``: member leave / join / rank death re-plan (the
  survivors' mesh has no tensors on it here: one process holds whole
  values), a failed re-plan or grow does not consume its epoch, the
  ``MESH_EPOCH`` re-key makes the window build its runners once more,
  preemption checkpoints, the checkpoint interval, the checkpoint fallback
  past a corrupted generation and restores into a fresh trainer from a
  checkpoint and from the growth broadcast; ``Replanner(program_view=...)``
  raises. The state broadcast round-trips through the port's TCPStore
  (and the reference's ``receive_state`` reads it) and refuses a flipped
  byte.
- A one-rank gloo world formed by ``rebuild_world`` with ``pg::init``
  failing once: the bring-up policy retries, and the world's collectives
  run.

Tolerances: bit-equality where both runs are the port's; 1e-5 relative
on losses where one run is the reference's.
"""
import contextlib
import json
import os
import time

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.distributed as rdist
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as D
import paddle_tpu_torch.nn.functional as F
from paddle_tpu.analysis import hooks as rhooks
from paddle_tpu.distributed.resilience import elastic as relastic
from paddle_tpu.distributed.resilience import adaptive as radaptive
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import flags as pt_flags
from paddle_tpu_torch._core import lazy
from paddle_tpu_torch.analysis import hooks
from paddle_tpu_torch.analysis.diagnostics import StaticCheckError
from paddle_tpu_torch.analysis.distributed_checks import (
    check_compiled_pipeline, check_pipeline_schedule, check_reshard)
from paddle_tpu_torch.base.core import EnforceNotMet
from paddle_tpu_torch.distributed.resilience import (
    AdaptiveTrainer, ElasticStep, MembershipEvent, RankDeath, Replanner,
    TransientFault, elastic, faults, growth, mesh_for_plan, plan_grow,
    plan_shrink, retry, shrink_world, stage_rank_map)
from paddle_tpu_torch.distributed.resilience.faults import ResourceExhausted
from paddle_tpu_torch.observability import metrics
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


def _counter(name):
    return metrics.counter(name).value


# ------------------------------------------------------------- models

def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, (8,)).astype(np.int64))


_WEIGHTS = {}


def _weights():
    """LeNet's weights from the port's seed 0, as numpy: the one set both
    packages train from."""
    if not _WEIGHTS:
        pt.seed(0)
        _WEIGHTS.update({k: v.numpy().copy()
                         for k, v in LeNet().state_dict().items()})
    return _WEIGHTS


_REF_LOSSES = []


def _ref_losses():
    """The reference's fault-free LeNet run (5 Adam steps), cached."""
    if not _REF_LOSSES:
        model = ref.vision.models.LeNet()
        model.set_state_dict(_weights())
        opt = ref.optimizer.Adam(1e-3, parameters=model.parameters())
        x, y = _data()
        xt, yt = ref.to_tensor(x), ref.to_tensor(y)
        for _ in range(5):
            loss = RF.cross_entropy(model(xt), yt)
            loss.backward()
            opt.step()
            opt.clear_grad()
            _REF_LOSSES.append(float(loss))
    return list(_REF_LOSSES)


def _lenet(guard=False):
    """The port's LeNet, Adam and a step function."""
    pt.seed(0)
    model = LeNet()
    model.set_state_dict(_weights())
    opt = pt.optimizer.Adam(1e-3, parameters=model.parameters())
    x, y = (pt.to_tensor(a) for a in _data())

    def step():
        with (lazy.lazy_guard() if guard else contextlib.nullcontext()):
            loss = F.cross_entropy(model(x), y)
            loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    return model, opt, step


def _params(model):
    return [p.numpy().copy() for p in model.parameters()]


def _train(n, spec="", on_rank_death=None, guard=False, **kw):
    model, opt, step = _lenet(guard)
    el = ElasticStep(optimizer=opt, on_rank_death=on_rank_death, **kw)
    with flag("FLAGS_fault_inject", spec):
        losses = [el.run(step) for _ in range(n)]
    el.shutdown()
    return losses, _params(model), el


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def test_port_plain_run_matches_reference():
    losses, _, _ = _train(5)
    np.testing.assert_allclose(losses, _ref_losses(), rtol=RTOL)


# ------------------------------------------------- rollback (elastic)

def test_step_rollback_bit_exact():
    """A transient step fault and a stuck step, rolled back and re-run,
    leave the losses and parameters bit-equal to the fault-free run."""
    ref_losses, ref_params, _ = _train(4)
    before = _counter("resilience.rollbacks")
    losses, params, el = _train(4, "step::2=fail;step::3=stuck(0.01)")
    assert losses == ref_losses and _equal(params, ref_params)
    assert _counter("resilience.rollbacks") == before + 2
    assert el.last_recovery_s is not None and el.last_recovery_s >= 0
    assert el.last_snapshot_bytes == 3 * sum(p.nbytes for p in params)


def test_step_rollback_keeps_payloads_in_place():
    """A restore copies into the live payloads: every parameter's and
    optimizer state's data_ptr is the one before the failed step."""
    model, opt, step = _lenet()
    el = ElasticStep(optimizer=opt)
    el.run(step)
    ptrs = [p._t.data_ptr() for p in model.parameters()] + [
        v.data_ptr() for st in opt._states.values() for v in st.values()]
    with flag("FLAGS_fault_inject", "step::2=fail"):
        el.run(step)
    assert ptrs == [p._t.data_ptr() for p in model.parameters()] + [
        v.data_ptr() for st in opt._states.values() for v in st.values()]


def test_step_rollback_exhausts_budget():
    before = _counter("resilience.gave_up")
    with pytest.raises(TransientFault):
        _train(2, "step::1@*=fail", max_retries=2)
    assert _counter("resilience.gave_up") == before + 1


def test_segment_compile_fault_rolls_back():
    """A transient build failure at ``segment::compile`` inside the fused
    step (under ``lazy_guard()``) is absorbed by the rollback."""
    want_losses, want_params, _ = _train(3, guard=True)
    lazy.clear_segment_cache()
    fired = _counter("resilience.faults.fail")
    losses, params, _ = _train(3, "segment::compile=fail", guard=True)
    assert _counter("resilience.faults.fail") == fired + 1
    assert losses == want_losses and _equal(params, want_params)


def test_exec_oom_site_is_not_rolled_back(tmp_path):
    """``exec::oom`` raises the synthetic out-of-memory error before a
    runner executes; the execute site turns it into the typed
    ``ResourceExhaustedError`` (with its postmortem), which is not a
    transient fault, so the step fails."""
    from paddle_tpu_torch.base.core import ResourceExhaustedError
    with flag("FLAGS_flight_recorder_dir", str(tmp_path)):
        with pytest.raises(ResourceExhaustedError) as ei:
            _train(1, "exec::oom=oom", guard=True)
    assert isinstance(ei.value.__cause__, ResourceExhausted)


def test_rank_death_without_handler_propagates():
    with pytest.raises(RankDeath):
        _train(2, "step::1=die")


def test_rank_death_budget_bounds_recovery_loop():
    calls = []
    before = _counter("resilience.gave_up")
    with pytest.raises(RankDeath):
        _train(2, "step::1@*=die", on_rank_death=lambda e: calls.append(1),
               max_retries=2)
    assert len(calls) == 2, "handler ran once per budgeted attempt"
    assert _counter("resilience.gave_up") == before + 1


def test_rank_death_world_shrink_continues_training():
    """A death at step 2 restores the snapshot, shrinks an 8-process mesh
    to 6 (validated by the sweep, with the shrunk 1F1B schedule) and
    re-runs; training goes on as the fault-free run, the reference's."""
    mesh = D.auto_mesh(8, dim_names=["dp"])
    D.set_mesh(mesh)
    try:
        shrunk = {}
        model, opt, step = _lenet()

        def on_rank_death(e):
            state = {p.name or str(i): p
                     for i, p in enumerate(model.parameters())}
            shrunk["mesh"] = shrink_world(mesh, [6, 7], state,
                                          optimizer=opt,
                                          pipeline=("1F1B", 4))

        el = ElasticStep(optimizer=opt, on_rank_death=on_rank_death)
        sweeps = _counter("sanitizer.shrink_sweeps")
        with flag("FLAGS_fault_inject", "step::2=die"):
            losses = [el.run(step) for _ in range(5)]
        assert shrunk["mesh"].size == 6 and D.get_mesh() is shrunk["mesh"]
        assert shrunk["mesh"].process_ids == [0, 1, 2, 3, 4, 5]
        assert _counter("sanitizer.shrink_sweeps") == sweeps + 1
        np.testing.assert_allclose(losses, _ref_losses(), rtol=RTOL)
    finally:
        D.set_mesh(None)


def test_watchdog_counts_each_firing():
    before = _counter("resilience.watchdog_fired")
    mgr = D.CommTaskManager(check_interval=0.02, on_timeout=lambda t: None)
    try:
        mgr.register("stuck_op", timeout=0.05)
        deadline = time.time() + 5
        while not mgr.timed_out("stuck_op") and time.time() < deadline:
            time.sleep(0.01)
        assert mgr.timed_out("stuck_op")
        assert _counter("resilience.watchdog_fired") == before + 1
    finally:
        mgr.shutdown()


# ----------------------------------------------- retry and the sites

def test_comm_site_retried_and_torch_errors_are_not():
    """``comm::<name>`` fires before the call inside the comm policy (an
    injected transient is retried past); what the call itself raises
    reaches the caller unretried, even a retryable class."""
    from paddle_tpu_torch.distributed.communication import _resilient
    calls = []
    before = _counter("resilience.retries")
    with flag("FLAGS_retry_backoff_s", 0.0), \
            flag("FLAGS_fault_inject", "comm::x=fail"):
        assert _resilient("x", lambda: calls.append(1) or 7) == 7
    assert len(calls) == 1 and _counter("resilience.retries") == before + 1

    def timed_out():
        calls.append(1)
        raise TimeoutError("inside the collective")

    calls.clear()
    with pytest.raises(TimeoutError):
        _resilient("x", timed_out)
    assert len(calls) == 1


def test_store_native_failure_class_is_retryable():
    from paddle_tpu_torch.distributed.store import StoreOpError
    assert StoreOpError is retry.StoreOpError
    assert retry.store_policy()._is_retryable(StoreOpError("x"))
    assert retry.bringup_policy()._is_retryable(StoreOpError("x"))
    assert not retry.store_policy()._is_retryable(RuntimeError("x"))
    assert not retry.comm_policy()._is_retryable(StoreOpError("x"))


def _local_store(**kw):
    return D.TCPStore("127.0.0.1", 0, is_master=True, world_size=1,
                      timeout=10, **kw)


@contextlib.contextmanager
def _managed_store():
    """A local store and a list for the ElasticManagers made on it: each
    is shut down (its threads joined) before the store closes."""
    store, made = _local_store(), []
    try:
        yield store, made
    finally:
        for m in made:
            m.shutdown()
        store.close()


def test_store_sites():
    """``store::get`` is retried past one failure; ``try_get`` is never a
    site (it answers under ``store::get@*=fail``) and None for a missing
    key; ``add`` fires its site and is not retried."""
    store = _local_store()
    try:
        store.set("k", "v")
        before = _counter("resilience.retries")
        with flag("FLAGS_retry_backoff_s", 0.0):
            with flag("FLAGS_fault_inject", "store::get=fail"):
                assert store.get("k") == b"v"
            assert _counter("resilience.retries") == before + 1
            with flag("FLAGS_fault_inject", "store::get@*=fail"):
                assert store.try_get("k") == b"v"
                assert store.try_get("missing", timeout=0.05) is None
            with flag("FLAGS_fault_inject", "store::add=fail"):
                with pytest.raises(TransientFault):
                    store.add("n", 1)
            assert store.add("n", 1) == 1
            with flag("FLAGS_fault_inject", "store::set=fail;"
                                            "store::wait=fail"):
                store.set("w", "1")
                store.wait("w", 1.0)
            assert _counter("resilience.retries") == before + 3
    finally:
        store.close()


def test_store_barrier_rounds_bounded():
    store = _local_store()
    try:
        wrap = store._BARRIER_ROUND_WRAP
        store._barrier_rounds["b"] = wrap - 2
        for _ in range(4):
            store.barrier("b", timeout=5)
        assert 0 <= store._barrier_rounds["b"] < wrap
    finally:
        store.close()


def test_faults_off_zero_registry_work():
    """With ``FLAGS_fault_inject`` off the gate is False and the registry
    does no work across a lazy chain, an elastic step and store
    traffic."""
    assert not pt_flags.FAULT_INJECT_ACTIVE and not faults.ACTIVE
    before = metrics.MUTATIONS
    with lazy.lazy_guard():
        y = pt.to_tensor(np.ones((8, 8), np.float32))
        for _ in range(16):
            y = y * 1.0001 + 0.0001
    y.numpy()
    _train(1)
    store = _local_store()
    try:
        store.set("k", "v")
        store.get("k")
    finally:
        store.close()
    assert metrics.MUTATIONS == before


def test_fault_gate_follows_flag():
    with flag("FLAGS_fault_inject", "step::1=fail"):
        assert pt_flags.FAULT_INJECT_ACTIVE and faults.ACTIVE
    assert not pt_flags.FAULT_INJECT_ACTIVE and not faults.ACTIVE


def test_rebuilt_one_rank_world_retries_bring_up():
    """``rebuild_world`` forms a one-rank gloo world on the job store's
    rendezvous with ``pg::init`` failing once: the bring-up policy
    retries, the world's collectives run, and a second epoch forms it
    again."""
    from paddle_tpu_torch.distributed import parallel_env
    store = _local_store()
    try:
        before = _counter("resilience.retries")
        with flag("FLAGS_retry_backoff_s", 0.0), \
                flag("FLAGS_fault_inject", "pg::init@1=fail"):
            D.rebuild_world([5], 1, store=store, device="cpu", pid=5)
        assert _counter("resilience.retries") == before + 1
        assert parallel_env.process_id() == 5 and parallel_env.rank_of(5) == 0
        t = pt.to_tensor(np.arange(4, dtype=np.float32))
        D.all_reduce(t)
        mesh = D.ProcessMesh([5], dim_names=["dp"])
        assert mesh.coords() == {"dp": 0}
        D.rebuild_world([5], 2, store=store)
        assert D.get_world_size() == 1 and parallel_env.world_process_ids() \
            == [5]
    finally:
        D.destroy_process_group()
        store.close()
    assert parallel_env.process_id() == 0


# ------------------------------------------------ planning, by cases

MESHES = [((8,), ["dp"]), ((4, 2), ["dp", "mp"]), ((2, 2, 2),
                                                   ["dp", "pp", "mp"])]


def _both_meshes(shape, names, ids=None):
    ids = np.arange(int(np.prod(shape))) if ids is None else np.asarray(ids)
    return (rdist.ProcessMesh(ids.reshape(shape), dim_names=names),
            D.ProcessMesh(ids.reshape(shape), dim_names=names))


def _same_mesh(a, b):
    assert a.shape == b.shape and a.dim_names == b.dim_names
    assert [int(x) for x in a.process_ids] == list(b.process_ids)


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("lost", [[7], [6, 7], [0], [1, 2, 5]])
def test_plan_shrink_matches_reference(shape, names, lost):
    r, p = _both_meshes(shape, names)
    _same_mesh(relastic.plan_shrink(r, lost), plan_shrink(p, lost))


@pytest.mark.parametrize("shape,names", MESHES[:2])
@pytest.mark.parametrize("joined", [[8], [8, 9], [8, 9, 10, 11]])
def test_plan_grow_matches_reference(shape, names, joined):
    r, p = _both_meshes(shape, names)
    _same_mesh(relastic.plan_grow(r, joined), plan_grow(p, joined))


def test_plan_errors():
    _, p = _both_meshes((2,), ["dp"])
    with pytest.raises(EnforceNotMet):
        plan_shrink(p, [0, 1])
    with pytest.raises(EnforceNotMet, match="already"):
        plan_grow(p, [1, 2])
    with pytest.raises(EnforceNotMet, match="empty"):
        plan_grow(p, [])
    with pytest.raises(EnforceNotMet):
        shrink_world(p, [0, 1], {}, set_global=False)
    eight = D.auto_mesh(8, dim_names=["dp"])
    wrong = D.ProcessMesh(list(range(5)), dim_names=["dp"])
    with pytest.raises(EnforceNotMet, match="survivors"):
        shrink_world(eight, [6, 7], {}, set_global=False, target_mesh=wrong)
    with pytest.raises(EnforceNotMet, match="cover"):
        elastic.grow_world(D.ProcessMesh(list(range(6)), dim_names=["dp"]),
                           [6, 7], {}, set_global=False,
                           target_mesh=D.ProcessMesh(list(range(7)),
                                                     dim_names=["dp"]))


PLACEMENT_CASES = [
    ("S0 R", (20, 8), (4, 2), 5), ("R S1", (8, 20), (4, 2), 5),
    ("S0 R", (21, 8), (4, 2), 5), ("S0 S1", (12, 6), (4, 2), 6),
    ("S0 R", (24, 8), (4, 2), 6), ("S1 R", (24, 9), (4, 2), 6),
    ("P R", (8, 8), (4, 2), 6)]


def _pl(pkg, spec):
    out = []
    for w in spec.split():
        out.append(pkg.Replicate() if w == "R" else pkg.Partial()
                   if w == "P" else pkg.Shard(int(w[1:])))
    return out


def _pl_words(pls):
    return [("S%d" % p.get_dim()) if p.is_shard() else
            ("P" if p.is_partial() else "R") for p in pls]


@pytest.mark.parametrize("spec,gshape,old_shape,n", PLACEMENT_CASES)
def test_shrunk_placements_match_reference(spec, gshape, old_shape, n):
    ro, po = _both_meshes(old_shape, ["dp", "mp"])
    rn = relastic.plan_shrink(ro, list(range(n, ro.size)))
    pn = plan_shrink(po, list(range(n, po.size)))
    want = relastic._shrunk_placements(_pl(rdist, spec), ro, rn, gshape)
    got = elastic._shrunk_placements(_pl(D, spec), po, pn, gshape)
    assert _pl_words(got) == _pl_words(want)


@pytest.mark.parametrize("n", [8, 7, 6, 5, 4, 3, 1])
def test_replanner_matches_reference(n):
    """The tuner tier with the hardware keys given (the two packages'
    defaults differ: the port's is the H100's) picks the reference's plan
    for each survivor count, and the plan's mesh and stage map are the
    reference's."""
    cfg = {"hidden_size": 1024, "num_layers": 8, "chip_flops": 197e12,
           "hbm_bytes": 16e9, "ici_bandwidth": 4.5e10, "mfu": 0.4}
    want = radaptive.Replanner(dict(cfg)).replan(n)
    got = Replanner(dict(cfg)).replan(n)
    keys = ("dp_degree", "mp_degree", "pp_degree")
    assert [got[k] for k in keys] == [want[k] for k in keys]
    ids = list(range(0, 2 * n, 2))
    rm, pm = radaptive.mesh_for_plan(ids, want), mesh_for_plan(ids, got)
    _same_mesh(rm, pm)
    assert radaptive.stage_rank_map(rm) == stage_rank_map(pm)


def test_replanner_default_hardware_tiles_and_falls_back():
    r = Replanner({"hidden_size": 1024, "num_layers": 8})
    for n in (6, 7, 5, 4, 3, 1):
        plan = r.replan(n)
        assert plan["dp_degree"] * plan["mp_degree"] \
            * plan["pp_degree"] == n
        assert mesh_for_plan(list(range(n)), plan).size == n
    before = _counter("resilience.replan_fallback_plans")
    with pytest.warns(RuntimeWarning, match="falling back to dp=7"):
        plan = Replanner({"hidden_size": 1024,
                          "global_batch_size": 5}).replan(7)
    want = radaptive.Replanner({"hidden_size": 1024,
                                "global_batch_size": 5})
    with pytest.warns(RuntimeWarning):
        want = want.replan(7)
    assert plan == want
    assert _counter("resilience.replan_fallback_plans") == before + 1
    with pytest.raises(EnforceNotMet):
        mesh_for_plan([0, 1, 2], {"dp_degree": 2})


def test_replanner_program_view_raises():
    with pytest.raises(NotImplementedError, match="item 9"):
        Replanner({}, program_view=object())
    model, opt, _ = _lenet()
    with pytest.raises(NotImplementedError):
        AdaptiveTrainer(optimizer=opt, program_view=object())


# ----------------------------------------- the sanitizer's sweep, by cases

def _report_key(rep):
    return sorted((d.checker, d.severity) for d in rep.diagnostics)


def _bad_plans(pkg, attr_cls):
    mesh = pkg.ProcessMesh(np.arange(4), dim_names=["dp"])
    two = pkg.ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])
    twin = pkg.ProcessMesh(np.arange(4), dim_names=["dp"])
    R, S, P = pkg.Replicate, pkg.Shard, pkg.Partial
    return [
        (2, attr_cls(mesh, [R()]), attr_cls(mesh, [R(), R()]), (4, 4)),
        (2, attr_cls(mesh, [R()]), attr_cls(mesh, [S(3)]), (4, 4)),
        (2, attr_cls(mesh, [R()]), attr_cls(mesh, [S(0)]), (6, 4)),
        (2, attr_cls(mesh, [R()]), attr_cls(twin, [R()]), (4, 4)),
        (3, attr_cls(mesh, [P()]), attr_cls(mesh, [R()]), (4, 4)),
        (2, attr_cls(two, [S(0), S(1)]), attr_cls(mesh, [S(0)]), (8, 8)),
        (2, attr_cls(mesh, [S(1)]), attr_cls(two, [R(), S(1)]), (4, 6)),
    ]


def test_check_reshard_matches_reference():
    from paddle_tpu.analysis.diagnostics import CheckReport as RReport
    from paddle_tpu.analysis.distributed_checks import \
        check_reshard as rcheck
    from paddle_tpu.distributed.api import DistAttr as RAttr
    from paddle_tpu_torch.analysis.diagnostics import CheckReport
    from paddle_tpu_torch.distributed.api import DistAttr
    for rcase, pcase in zip(_bad_plans(rdist, RAttr), _bad_plans(D, DistAttr)):
        want, got = RReport(), CheckReport()
        rcheck(*rcase[:3], want, global_shape=rcase[3])
        check_reshard(*pcase[:3], got, global_shape=pcase[3])
        assert _report_key(got) == _report_key(want), (pcase, got.render())


SCHEDULES = [("1F1B", 4, 8, 1), ("FThenB", 3, 5, 1), ("VPP", 2, 4, 2),
             ("VPP", 4, 8, 2), ("ZeroBubble", 4, 8, 1), ("1F1B", 2, 1, 1),
             ("NoSuchSchedule", 2, 4, 1)]


@pytest.mark.parametrize("schedule,pp,micro,chunks", SCHEDULES)
def test_check_pipeline_schedule_matches_reference(schedule, pp, micro,
                                                   chunks):
    from paddle_tpu.analysis.distributed_checks import \
        check_pipeline_schedule as rcheck
    want = rcheck(schedule, pp, micro, chunks)
    got = check_pipeline_schedule(schedule, pp, micro, chunks)
    assert _report_key(got) == _report_key(want)
    assert len(got.diagnostics) == len(want.diagnostics)


@pytest.mark.parametrize("kind,pp,micro", [("stream", 4, 8), ("1f1b", 4, 8),
                                           ("1f1b", 2, 3), ("other", 2, 2)])
def test_check_compiled_pipeline_matches_reference(kind, pp, micro):
    from paddle_tpu.analysis.distributed_checks import \
        check_compiled_pipeline as rcheck
    assert _report_key(check_compiled_pipeline(kind, pp, micro)) \
        == _report_key(rcheck(kind, pp, micro))


def test_world_shrink_sweep_refuses_bad_plans():
    """The sweep raises in error mode whatever the flags say: a placement
    rank that does not match the mesh, a rejected schedule; both count
    the sweep, as the reference's."""
    from paddle_tpu_torch.distributed.api import DistAttr
    mesh = D.auto_mesh(4, dim_names=["dp"])
    before = _counter("sanitizer.shrink_sweeps")
    with pytest.raises(StaticCheckError):
        hooks.on_world_shrink([(2, DistAttr(mesh, [D.Replicate()]),
                                DistAttr(mesh, [D.Replicate()] * 2),
                                (4, 4))])
    with pytest.raises(StaticCheckError):
        hooks.on_world_shrink([], ("NoSuchSchedule", 2, 4, 1))
    assert hooks.on_world_shrink([], ("1F1B", 2, 4, 1)).ok
    assert _counter("sanitizer.shrink_sweeps") == before + 3
    rmesh = rdist.auto_mesh(4, dim_names=["dp"])
    from paddle_tpu.analysis.diagnostics import StaticCheckError as RErr
    from paddle_tpu.distributed.api import DistAttr as RAttr
    with pytest.raises(RErr):
        rhooks.on_world_shrink([(2, RAttr(rmesh, [rdist.Replicate()]),
                                 RAttr(rmesh, [rdist.Replicate()] * 2),
                                 (4, 4))])


# ------------------------------------------------ adaptive re-planning

def _adaptive(mesh=None, guard=False, **kw):
    model, opt, step = _lenet(guard)
    return AdaptiveTrainer(optimizer=opt, mesh=mesh, **kw), step, model


def test_member_leave_replans_and_rekeys_the_window():
    """An injected ``member::leave`` on an 8-process mesh re-plans for 6
    survivors (the tuner's plan, validated by the sweep), bumps
    ``MESH_EPOCH`` so the window builds its runners once more, and the
    losses stay the fault-free run's, the reference's."""
    mesh = D.auto_mesh(8, dim_names=["dp"])
    D.set_mesh(mesh)
    try:
        trainer, step, _ = _adaptive(mesh, guard=True, lost_ranks=[6, 7])
        sweeps = _counter("sanitizer.shrink_sweeps")
        epochs = _counter("resilience.member_epochs")
        losses = [trainer.run(step), trainer.run(step)]
        epoch, misses = lazy.MESH_EPOCH, lazy._FUSED_CACHE.misses
        losses.append(trainer.run(step))
        assert lazy._FUSED_CACHE.misses == misses   # warm: a hit
        with flag("FLAGS_fault_inject", "member::leave@1=die"):
            losses.append(trainer.run(step))
        assert lazy.MESH_EPOCH == epoch + 1
        assert lazy._FUSED_CACHE.misses == misses + 1  # built once more
        losses.append(trainer.run(step))
        assert lazy._FUSED_CACHE.misses == misses + 1  # and hit after
        np.testing.assert_allclose(losses, _ref_losses(), rtol=RTOL)
        assert trainer.replans == 1 and trainer.mesh.size == 6
        assert D.get_mesh() is trainer.mesh
        plan = trainer.last_plan
        assert plan["dp_degree"] * plan["mp_degree"] * plan["pp_degree"] \
            == 6
        assert sorted(sum(trainer.last_stage_map.values(), [])) \
            == list(range(6))
        assert _counter("sanitizer.shrink_sweeps") == sweeps + 1
        assert _counter("resilience.member_epochs") == epochs + 1
        assert trainer.last_replan_latency_s > 0
        trainer.shutdown()
    finally:
        D.set_mesh(None)


def test_rank_death_routes_through_replan():
    mesh = D.auto_mesh(8, dim_names=["dp"])
    trainer, step, _ = _adaptive(mesh, lost_ranks=[7])
    with flag("FLAGS_fault_inject", "step::2=die"):
        losses = [trainer.run(step) for _ in range(4)]
    np.testing.assert_allclose(losses, _ref_losses()[:4], rtol=RTOL)
    assert trainer.replans == 1 and trainer.mesh.size == 7
    assert trainer.last_event.source == "rank_death"
    trainer.shutdown()


def test_member_join_counted_but_no_replan_without_ranks():
    trainer, step, _ = _adaptive()
    epochs = _counter("resilience.member_epochs")
    replans = _counter("resilience.replans")
    with flag("FLAGS_fault_inject", "member::join@2=fail"):
        losses = [trainer.run(step) for _ in range(3)]
    assert len(losses) == 3 and trainer.replans == 0
    assert _counter("resilience.member_epochs") == epochs + 1
    assert _counter("resilience.replans") == replans
    trainer.shutdown()


def test_member_join_grows():
    mesh = D.auto_mesh(6, dim_names=["dp"])
    D.set_mesh(mesh)
    try:
        trainer, step, _ = _adaptive(mesh, joined_ranks=[6, 7])
        grows = _counter("resilience.grows")
        world_grows = _counter("resilience.world_grows")
        with flag("FLAGS_fault_inject", "member::join@2=die"):
            losses = [trainer.run(step) for _ in range(4)]
        np.testing.assert_allclose(losses, _ref_losses()[:4], rtol=RTOL)
        assert trainer.grows == 1 and trainer.replans == 0
        assert trainer.mesh.size == 8 and D.get_mesh() is trainer.mesh
        assert _counter("resilience.grows") == grows + 1
        assert _counter("resilience.world_grows") == world_grows + 1
        assert trainer.last_grow_latency_s > 0
        trainer.shutdown()
    finally:
        D.set_mesh(None)


def test_rank_death_without_lost_resolution_propagates():
    trainer, step, _ = _adaptive()
    with flag("FLAGS_fault_inject", "member::leave@1=die"):
        with pytest.raises(RankDeath):
            trainer.run(step)
    trainer.shutdown()


def test_failed_replan_and_grow_do_not_consume_epoch(monkeypatch):
    from paddle_tpu_torch.distributed.resilience import adaptive
    mesh = D.auto_mesh(8, dim_names=["dp"])
    trainer, _, _ = _adaptive(mesh)
    with pytest.raises(EnforceNotMet, match="nothing to\\s+re-plan"):
        trainer._membership_event(MembershipEvent(
            5, [], lost=list(range(8)), source="manager"))
    assert trainer._last_epoch == 0 and trainer.replans == 0
    trainer._membership_event(MembershipEvent(
        5, [str(r) for r in range(6)], lost=[6, 7], source="manager"))
    assert trainer._last_epoch == 5 and trainer.mesh.size == 6

    def boom(*a, **kw):
        raise RuntimeError("reshard died mid-growth")

    monkeypatch.setattr(adaptive, "grow_world", boom)
    ev = MembershipEvent(7, [str(r) for r in range(8)], joined=[6, 7])
    with pytest.raises(RuntimeError, match="mid-growth"):
        trainer._membership_event(ev)
    assert trainer._last_epoch == 5 and trainer.grows == 0
    assert trainer._latency_hist == "resilience.replan_us"
    monkeypatch.undo()
    trainer._membership_event(ev)
    assert trainer._last_epoch == 7 and trainer.grows == 1
    assert trainer.mesh.size == 8
    trainer.shutdown()


def test_manager_epoch_drives_replan():
    """A real ElasticManager epoch (store heartbeats) drives the re-plan:
    node 7 stops heartbeating, the master publishes the survivors, and
    the trainer's boundary poll picks it up."""
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    with _managed_store() as (store, made):
        dead = ElasticManager("7", store, heartbeat_interval=0.05,
                              node_timeout=0.6)
        mgr = ElasticManager("0", store, heartbeat_interval=0.05,
                             node_timeout=0.6)
        made += [dead, mgr]
        dead.register()
        mgr.register()
        mgr.watch(["0", "7"])
        m = mgr.wait_for_members(
            lambda m: set(m["members"]) == {"0", "7"}, timeout=10)
        assert set(m["members"]) == {"0", "7"}
        trainer, step, _ = _adaptive(D.auto_mesh(8, dim_names=["dp"]),
                                     manager=mgr)
        trainer.run(step)
        assert trainer.replans == 0
        dead.shutdown()
        m = mgr.wait_for_members(lambda m: "7" not in m["members"],
                                 timeout=10)
        assert "7" not in m["members"]
        trainer.run(step)
        assert trainer.replans == 1 and trainer.mesh.size == 7
        assert trainer.last_event.source == "manager"
        assert trainer.last_event.lost == [7]
        trainer.shutdown()


# ------------------------------------------- checkpoints and growth

def test_restore_into_fresh_trainer_recovers_optimizer_state(tmp_path):
    root = str(tmp_path / "ck")
    trainer, step, _ = _adaptive(checkpoint_dir=root, checkpoint_every=1)
    want = [trainer.run(step) for _ in range(5)]
    trainer.shutdown()
    fresh, fresh_step, _ = _adaptive(checkpoint_dir=root)
    assert fresh.restore_from_checkpoint(generation=3) == 3
    assert fresh.step_index == 3
    assert [fresh.run(fresh_step) for _ in range(2)] == want[3:]
    np.testing.assert_allclose(want, _ref_losses(), rtol=RTOL)
    fresh.shutdown()


def test_checkpoint_manager_fallback_counts(tmp_path):
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    root = str(tmp_path / "gens")
    mgr = CheckpointManager(root, keep=3)
    for i in range(3):
        mgr.save({"w": pt.to_tensor(np.full((2, 2), float(i), np.float32))},
                 step=i)
    p = os.path.join(root, "gen_00000003", "data_rank0.pkl")
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    before = _counter("resilience.ckpt_fallbacks")
    target = {"w": pt.to_tensor(np.zeros((2, 2), np.float32))}
    assert mgr.load(target) == 2
    assert _counter("resilience.ckpt_fallbacks") == before + 1


def test_adaptive_falls_back_to_checkpoint_when_rollback_exhausted(
        tmp_path):
    """Two failures against a budget of 1 exhaust the in-memory rollback;
    the newest verified generation (the latest is corrupted, so the one
    before) is reloaded and the steps since replay bit for bit."""
    trainer, step, _ = _adaptive(checkpoint_dir=str(tmp_path / "ck"),
                                 checkpoint_every=1, max_retries=1)
    losses = [trainer.run(step) for _ in range(3)]
    assert trainer.ckpt.generations() == [1, 2, 3]
    p = os.path.join(str(tmp_path / "ck"), "gen_00000003",
                     "data_rank0.pkl")
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    fallbacks = _counter("resilience.ckpt_fallbacks")
    restores = _counter("resilience.ckpt_restores")
    gave_up = _counter("resilience.gave_up")
    with flag("FLAGS_fault_inject", "step::4@1=fail;step::4@2=fail"):
        losses.append(trainer.run(step))
    losses.append(trainer.run(step))
    assert _counter("resilience.gave_up") == gave_up + 1
    assert _counter("resilience.ckpt_restores") == restores + 1
    assert _counter("resilience.ckpt_fallbacks") == fallbacks + 1
    plain, _, _ = _train(4)
    assert losses[:3] == plain[:3] and losses[3:] == plain[2:4]
    trainer.shutdown()


def test_preempt_notice_checkpoints_immediately(tmp_path):
    trainer, step, _ = _adaptive(checkpoint_dir=str(tmp_path / "ck"))
    notices = _counter("resilience.preempt_notices")
    pckpts = _counter("resilience.preempt_ckpts")
    with flag("FLAGS_fault_inject", "preempt::notice@3=fail"):
        losses = [trainer.run(step) for _ in range(4)]
    assert _counter("resilience.preempt_notices") == notices + 1
    assert _counter("resilience.preempt_ckpts") == pckpts + 1
    assert trainer.preempt_checkpoints == 1
    assert trainer.ckpt.generations() == [1]   # the post-step-2 state
    trainer.shutdown()
    fresh, fresh_step, _ = _adaptive(checkpoint_dir=str(tmp_path / "ck"))
    fresh.restore_from_checkpoint()
    assert fresh.step_index == 2
    assert [fresh.run(fresh_step) for _ in range(2)] == losses[2:4]
    fresh.shutdown()


def test_manager_preemption_announcement_drives_checkpoint(tmp_path):
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    with _managed_store() as (store, made):
        mgr = ElasticManager("0", store, heartbeat_interval=0.05)
        other = ElasticManager("1", store, heartbeat_interval=0.05)
        made += [mgr, other]
        trainer, step, _ = _adaptive(manager=mgr,
                                     checkpoint_dir=str(tmp_path / "ck"))
        trainer.run(step)
        assert trainer.preempt_checkpoints == 0
        assert other.announce_preemption() == 1
        trainer.run(step)
        assert trainer.preempt_checkpoints == 1
        assert trainer.ckpt.generations() == [1]
        trainer.run(step)                # consumed exactly once
        assert trainer.preempt_checkpoints == 1
        assert mgr.poll_preemption() == []
        trainer.shutdown()


def test_checkpoint_interval_flag_cadence(tmp_path):
    trainer, step, _ = _adaptive(checkpoint_dir=str(tmp_path / "ck"))
    for _ in range(2):
        trainer.run(step)
    assert trainer.ckpt.generations() == []
    with flag("FLAGS_checkpoint_interval_steps", 2):
        for _ in range(4):
            trainer.run(step)
    manifest = json.load(open(os.path.join(str(tmp_path / "ck"),
                                           "MANIFEST.json")))
    assert [e["step"] for e in manifest["generations"]] == [4, 6]
    trainer.shutdown()


def test_grow_state_broadcast_roundtrip_and_corruption():
    """The chunked, checksummed publication round-trips through the
    port's TCPStore (and the reference's ``receive_state`` reads it, the
    same chunks); a flipped byte in a chunk is refused before unpickling
    with ``StoreOpError``, counted; a missing epoch times out."""
    from paddle_tpu.distributed.resilience import growth as rgrowth
    store = _local_store()
    try:
        state = {"w": np.arange(4096, dtype=np.float32), "step": 17,
                 "lr": {"last_lr": 0.01}}
        with flag("FLAGS_elastic_grow_chunk_kb", 4):
            nchunks = growth.publish_state(store, state, epoch=3)
            assert nchunks > 1
            got = growth.receive_state(store, 3, timeout=5)
        np.testing.assert_array_equal(got["w"], state["w"])
        assert got["step"] == 17 and got["lr"] == {"last_lr": 0.01}
        theirs = rgrowth.receive_state(store, 3, timeout=5)
        np.testing.assert_array_equal(theirs["w"], state["w"])
        raw = store.get("__elastic/grow/3/chunk/1")
        store.set("__elastic/grow/3/chunk/1",
                  bytes([raw[0] ^ 0xFF]) + raw[1:])
        rejects = _counter("resilience.grow_bcast_rejects")
        with pytest.raises(retry.StoreOpError, match="checksum|unusable"):
            growth.receive_state(store, 3, timeout=5)
        assert _counter("resilience.grow_bcast_rejects") == rejects + 1
        with flag("FLAGS_retry_backoff_s", 0.0):
            with pytest.raises(retry.StoreOpError):
                growth.receive_state(store, 99, timeout=0.2)
    finally:
        store.close()


def test_restore_from_broadcast_into_fresh_trainer():
    trainer, step, _ = _adaptive()
    want = [trainer.run(step) for _ in range(5)]
    trainer.shutdown()
    trainer, step, _ = _adaptive()
    for _ in range(3):
        trainer.run(step)
    store = _local_store()
    try:
        growth.publish_state(store, trainer._host_state(), epoch=5)
        trainer.shutdown()
        fresh, fresh_step, _ = _adaptive()
        restores = _counter("resilience.bcast_restores")
        fresh.restore_from_broadcast(store, 5, timeout=5)
        assert _counter("resilience.bcast_restores") == restores + 1
        assert fresh.step_index == 3
        assert [fresh.run(fresh_step) for _ in range(2)] == want[3:]
        fresh.shutdown()
    finally:
        store.close()


def test_join_world_admits_an_announced_node():
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    with _managed_store() as (store, made):
        master = ElasticManager("0", store, heartbeat_interval=0.05)
        joiner = ElasticManager("1", store, heartbeat_interval=0.05)
        made += [master, joiner]
        master.register()
        master.watch(["0"])
        joins = _counter("resilience.grow_joins")
        m = D.join_world(joiner, min_members=2, timeout=10)
        assert m["members"] == ["0", "1"] and m["epoch"] >= 1
        assert _counter("resilience.grow_joins") == joins + 1
