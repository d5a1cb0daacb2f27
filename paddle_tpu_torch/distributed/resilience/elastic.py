"""Step rollback and the world's shrink and growth: the counterpart of
``paddle_tpu/distributed/resilience/elastic.py``.

``ElasticStep`` wraps one training step. Before the step it copies what
the step mutates (parameter payloads, optimizer states, master weights,
step count, LR scheduler state, the generators' states on the CPU and on
the card) and fires the ``step::<N>`` fault site; on a transient failure
(an injected fault, a stuck collective the watchdog timed out, a failed
segment build) it restores the copy and runs the step again, bit for bit
as an uninterrupted run would. The copy lives in buffers of its own that
are refilled each step and a restore copies them back into the payloads
in place (``torch._foreach_copy_`` both ways): every ``data_ptr`` stays where the
optimizer and the async flush expect it, and the copy stays intact for a
second retry.

``shrink_world`` is the reaction to confirmed rank loss and
``grow_world`` to a join. Each plans the new ``ProcessMesh``, has the
sanitizer's distributed checkers validate every transition (and the new
pipeline schedule) before anything moves, then moves the data. The
reference, one controller over every device, still holds each global
array after a loss and lays it out again over the survivors. Here each
rank is a process that holds its own pieces, and the processes of the
new membership form a new world (``parallel_env.rebuild_world``; a mesh
keeps its process ids, ``[0, 2, 3]`` after losing 1). Each block of each
new piece is then taken from a survivor that holds it under the old
layout, over the new world, point to point; a block that only lost ranks
held raises ``EnforceNotMet`` naming the tensor, before anything moves,
and a ``Partial`` value (whose piece is one contribution of a sum) is
refused the same way. The optimizer's states and master weights follow
their parameter. ``grow_world`` moves pieces between survivors only: a
joiner takes its state from the survivors' broadcast (``growth.py``), so
no move waits for a rank that has not received it yet.

Behind their gates, as in the reference: the goodput ledger's step
boundaries and recovery windows (``_OBS.GOODPUT``), the cross-rank
telemetry's step stamp and frame (``_OBS.DIST``), the live monitor's step
feed (``_OBS.MONITOR``) and the flight recorder's notes of failures,
rollbacks, shrinks and grows (``_OBS.FLIGHT``).
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..._core import flags as _flags
from ...observability import _state as _OBS
from ..watchdog import get_comm_task_manager
from .faults import RankDeath, TransientFault

# step failures the rollback path absorbs (RankDeath is handled
# separately: it needs a world-shrink, not a re-run)
_RETRYABLE_STEP = (TransientFault, TimeoutError, ConnectionError,
                   OSError)


def _same(a: Optional[torch.Tensor], b: torch.Tensor) -> bool:
    return a is not None and a.shape == b.shape and a.dtype == b.dtype \
        and a.device == b.device


def _foreach_copy(pairs) -> None:
    """``dst.copy_(src)`` for each (dst, src): one ``_foreach_copy_`` a
    device."""
    by_dev: Dict = {}
    for dst, src in pairs:
        dsts, srcs = by_dev.setdefault(dst.device, ([], []))
        dsts.append(dst)
        srcs.append(src)
    with torch.no_grad():
        for dsts, srcs in by_dev.values():
            torch._foreach_copy_(dsts, srcs)


def _refill(bufs: Dict, srcs: Dict) -> Dict:
    """Copies of ``srcs`` (key -> tensor) in buffers: ``bufs``' own where
    one of the same shape, dtype and device is there, new ones
    elsewhere."""
    out, pairs = {}, []
    for key, src in srcs.items():
        buf = bufs.get(key)
        if _same(buf, src):
            pairs.append((buf, src))
        else:
            buf = src.detach().clone()
        out[key] = buf
    _foreach_copy(pairs)
    return out


class ElasticStep:
    """Wrap a train step with snapshot/rollback + watchdog coverage.

    Usage::

        elastic = ElasticStep(optimizer=opt, timeout=30.0)
        for batch in loader:
            loss = elastic.run(train_one_step, batch)

    ``run`` fires the ``step::<N>`` fault site (N = 1-based step index),
    so ``FLAGS_fault_inject="step::3=fail"`` exercises the rollback path
    deterministically.
    """

    def __init__(self, optimizer=None, parameters: Sequence = None, *,
                 max_retries: Optional[int] = None,
                 timeout: Optional[float] = None,
                 watchdog=None, name: str = "train_step",
                 on_rank_death: Optional[Callable] = None):
        if optimizer is None and parameters is None:
            raise ValueError(
                "ElasticStep needs an optimizer and/or parameters to "
                "snapshot")
        self._opt = optimizer
        self._params = list(parameters) if parameters is not None else \
            list(optimizer._all_params())
        self._max_retries = max_retries
        self._timeout = timeout
        self._watchdog = watchdog
        self._task_name = f"elastic::{name}"
        self._registered = False
        self._on_rank_death = on_rank_death
        self._bufs: Dict = {}
        self.step_index = 0
        self.last_recovery_s: Optional[float] = None
        self.last_snapshot_bytes = 0

    # -------------------------------------------------------- snapshot
    def _snapshot(self) -> Dict:
        # the async flush pipeline must be empty before state is copied:
        # an in-flight segment could still be writing the very payloads
        # copied here, and a latched off-thread failure belongs to the
        # previous step (raised here, before this step's snapshot
        # pretends the world is healthy)
        from ..._core import async_flush
        async_flush.drain()
        srcs = {("p", i): p._t for i, p in enumerate(self._params)}
        snap: Dict = {}
        opt = self._opt
        if opt is not None:
            for pid, st in opt._states.items():
                for k, v in st.items():
                    srcs[("s", pid, k)] = v
            for pid, v in opt._master.items():
                srcs[("m", pid)] = v
            snap["opt_step"] = opt._step_count
            lr = opt._lr
            if hasattr(lr, "state_dict"):
                snap["lr_state"] = dict(lr.state_dict())
        self._bufs = snap["bufs"] = _refill(self._bufs, srcs)
        self.last_snapshot_bytes = sum(b.numel() * b.element_size()
                                       for b in self._bufs.values())
        from ..._core import random as _rng
        with _rng._LOCK:
            snap["rng"] = (_rng._seed, {dev: g.get_state() for dev, g in
                                        _rng._generators.items()})
        return snap

    def _restore(self, snap: Dict):
        """Put the snapshot back, by copies, so the snapshot itself stays
        intact for a second retry, and clear grads (a failed step may have
        half-accumulated them; the re-run's backward must start clean)."""
        # drain the failed step's in-flight flushes first: a worker job
        # finishing after the restore would overwrite rolled-back payloads
        # with the aborted step's results. Its errors are the failure
        # being handled: discarded, not raised.
        from ..._core import async_flush, lazy
        async_flush.drain(raise_latched=False)
        ctx = lazy.current_context()
        if ctx is not None and ctx.pending:
            # the aborted step's half-recorded trace dies with it
            ctx._reset_segment()
        bufs, pairs = snap["bufs"], []

        def back(live, buf):
            # into the live tensor where it still fits, else a copy
            if _same(live, buf):
                pairs.append((live, buf))
                return live
            return buf.clone()

        for i, p in enumerate(self._params):
            live = p._t
            val = back(live, bufs[("p", i)])
            if val is not live:
                p._t = val.requires_grad_(live.requires_grad)
            p.clear_grad()
        opt = self._opt
        if opt is not None:
            states: Dict = {}
            master: Dict = {}
            for key, buf in bufs.items():
                if key[0] == "s":
                    _, pid, k = key
                    live = (opt._states.get(pid) or {}).get(k)
                    states.setdefault(pid, {})[k] = back(live, buf)
                elif key[0] == "m":
                    master[key[1]] = back(opt._master.get(key[1]), buf)
            opt._states = states
            opt._master = master
            opt._step_count = snap["opt_step"]
            if "lr_state" in snap:
                opt._lr.set_state_dict(dict(snap["lr_state"]))
        _foreach_copy(pairs)
        from ..._core import random as _rng
        seed, gens = snap["rng"]
        with _rng._LOCK:
            _rng._seed = seed
            for dev in list(_rng._generators):
                if dev in gens:
                    _rng._generators[dev].set_state(gens[dev])
                else:   # made during the failed step: made again on use
                    del _rng._generators[dev]

    # -------------------------------------------------------- watchdog
    def _heartbeat(self):
        if self._timeout is None:
            return
        if self._watchdog is None:
            self._watchdog = get_comm_task_manager()
        if not self._registered:
            self._watchdog.register(self._task_name, timeout=self._timeout)
            self._registered = True
        else:
            self._watchdog.heartbeat(self._task_name)

    def _check_watchdog(self):
        """Raise in this (waiting) thread if the watchdog declared the
        step stuck while it ran."""
        if self._registered:
            self._watchdog.check(self._task_name)

    def shutdown(self):
        if self._registered:
            self._watchdog.deregister(self._task_name)
            self._registered = False

    # ------------------------------------------------------------- run
    def run(self, step_fn: Callable, *args, **kw):
        self.step_index += 1
        site = f"step::{self.step_index}"
        budget = self._max_retries if self._max_retries is not None \
            else int(_flags.flag_value("FLAGS_elastic_max_retries"))
        snap = self._snapshot()
        self._heartbeat()
        attempt = 0
        deaths = 0
        detect_t: Optional[float] = None
        # the goodput ledger's step boundary and recovery window: off =
        # one module-attribute read. The window opens at the first failure
        # of this step and closes with the recovery_us observation, so the
        # ledger's recovery bucket and the histogram measure the same wall.
        _goodput = None
        if _OBS.GOODPUT:
            from ...observability import goodput as _goodput
            _goodput.step_begin(self.step_index)
        recovering = False
        try:
            while True:
                try:
                    if _flags.FAULT_INJECT_ACTIVE:
                        from . import faults
                        faults.inject(site)
                    out = step_fn(*args, **kw)
                    self._check_watchdog()
                    if _OBS.DIST:
                        # cross-rank telemetry: stamp the step boundary
                        # and (per the interval flag) publish the frame
                        from ...observability import distributed as _dtel
                        _dtel.on_step(self.step_index)
                    if _OBS.MONITOR:
                        # the live monitor's steps/s ring and its armed
                        # deep capture (AdaptiveTrainer rides through an
                        # inner ElasticStep: one site covers both)
                        from ...observability import timeseries as _mon
                        _mon.on_step(self.step_index)
                    if detect_t is not None:
                        self.last_recovery_s = \
                            time.perf_counter() - detect_t
                        from ...observability import metrics
                        metrics.observe("resilience.recovery_us",
                                        self.last_recovery_s * 1e6)
                        if _goodput is not None and recovering:
                            _goodput.recovery_end()
                            recovering = False
                    if _goodput is not None:
                        _goodput.step_end(self.step_index)
                    return out
                except RankDeath as e:
                    detect_t = time.perf_counter()
                    if _goodput is not None and not recovering:
                        _goodput.recovery_begin()
                        recovering = True
                    deaths += 1
                    self._note_failure(site, e, kind="rank_death")
                    # bounded like the transient path: a death that recurs
                    # on every re-run (or a handler that fails to evict the
                    # dead rank) must not spin restore->shrink->re-run
                    if self._on_rank_death is None or deaths > budget:
                        if self._on_rank_death is not None:
                            from ...observability import metrics
                            metrics.inc("resilience.gave_up")
                        raise
                    # confirmed rank loss: restore the pre-step state, let
                    # the handler rebuild the world, then re-run on the
                    # survivors
                    self._restore(snap)
                    self._on_rank_death(e)
                    self._count_rollback(site)
                except _RETRYABLE_STEP as e:
                    detect_t = time.perf_counter()
                    if _goodput is not None and not recovering:
                        _goodput.recovery_begin()
                        recovering = True
                    self._heartbeat()  # the stall is over; stop the clock
                    attempt += 1
                    self._note_failure(site, e, kind="step_failure")
                    if attempt > budget:
                        from ...observability import metrics
                        metrics.inc("resilience.gave_up")
                        raise
                    self._restore(snap)
                    self._count_rollback(site)
        except BaseException:
            # a step that gives up must not leak its in-step or recovery
            # ledger state into the caller's timeline
            if _goodput is not None:
                _goodput.step_abort()
            raise

    # ------------------------------------------------------ accounting
    @staticmethod
    def _note_failure(site: str, e: BaseException, kind: str):
        from ...observability import metrics
        metrics.inc("resilience.step_failures")
        if _OBS.FLIGHT:
            from ...observability import flight
            flight.note("elastic", site, event=kind, error=repr(e)[:160])

    @staticmethod
    def _count_rollback(site: str):
        from ...observability import metrics
        metrics.inc("resilience.rollbacks")
        if _OBS.FLIGHT:
            from ...observability import flight
            flight.note("elastic", site, event="rollback")


# ------------------------------------------------------- world shrink

def plan_shrink(mesh, lost_process_ids: Sequence[int]):
    """The survivors' ProcessMesh. Shrinks along the first mesh axis when
    the survivor count still factors over the trailing axes (dp-style
    node loss keeps the mesh rank and dim names); otherwise flattens to a
    1-D mesh over the survivors."""
    from ..mesh import ProcessMesh
    lost = set(int(r) for r in lost_process_ids)
    survivors = [pid for pid in mesh.process_ids if pid not in lost]
    if not survivors:
        from ...base.core import EnforceNotMet
        raise EnforceNotMet(
            f"world shrink leaves no survivors (mesh {mesh!r}, "
            f"lost {sorted(lost)})")
    return ProcessMesh(*_reshaped(mesh, survivors))


def _reshaped(mesh, members):
    """(id array, dim names) of a mesh over ``members`` with ``mesh``'s
    trailing axes where the count still factors over them, else 1-D."""
    shape = mesh.shape
    trailing = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    n = len(members)
    if len(shape) > 1 and trailing and n % trailing == 0:
        return (np.asarray(members).reshape([n // trailing] + shape[1:]),
                mesh.dim_names)
    return np.asarray(members).reshape([n]), [mesh.dim_names[0]]


def _shrunk_placements(old_placements, old_mesh, new_mesh, global_shape):
    """Placements on the new mesh: kept when the mesh rank survived and
    the shard still divides evenly over the (new) axis; replicated
    otherwise (an uneven split would fail the sanitizer's
    reshard_placement check).

    Flattened-mesh case (the member count no longer factors the old mesh
    rank): per-axis shard assignments are invalid, but a tensor the old
    mesh sharded still takes a 1-D split along its first still-divisible
    shard dim instead of blanket replication, since memory is tightest
    right after a shrink."""
    from ..placements import Replicate
    if new_mesh.ndim != old_mesh.ndim:
        if new_mesh.ndim == 1:
            from ..placements import Shard
            axis = new_mesh.shape[0]
            for p in old_placements:
                if p.is_shard():
                    d = p.get_dim()
                    if d < len(global_shape) and axis \
                            and global_shape[d] % axis == 0:
                        return [Shard(d)]
        return [Replicate()] * new_mesh.ndim
    out = []
    for mesh_dim, p in enumerate(old_placements):
        if p.is_shard():
            d = p.get_dim()
            axis = new_mesh.shape[mesh_dim]
            size = global_shape[d] if d < len(global_shape) else None
            if size is None or (axis and size % axis != 0):
                out.append(Replicate())
                continue
        out.append(p)
    return out


# ------------------------------------------------------ the data move

def _box(attr, pid):
    """The global index box ((start, stop) per dim) of process ``pid``'s
    piece under ``attr``."""
    from ...models.convert import shard_index
    from ..api import placements_to_spec
    mesh, gshape = attr.process_mesh, attr.global_shape
    spec = placements_to_spec(attr.placements, mesh, len(gshape))
    idx = shard_index(tuple(gshape), spec, mesh, mesh.coords(pid))
    return tuple((0, n) if s == slice(None) else (s.start, s.stop)
                 for s, n in zip(idx, gshape))


def _inside(inner, outer) -> bool:
    return all(o0 <= i0 and i1 <= o1
               for (i0, i1), (o0, o1) in zip(inner, outer))


def _plan_move(name, src_attr, dst_attr, holders, receivers):
    """The blocks each receiver's new piece takes, and from whom: a list of
    (src pid, dst pid, global box). Every block comes from the receiver
    itself where it holds it, else from the lowest holder id that does.
    Raises ``EnforceNotMet`` naming ``name`` where no holder has a
    block."""
    from ...base.core import EnforceNotMet
    for attr in (src_attr, dst_attr):
        if any(p.is_partial() for p in attr.placements):
            raise EnforceNotMet(
                f"tensor {name!r} is Partial on {attr.process_mesh!r}: a "
                f"rank's piece is one contribution of a sum, and the "
                f"membership change cannot lay it out again from pieces")
    old = {pid: _box(src_attr, pid) for pid in holders}
    moves = []
    for dst in receivers:
        want = _box(dst_attr, dst)
        cuts = []
        for d, (w0, w1) in enumerate(want):
            pts = {w0, w1}
            for box in old.values():
                pts.update(c for c in box[d] if w0 < c < w1)
            cuts.append(sorted(pts))
        for cell in itertools.product(*[list(zip(c[:-1], c[1:]))
                                        for c in cuts]):
            order = ([dst] if dst in old else []) + sorted(old)
            src = next((h for h in order if _inside(cell, old[h])), None)
            if src is None:
                raise EnforceNotMet(
                    f"tensor {name!r}: block {list(cell)} of process "
                    f"{dst}'s piece on {dst_attr.process_mesh!r} was held "
                    f"only by lost processes; the survivors cannot lay it "
                    f"out again (reload it from a checkpoint)")
            moves.append((src, dst, cell))
    return moves


def _run_move(moves, piece, src_box, dst_box, like):
    """This process's new piece: the blocks of ``moves`` copied from its
    own old ``piece`` or received from their holders, and its blocks sent
    to the others (one ``batch_isend_irecv`` over the world). ``like`` is
    any tensor of the value's dtype and device; None where this process
    takes no new piece."""
    from ..parallel_env import process_id, rank_of
    me = process_id()

    def rel(cell, box):
        return tuple(slice(c0 - b0, c1 - b0)
                     for (c0, c1), (b0, _) in zip(cell, box))

    out = None
    if dst_box is not None:
        out = like.new_empty([b1 - b0 for b0, b1 in dst_box])
    ops, landing = [], []
    for src, dst, cell in moves:
        if src == me and dst == me:
            out[rel(cell, dst_box)] = piece[rel(cell, src_box)]
        elif src == me:
            ops.append(dist.P2POp(dist.isend, piece[rel(cell, src_box)]
                                  .contiguous(), rank_of(dst)))
        elif dst == me:
            buf = like.new_empty([c1 - c0 for c0, c1 in cell])
            ops.append(dist.P2POp(dist.irecv, buf, rank_of(src)))
            landing.append((buf, rel(cell, dst_box)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for buf, where in landing:
        out[where] = buf
    return out


def _move_world(mesh, new_mesh, tensors, optimizer, holders):
    """Plan every tensor's move (raising before any data moves), then
    move each tensor and its optimizer leaves over the current world."""
    from ..parallel_env import process_id
    me = process_id()
    receivers = [p for p in new_mesh.process_ids if p in set(holders)]
    plans = [(name, t, dst, _plan_move(name, t._dist_attr, dst, holders,
                                       receivers))
             for name, t, dst in tensors]
    for name, t, dst, moves in plans:
        src = t._dist_attr
        src_box = _box(src, me) if me in holders else None
        dst_box = _box(dst, me) if me in receivers else None
        old = t._t
        with torch.no_grad():
            new = _run_move(moves, old.detach(), src_box, dst_box, old)
            leaves = []
            if optimizer is not None:
                pid = id(t)
                for k, v in list((optimizer._states.get(pid) or {})
                                 .items()):
                    if v.shape == old.shape:
                        leaves.append((optimizer._states[pid], k, v))
                if pid in optimizer._master:
                    leaves.append((optimizer._master, pid,
                                   optimizer._master[pid]))
            moved = [(d, k, _run_move(moves, v, src_box, dst_box, v))
                     for d, k, v in leaves]
        if new is None:   # a survivor outside the new mesh: an empty piece
            new = old.new_empty((0,))
        t._t = new.requires_grad_(old.requires_grad)
        t._dist_attr = dst
        for d, k, v in moved:
            d[k] = v if v is not None else old.new_empty((0,))


def _transitions(mesh, new_mesh, state):
    """(tensors to move as (name, tensor, new DistAttr), the sanitizer's
    transitions) of ``state``'s tensors that live on ``mesh``."""
    from ..api import DistAttr
    tensors, transitions = [], []
    for name, t in (state or {}).items():
        attr = getattr(t, "_dist_attr", None)
        if attr is None or attr.process_mesh is not mesh:
            continue
        gshape = tuple(attr.global_shape)
        dst = DistAttr(new_mesh, _shrunk_placements(
            attr.placements, mesh, new_mesh, gshape), gshape)
        tensors.append((name, t, dst))
        # the reference's value rank counts a Partial axis's stacked dim
        n_partial = sum(1 for p in attr.placements if p.is_partial())
        transitions.append((len(gshape) + n_partial, attr, dst, gshape))
    return tensors, transitions


def _pipeline_cfg(pipeline, new_mesh):
    if pipeline is None:
        return None
    schedule, num_micro = pipeline[0], pipeline[1]
    num_chunks = pipeline[2] if len(pipeline) > 2 else 1
    # a planned mesh carries its pipeline depth on the pp axis; only a
    # pipeline-flat (1-D) mesh treats every rank as a stage
    pp_size = new_mesh.get_dim_size("pp") \
        if "pp" in new_mesh.dim_names else new_mesh.size
    return (schedule, pp_size, num_micro, num_chunks)


def _change_world(mesh, new_mesh, state, optimizer, pipeline, set_global,
                  members, holders, world_epoch, store):
    """The validate-then-move path both directions share: the sweep, the
    world of ``members`` formed again (where this process is in a world),
    then every tensor's move. Returns the number of tensors moved."""
    tensors, transitions = _transitions(mesh, new_mesh, state)
    from ...analysis import hooks as _sanitizer
    _sanitizer.on_world_shrink(transitions,
                               _pipeline_cfg(pipeline, new_mesh))
    from ..mesh import get_mesh, set_mesh
    was_global = get_mesh() is mesh
    if dist.is_initialized():
        from .. import parallel_env
        parallel_env.rebuild_world(members, world_epoch, store=store)
    if set_global and was_global:
        set_mesh(new_mesh)
    if dist.is_initialized():
        _move_world(mesh, new_mesh, tensors, optimizer, holders)
    else:
        # no world: this process holds whole values (the one rank of its
        # meshes), so a new layout moves nothing
        for _, t, dst in tensors:
            t._dist_attr = dst
    return len(tensors)


def shrink_world(mesh, lost_process_ids: Sequence[int],
                 state: Optional[Dict] = None, *,
                 optimizer=None,
                 pipeline: Optional[tuple] = None,
                 set_global: bool = True,
                 target_mesh=None,
                 world_epoch: Optional[int] = None,
                 store=None):
    """Rebuild the world over the surviving ranks after confirmed rank
    loss: plan the shrunk mesh, have the sanitizer's distributed checkers
    validate every reshard transition (and the shrunk pipeline schedule,
    when ``pipeline=(schedule, num_micro)`` or ``(schedule, num_micro,
    num_chunks)`` is given) before anything moves, form the survivors'
    world (``parallel_env.rebuild_world`` under ``world_epoch``, default
    the last epoch + 1, on ``store``'s rendezvous), then lay each of
    ``state``'s tensors on ``mesh`` out again in place. With
    ``optimizer``, its per-parameter states and master weights follow
    their parameter. Returns the new ProcessMesh.

    Every survivor calls it with the same arguments. Validation is
    unconditional (mode 'error'): recovery onto a broken layout is worse
    than failing loudly. A block that only lost processes held raises
    ``EnforceNotMet`` naming the tensor, after the survivors' world is
    formed and before any data moves (the caller's fallback is a
    checkpoint).

    ``target_mesh`` overrides the default ``plan_shrink`` topology (the
    adaptive re-planner's survivor mesh) and must cover exactly the
    survivors.
    """
    t0 = time.perf_counter()
    lost = set(int(r) for r in lost_process_ids)
    if target_mesh is not None:
        survivors = set(pid for pid in mesh.process_ids if pid not in lost)
        if set(target_mesh.process_ids) != survivors:
            from ...base.core import EnforceNotMet
            raise EnforceNotMet(
                f"target_mesh {target_mesh!r} covers processes "
                f"{sorted(target_mesh.process_ids)} but the survivors "
                f"of {mesh!r} minus {sorted(lost)} are "
                f"{sorted(survivors)}")
        new_mesh = target_mesh
    else:
        new_mesh = plan_shrink(mesh, lost_process_ids)
    from ..parallel_env import world_process_ids
    members = [p for p in world_process_ids() if p not in lost]
    holders = [p for p in mesh.process_ids if p not in lost]
    _change_world(mesh, new_mesh, state, optimizer, pipeline, set_global,
                  members, holders, world_epoch, store)
    from ...observability import metrics
    metrics.inc("resilience.world_shrinks")
    metrics.observe("resilience.shrink_us",
                    (time.perf_counter() - t0) * 1e6)
    if _OBS.FLIGHT:
        from ...observability import flight
        flight.note("shrink", "world", old=mesh.size, new=new_mesh.size,
                    lost=list(lost_process_ids))
    return new_mesh


# --------------------------------------------------------- world grow

def plan_grow(mesh, joined_process_ids: Sequence[int]):
    """The grown ProcessMesh: the inverse of ``plan_shrink``. Grows along
    the first mesh axis when the new count still factors over the
    trailing axes; otherwise flattens to a 1-D mesh over everyone. Joined
    ids must be disjoint from the current mesh."""
    from ..mesh import ProcessMesh
    joined = sorted(set(int(r) for r in joined_process_ids))
    current = set(int(p) for p in mesh.process_ids)
    dup = current & set(joined)
    if dup or not joined:
        from ...base.core import EnforceNotMet
        raise EnforceNotMet(
            f"world grow needs a non-empty joining set disjoint from "
            f"the mesh {mesh!r} (joined {joined}, already present "
            f"{sorted(dup)})")
    return ProcessMesh(*_reshaped(mesh, sorted(current | set(joined))))


def grow_world(mesh, joined_process_ids: Sequence[int],
               state: Optional[Dict] = None, *,
               optimizer=None,
               pipeline: Optional[tuple] = None,
               set_global: bool = True,
               target_mesh=None,
               world_epoch: Optional[int] = None,
               store=None):
    """The survivors' half of a membership growth, through the same
    validate-then-move gate as ``shrink_world``: plan the grown mesh (or
    adopt ``target_mesh``, which must cover exactly the old ranks plus
    ``joined_process_ids``), validate every transition, form the world of
    the old members and the joiners (each joiner calls
    ``parallel_env.rebuild_world`` with the same members and epoch before
    it receives its state), then lay each survivor's pieces out again over
    the grown mesh, between survivors only. ``optimizer`` leaves follow
    their parameter. Returns the new ProcessMesh.

    The joiner receives its pieces separately: the survivors' state
    broadcast through the TCPStore (``growth.py``) or a reload of the
    newest verified checkpoint."""
    t0 = time.perf_counter()
    joined = set(int(r) for r in joined_process_ids)
    if target_mesh is not None:
        everyone = set(int(p) for p in mesh.process_ids) | joined
        if set(target_mesh.process_ids) != everyone:
            from ...base.core import EnforceNotMet
            raise EnforceNotMet(
                f"target_mesh {target_mesh!r} covers processes "
                f"{sorted(target_mesh.process_ids)} but the grown "
                f"world of {mesh!r} plus {sorted(joined)} is "
                f"{sorted(everyone)}")
        new_mesh = target_mesh
    else:
        new_mesh = plan_grow(mesh, joined_process_ids)
    from ..parallel_env import world_process_ids
    members = sorted(set(world_process_ids()) | joined)
    _change_world(mesh, new_mesh, state, optimizer, pipeline, set_global,
                  members, list(mesh.process_ids), world_epoch, store)
    from ...observability import metrics
    metrics.inc("resilience.world_grows")
    metrics.observe("resilience.grow_reshard_us",
                    (time.perf_counter() - t0) * 1e6)
    if _OBS.FLIGHT:
        from ...observability import flight
        flight.note("grow", "world", old=mesh.size, new=new_mesh.size,
                    joined=sorted(joined))
    return new_mesh
