"""Adaptive elastic training: re-plan the parallel strategy on a membership
change, the counterpart of ``paddle_tpu/distributed/resilience/
adaptive.py``.

``AdaptiveTrainer`` joins:

- the event sources: ``ElasticManager`` membership epochs
  (``fleet/elastic.py``: the master publishes ``{epoch, members}`` from
  heartbeat scans; the trainer polls between steps), ``RankDeath`` from
  the step (``ElasticStep``'s ``on_rank_death``), and the injectable
  ``member::leave`` / ``member::join`` / ``preempt::notice`` fault sites
  fired at every step boundary;
- the re-planner: the auto-tuner's cost and memory model
  (``auto_tuner``) searched over the divisors of the survivor count, with
  plain data parallelism as the guaranteed fallback;
- validation: the sanitizer's world-shrink sweep
  (``analysis.hooks.on_world_shrink``, always error mode) approves every
  transition before anything moves;
- application: ``shrink_world`` / ``grow_world`` with the planned mesh
  form the new world and move parameters and optimizer state; when the
  move cannot be made (a block held only by lost processes) the trainer
  adopts the planned layout and reloads the newest verified generation of
  its ``CheckpointManager``; a grow publishes the state for the joiner
  (``growth.publish_state``);
- resume: ``lazy.bump_mesh_epoch()`` re-keys the lazy window's caches, so
  the next window records anew on the new world.

Counters: ``resilience.replans``, ``grows``, ``member_epochs``,
``replan_fallback_plans``, ``preempt_notices``, ``preempt_ckpts``,
``ckpt_restores``, ``bcast_restores`` and the ``resilience.replan_us`` /
``grow_us`` histograms (membership change to the first good step after
it).

Not ported: the static planner tier (``Replanner(program_view=...)``
needs ``analysis/planner.py``, ``ROADMAP.md`` §1 item 9, and raises
``NotImplementedError``); the rebuild of an ambient ``auto_mesh`` after a
re-plan (``spmd.rebuild_ambient``: the port has no ambient mesh, item
9.1, so there is nothing to rebuild); and the count of persistent-cache
hits across a re-plan (the port persists no runner of the window: a
re-plan rebuilds runners, it loads none). Behind their gates, as in the
reference: the ``resilience::replan`` / ``resilience::grow`` spans
(``_OBS.ACTIVE``), the flight-recorder notes (``_OBS.FLIGHT``), the
distributed post-mortem of a lost rank (``_OBS.DIST``) and the goodput
ledger's recovery window around a checkpoint fallback
(``_OBS.GOODPUT``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from ...observability import _state as _OBS

import numpy as np
import torch

from ..._core import flags as _flags
from .elastic import (ElasticStep, _RETRYABLE_STEP, _shrunk_placements,
                      grow_world, shrink_world)
from .faults import FaultError, RankDeath


class MembershipEvent:
    """One observed change of the training world."""

    __slots__ = ("epoch", "members", "lost", "joined", "source")

    def __init__(self, epoch: int, members: Sequence,
                 lost: Sequence = (), joined: Sequence = (),
                 source: str = "manager"):
        self.epoch = epoch
        self.members = list(members)
        self.lost = list(lost)
        self.joined = list(joined)
        self.source = source

    def __repr__(self):
        return (f"MembershipEvent(epoch={self.epoch}, "
                f"members={self.members}, lost={self.lost}, "
                f"joined={self.joined}, source={self.source!r})")


class Replanner:
    """Survivor-feasible parallel-strategy search over the auto-tuner's
    closed-form cost model: the divisor degree space of the survivor count
    (pruned by the tuner's own feasibility rules), so the chosen dp/mp/pp
    always tiles a realizable survivor mesh. When nothing survives pruning
    (a batch the survivor count cannot divide), the fallback is plain data
    parallelism over all survivors, counted under
    ``resilience.replan_fallback_plans`` with a warning.

    The reference's first tier, the whole-program planner over a recorded
    segment (``program_view``), needs ``analysis/planner.py``
    (``ROADMAP.md`` §1 item 9): passing a view raises."""

    def __init__(self, model_config: Optional[Dict] = None,
                 n_params: Optional[int] = None,
                 program_view=None):
        if program_view is not None:
            raise NotImplementedError(
                "Replanner(program_view=...): the static planner tier "
                "needs analysis/planner.py, which is not ported yet "
                "(ROADMAP.md section 1 item 9); pass no view for the "
                "auto-tuner tier")
        self.model_config = dict(model_config or {})
        if n_params and "n_params" not in self.model_config:
            self.model_config["n_params"] = int(n_params)

    def replan(self, survivor_count: int) -> Dict:
        from ..auto_tuner.search import degree_space
        from ..auto_tuner.tuner import AutoTuner
        degrees = degree_space(survivor_count)
        space = {"dp_degree": degrees, "mp_degree": degrees,
                 "pp_degree": degrees}
        try:
            return AutoTuner(self.model_config, survivor_count,
                             tune_space=space, max_trials=0).tune()
        except RuntimeError as e:
            # a survivor count the model constraints cannot tile any
            # better way always admits pure data parallelism
            from ...observability import metrics
            metrics.inc("resilience.replan_fallback_plans")
            import warnings
            warnings.warn(
                f"adaptive re-plan: no tuner-feasible config for "
                f"{survivor_count} survivors ({e}); falling back to "
                f"dp={survivor_count}", RuntimeWarning, stacklevel=2)
            plan = dict(self.model_config)
            plan.update(world_size=survivor_count,
                        dp_degree=survivor_count, mp_degree=1,
                        pp_degree=1)
            return plan


def stage_rank_map(mesh) -> Dict[int, List[int]]:
    """Pipeline stage index -> sorted process ids hosting it, from the
    mesh's ``pp`` axis. A pp-free (or 1-D) mesh is one stage spanning
    every rank."""
    if "pp" not in mesh.dim_names:
        return {0: sorted(int(p) for p in mesh.process_ids)}
    axis = mesh.dim_names.index("pp")
    arr = np.moveaxis(np.asarray(mesh.mesh), axis, 0)
    arr = arr.reshape(arr.shape[0], -1)
    return {s: sorted(int(r) for r in arr[s])
            for s in range(arr.shape[0])}


def mesh_for_plan(process_ids: Sequence[int], plan: Dict):
    """The survivor ProcessMesh realizing a tuner plan: one mesh axis per
    parallel degree > 1, in dp/mp/pp order (a degenerate plan gets a 1-D
    ``dp`` mesh)."""
    from ..mesh import ProcessMesh
    dims: List[int] = []
    names: List[str] = []
    for name in ("dp", "mp", "pp"):
        deg = int(plan.get(f"{name}_degree", 1) or 1)
        if deg > 1:
            dims.append(deg)
            names.append(name)
    if not dims:
        dims, names = [len(process_ids)], ["dp"]
    if int(np.prod(dims)) != len(process_ids):
        from ...base.core import EnforceNotMet
        raise EnforceNotMet(
            f"plan degrees {dims} ({names}) do not tile the "
            f"{len(process_ids)} survivors {sorted(process_ids)}")
    return ProcessMesh(
        np.asarray(sorted(int(p) for p in process_ids)).reshape(dims),
        names)


def _dist_piece(value, p, dtype):
    """``value`` (an optimizer leaf of parameter ``p``, loaded or
    received) as this process holds it, in ``dtype``: a tensor as it is;
    a numpy array of the global value cut to ``p``'s piece."""
    from ..._core.tensor import Tensor
    from ..api import local_piece
    if isinstance(value, Tensor):
        return value._t.detach().clone()
    t = torch.as_tensor(np.asarray(value))
    attr = getattr(p, "_dist_attr", None)
    if attr is not None and list(t.shape) == list(attr.global_shape) \
            and list(t.shape) != list(p._t.shape):
        t = local_piece(t, attr)
    return t.to(device=p._t.device, dtype=dtype).clone()


class AdaptiveTrainer:
    """ElasticStep + membership watching + tuner re-planning + checkpoint
    retention, in one loop::

        trainer = AdaptiveTrainer(optimizer=opt, mesh=mesh,
                                  manager=elastic_manager,
                                  checkpoint_dir="ckpt",
                                  checkpoint_every=1)
        for batch in loader:
            loss = trainer.run(step_fn, batch)

    On a membership change (manager epoch, ``RankDeath``, or an injected
    ``member::leave``) the trainer quiesces, re-plans dp/mp/pp for the
    survivors, validates the plan through the sanitizer sweep, forms the
    survivors' world and moves the state (or reloads a verified
    checkpoint generation), re-keys the lazy window, and resumes.

    ``lost_ranks`` resolves which process ids died when the event itself
    does not say (fault sites, ``RankDeath``): a static list, or a
    callable ``(exception) -> list``. With a ``manager``, epoch diffs
    resolve the lost set from node ids (the process ids as strings).
    Every process of the world runs the trainer and sees the same events;
    the world's formation takes the event's epoch and the manager's store
    (``parallel_env.rebuild_world``).
    """

    def __init__(self, optimizer=None, parameters: Sequence = None, *,
                 mesh=None, model_config: Optional[Dict] = None,
                 program_view=None,
                 manager=None,
                 lost_ranks: Union[Sequence[int], Callable, None] = None,
                 joined_ranks: Union[Sequence[int], Callable,
                                     None] = None,
                 pipeline: Optional[tuple] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 max_retries: Optional[int] = None,
                 timeout: Optional[float] = None,
                 name: str = "adaptive"):
        self._opt = optimizer
        self._elastic = ElasticStep(
            optimizer=optimizer, parameters=parameters,
            max_retries=max_retries, timeout=timeout, name=name,
            on_rank_death=self._on_rank_death)
        self._params = self._elastic._params
        if mesh is None:
            from ..mesh import get_mesh
            mesh = get_mesh()
        self.mesh = mesh
        self._replanner = Replanner(
            model_config, n_params=self._count_params(),
            program_view=program_view)
        self._manager = manager
        self._members: List = []
        self._last_epoch = 0
        if manager is not None:
            m = manager.current_membership()
            self._last_epoch = int(m.get("epoch", 0))
            self._members = list(m.get("members", []))
        self._lost_ranks = lost_ranks
        self._joined_ranks = joined_ranks
        self._pipeline = pipeline
        self.ckpt = None
        if checkpoint_dir:
            from ..checkpoint import CheckpointManager
            self.ckpt = CheckpointManager(checkpoint_dir)
        self._ckpt_every = int(checkpoint_every)
        self.replans = 0
        self.grows = 0
        # membership-event latency lands in this histogram at the first
        # good step after the event: replan_us for shrink events, grow_us
        # for adopted growth
        self._latency_hist = "resilience.replan_us"
        self.last_grow_latency_s: Optional[float] = None
        self.preempt_checkpoints = 0
        self.last_plan: Optional[Dict] = None
        # stage index -> sorted survivor ranks hosting it, rebuilt from
        # the planned mesh's pp axis on every adopted re-plan
        self.last_stage_map: Optional[Dict[int, List[int]]] = None
        self.last_event: Optional[MembershipEvent] = None
        self.last_replan_latency_s: Optional[float] = None
        self._replan_t0: Optional[float] = None

    # ------------------------------------------------------------- misc
    def _count_params(self) -> int:
        n = 0
        for p in self._params:
            attr = getattr(p, "_dist_attr", None)
            shape = attr.global_shape if attr is not None \
                and attr.global_shape is not None else p.shape
            n += int(np.prod(shape)) if len(shape) else 1
        return n

    @property
    def step_index(self) -> int:
        return self._elastic.step_index

    def shutdown(self):
        self._elastic.shutdown()

    def _quiesce(self, drop: bool):
        """No in-flight lazy work may straddle a re-plan: a healthy
        boundary flushes the window (pending ops run on the old layout), a
        failed step drops its aborted trace. The async flush drains
        either way; on the drop path its latched errors are the failure
        being handled and are discarded, on the healthy path an unread
        worker failure surfaces before the re-plan trusts the state."""
        from ..._core import async_flush, lazy
        ctx = lazy.current_context()
        if ctx is not None and ctx.pending:
            if drop:
                ctx._reset_segment()
            else:
                ctx.flush("replan_quiesce")
        async_flush.drain(raise_latched=not drop)

    # ----------------------------------------------------- event intake
    def _poll_events(self):
        """Step-boundary membership poll: the injected member:: and
        preempt:: sites first (deterministic drills), then the manager's
        preemption announcements and published epoch."""
        if _flags.FAULT_INJECT_ACTIVE:
            from . import faults
            try:
                faults.inject("member::leave")
            except FaultError as e:
                self._membership_event(MembershipEvent(
                    self._last_epoch + 1, self._members,
                    lost=self._resolve_lost(e), source="fault"))
            try:
                faults.inject("member::join")
            except FaultError as e:
                self._membership_event(MembershipEvent(
                    self._last_epoch + 1, self._members,
                    joined=self._resolve_joined(e), source="fault"))
            try:
                faults.inject("preempt::notice")
            except FaultError:
                self._preempt_notice("fault")
        if self._manager is not None:
            notices = getattr(self._manager, "poll_preemption",
                              lambda: [])()
            for _node in notices:
                self._preempt_notice("manager")
            m = self._manager.current_membership()
            epoch = int(m.get("epoch", 0))
            if epoch > self._last_epoch:
                old = list(self._members)
                new = list(m.get("members", []))
                self._membership_event(MembershipEvent(
                    epoch, new,
                    lost=self._node_ids_to_ranks(
                        [n for n in old if n not in new], old),
                    joined=[n for n in new if n not in old],
                    source="manager"))

    @staticmethod
    def _node_ids_to_ranks(node_ids: List, members: List) -> List[int]:
        out = []
        for n in node_ids:
            try:
                out.append(int(n))
            except (TypeError, ValueError):
                out.append(members.index(n))
        return out

    def _resolve_lost(self, e: BaseException) -> List[int]:
        if callable(self._lost_ranks):
            return list(self._lost_ranks(e))
        if self._lost_ranks is not None:
            return list(self._lost_ranks)
        raise e   # cannot tell who died: propagate the death

    def _resolve_joined(self, e: BaseException) -> List:
        """Which process ids joined, for an injected member::join: a
        static list or callable, as ``lost_ranks``. Without one the event
        is recorded but cannot grow the mesh (no way to name the new
        ranks)."""
        if callable(self._joined_ranks):
            return list(self._joined_ranks(e))
        if self._joined_ranks is not None:
            return list(self._joined_ranks)
        return ["<injected>"]

    def _on_rank_death(self, e: RankDeath):
        """ElasticStep's rank-death hook: state was already restored to
        the pre-step snapshot; re-plan for the survivors, then
        ElasticStep re-runs the step."""
        self._membership_event(MembershipEvent(
            self._last_epoch + 1, self._members,
            lost=self._resolve_lost(e), source="rank_death"),
            drop_inflight=True)

    # -------------------------------------------------------- the replan
    def _membership_event(self, ev: MembershipEvent,
                          drop_inflight: bool = False):
        from ...observability import metrics
        metrics.inc("resilience.member_epochs")
        self._replan_t0 = time.perf_counter()
        self._latency_hist = "resilience.replan_us"
        prev_epoch, prev_members = self._last_epoch, self._members
        self._last_epoch = ev.epoch
        self._members = list(ev.members)
        self.last_event = ev
        _note("membership", epoch=ev.epoch, lost=list(ev.lost),
              joined=list(ev.joined), source=ev.source)
        if ev.joined and not ev.lost:
            # join-driven growth: resolve the joining node ids to process
            # ids and re-plan the bigger world. A join whose ranks cannot
            # be named is recorded (epoch adopted, counter) and training
            # continues on the current plan.
            joined = self._joined_to_ranks(ev)
            if not joined or self.mesh is None:
                self._replan_t0 = None
                return
            self._latency_hist = "resilience.grow_us"
            try:
                self._grow_and_apply(joined, ev, drop_inflight)
            except BaseException:
                # a failed grow must not consume the event: the next poll
                # observes it again
                self._last_epoch, self._members = \
                    prev_epoch, prev_members
                self._replan_t0 = None
                self._latency_hist = "resilience.replan_us"
                raise
            return
        lost = [r for r in ev.lost
                if self.mesh is None
                or r in set(self.mesh.process_ids)]
        if ev.lost and _OBS.DIST:
            # the distributed postmortem before the re-plan mutates state:
            # survivors publish their flight rings, rank 0 writes the
            # interleaved report (never raises)
            from ...observability import distributed as _dtel
            _dtel.trigger_postmortem(
                f"{ev.source}: lost ranks {sorted(ev.lost)} "
                f"(epoch {ev.epoch})")
        if not lost or self.mesh is None:
            self._replan_t0 = None
            return
        try:
            self._replan_and_apply(lost, ev, drop_inflight)
        except BaseException:
            # the event must not be consumed by a failed re-plan: the
            # next poll observes it again instead of training on against
            # the dead ranks
            self._last_epoch, self._members = prev_epoch, prev_members
            self._replan_t0 = None
            raise

    def _state(self) -> Dict:
        return {(p.name or f"p{i}"): p for i, p in enumerate(self._params)}

    def _store(self):
        return getattr(self._manager, "store", None)

    def _replan_and_apply(self, lost: List[int], ev: MembershipEvent,
                          drop_inflight: bool = False):
        _spanned("resilience::replan", "resilience.replan_apply_us",
                 self._replan, lost, ev, drop_inflight,
                 lost=list(lost), source=ev.source)

    def _replan(self, lost, ev, drop_inflight):
        from ...observability import metrics
        self._quiesce(drop=drop_inflight)
        survivors = [pid for pid in self.mesh.process_ids
                     if pid not in set(lost)]
        if not survivors:
            from ...base.core import EnforceNotMet
            raise EnforceNotMet(
                f"membership change loses every rank of "
                f"{self.mesh!r} ({sorted(lost)}): nothing to "
                f"re-plan onto")
        plan = self._replanner.replan(len(survivors))
        new_mesh = mesh_for_plan(survivors, plan)
        pipeline = self._pipeline
        if pipeline is None and "pp" in new_mesh.dim_names:
            # a planner-chosen pp axis must pass the pipeline-schedule
            # checker before adoption even when this trainer was never
            # configured with a pipeline: the canonical 1F1B schedule at
            # the planner's micro-batch depth (2 pp)
            pipeline = ("1F1B", 2 * new_mesh.get_dim_size("pp"))
        from ...analysis.diagnostics import StaticCheckError
        try:
            # validates every transition (sanitizer, error mode) before
            # anything moves, forms the survivors' world, then moves
            # parameters and optimizer state
            shrink_world(self.mesh, lost, self._state(),
                         optimizer=self._opt, pipeline=pipeline,
                         target_mesh=new_mesh, world_epoch=ev.epoch,
                         store=self._store())
        except StaticCheckError:
            # the sanitizer refused the plan itself: reloading a
            # checkpoint onto the refused layout would bypass the
            # validate-before-move gate
            raise
        except Exception:
            if self.ckpt is None or self.ckpt.latest() is None:
                raise
            # the plan could not be carried out (a block held only by
            # lost processes): adopt the planned layout, then fill it
            # from the newest verified generation
            self._adopt_layout(new_mesh)
            self.restore_from_checkpoint()
        self.mesh = new_mesh
        self.last_plan = plan
        self.last_stage_map = stage_rank_map(new_mesh)
        self.replans += 1
        metrics.inc("resilience.replans")
        from ..._core import lazy
        lazy.bump_mesh_epoch()
        _note("replan", survivors=len(survivors),
              dp=plan.get("dp_degree", 1), mp=plan.get("mp_degree", 1),
              pp=plan.get("pp_degree", 1))

    # --------------------------------------------------------- the grow
    def _joined_to_ranks(self, ev: MembershipEvent) -> List[int]:
        """Joining node ids -> new process ids: ints (or int-like node
        ids) not already in the mesh."""
        current = set(int(p) for p in self.mesh.process_ids) \
            if self.mesh is not None else set()
        out = []
        for n in ev.joined:
            try:
                r = int(n)
            except (TypeError, ValueError):
                continue
            if r not in current:
                out.append(r)
        return sorted(set(out))

    def _grow_and_apply(self, joined: List[int], ev: MembershipEvent,
                        drop_inflight: bool = False):
        """The growth mirror of ``_replan_and_apply``: quiesce, re-plan
        the grown world through the tuner, validate through the sanitizer
        sweep, form the grown world and lay the survivors' state out over
        it (``grow_world``), publish the state broadcast for the joiner,
        re-key the lazy window."""
        _spanned("resilience::grow", "resilience.grow_apply_us",
                 self._grow, joined, ev, drop_inflight,
                 joined=list(joined), source=ev.source)

    def _grow(self, joined, ev, drop_inflight):
        from ...observability import metrics
        self._quiesce(drop=drop_inflight)
        everyone = sorted(
            set(int(p) for p in self.mesh.process_ids) | set(joined))
        plan = self._replanner.replan(len(everyone))
        new_mesh = mesh_for_plan(everyone, plan)
        pipeline = self._pipeline
        if pipeline is None and "pp" in new_mesh.dim_names:
            pipeline = ("1F1B", 2 * new_mesh.get_dim_size("pp"))
        # the joiner's state, gathered over the old world before the move
        # (a gather over the grown world would wait for the joiner, which
        # waits for this broadcast)
        host = None
        if self._store() is not None:
            from ..parallel_env import process_id
            host = self._host_state()
            if process_id() != min(int(p) for p in self.mesh.process_ids):
                host = None
        from ...analysis.diagnostics import StaticCheckError
        try:
            grow_world(self.mesh, joined, self._state(),
                       optimizer=self._opt, pipeline=pipeline,
                       target_mesh=new_mesh, world_epoch=ev.epoch,
                       store=self._store())
        except StaticCheckError:
            raise
        except Exception:
            if self.ckpt is None or self.ckpt.latest() is None:
                raise
            self._adopt_layout(new_mesh)
            self.restore_from_checkpoint()
        self.mesh = new_mesh
        self.last_plan = plan
        self.last_stage_map = stage_rank_map(new_mesh)
        self.grows += 1
        metrics.inc("resilience.grows")
        # the joiner's fast path: the full state under the adopted epoch
        # (a failure here must not fail the survivors' grow: the joiner's
        # fallback is the newest verified checkpoint generation)
        self._broadcast_state(host, ev.epoch)
        from ..._core import lazy
        lazy.bump_mesh_epoch()
        _note("grow", world=len(everyone), joined=list(joined),
              dp=plan.get("dp_degree", 1), mp=plan.get("mp_degree", 1),
              pp=plan.get("pp_degree", 1))

    def _broadcast_state(self, host: Optional[Dict], epoch: int):
        """Best-effort publication of ``host`` (``_host_state()``, taken
        before the move) through the manager's TCPStore
        (``growth.publish_state``: chunked, sha256 checksummed, retried)
        by the lowest surviving process id."""
        if host is None:
            return
        try:
            from . import growth as _growth
            _growth.publish_state(self._store(), host, epoch)
        except Exception as e:
            import warnings
            warnings.warn(
                f"grow state broadcast failed ({e}); the joiner falls "
                f"back to the newest verified checkpoint",
                RuntimeWarning, stacklevel=2)

    def _host_state(self) -> Dict:
        """``_full_state`` with every tensor as a numpy array of its
        global value."""
        from ..checkpoint import _global_numpy
        from ..._core.tensor import Tensor
        host: Dict = {}
        for k, v in self._full_state().items():
            if isinstance(v, Tensor):
                v = _global_numpy(v)
            elif isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            host[k] = v
        return host

    # ------------------------------------------------------- preemption
    def _preempt_notice(self, source: str):
        """React to a preemption notice (injected ``preempt::notice`` or
        an ``ElasticManager.announce_preemption`` poll): one immediate
        verified checkpoint through the retention manager, bounding the
        replacement's lost work to the notice-to-kill window."""
        from ...observability import metrics
        metrics.inc("resilience.preempt_notices")
        _note("preempt_notice", source=source,
              step=self._elastic.step_index)
        if self.ckpt is None:
            return
        gen = self.save_checkpoint()
        self.preempt_checkpoints += 1
        metrics.inc("resilience.preempt_ckpts")
        _note("preempt_ckpt", generation=gen, step=self._elastic.step_index)

    def _adopt_layout(self, new_mesh):
        """Point every mesh-resident parameter at its planned placement on
        ``new_mesh`` with a zero piece of the planned shape; the
        checkpoint load that follows fills it."""
        from ..api import DistAttr, local_piece
        old_mesh = self.mesh
        for p in self._params:
            attr = getattr(p, "_dist_attr", None)
            if attr is None or attr.process_mesh is not old_mesh:
                continue
            gshape = tuple(attr.global_shape)
            new = DistAttr(new_mesh, _shrunk_placements(
                attr.placements, old_mesh, new_mesh, gshape), gshape)
            old = p._t
            piece = local_piece(old.new_zeros(gshape), new)
            p._t = piece.detach().requires_grad_(old.requires_grad)
            p._dist_attr = new
            opt = self._opt
            if opt is not None:
                opt._states.pop(id(p), None)
                opt._master.pop(id(p), None)
        from ..mesh import get_mesh, set_mesh
        if get_mesh() is old_mesh:
            set_mesh(new_mesh)

    # -------------------------------------------------------- checkpoint
    def _full_state(self) -> Dict:
        """Everything a resume needs, keyed stably by parameter index:
        parameters (as tensors: reshard on load lays them out), optimizer
        states (a sharded parameter's as tensors with its layout, so the
        checkpoint gathers them), master weights, step count, LR scheduler
        state, the seed, the generators' states (``rng::key``: the port's
        generators, which draw other numbers than the reference's from
        one seed) and the step index."""
        from ..._core.tensor import Tensor
        st: Dict = {}
        for i, p in enumerate(self._params):
            st[f"param::{i}"] = p
        opt = self._opt

        def leaf(v, p):
            t = Tensor(v.detach())
            attr = getattr(p, "_dist_attr", None)
            if attr is not None and v.shape == p._t.shape:
                t._dist_attr = attr
            return t

        if opt is not None:
            for i, p in enumerate(self._params):
                pid = id(p)
                for k, v in (opt._states.get(pid) or {}).items():
                    st[f"opt::state:{i}:{k}"] = leaf(v, p)
                if pid in opt._master:
                    st[f"opt::master:{i}"] = leaf(opt._master[pid], p)
            st["opt::step_count"] = opt._step_count
            lr = opt._lr
            if hasattr(lr, "state_dict"):
                st["opt::lr"] = dict(lr.state_dict())
        from ..._core import random as _rng
        st["rng::seed"] = _rng._seed
        with _rng._LOCK:
            st["rng::key"] = {str(dev): g.get_state().numpy()
                              for dev, g in _rng._generators.items()}
        st["meta::step_index"] = self._elastic.step_index
        return st

    def save_checkpoint(self) -> int:
        if self.ckpt is None:
            raise ValueError("AdaptiveTrainer has no checkpoint_dir")
        return self.ckpt.save(self._full_state(),
                              step=self._elastic.step_index)

    def restore_from_checkpoint(self, generation: Optional[int] = None):
        """Reload the newest verified generation (or ``generation``) into
        the live model, optimizer and generators. The CheckpointManager
        falls back past corrupted generations; the loaded leaves go back
        to the optimizer's dictionaries keyed by the live parameter ids.
        ``augment_missing``: a fresh optimizer has no moments yet, and
        the generation's own key set extends the target so the full
        state loads."""
        if self.ckpt is None:
            raise ValueError("AdaptiveTrainer has no checkpoint_dir")
        st = self._full_state()
        gen = self.ckpt.load(st, generation=generation,
                             augment_missing=True)
        self._apply_aux_state(st)
        from ...observability import metrics
        metrics.inc("resilience.ckpt_restores")
        _note("ckpt_restore", generation=gen)
        return gen

    def restore_from_broadcast(self, store, epoch: int, *,
                               timeout: float = 30.0):
        """Joining rank: receive the survivors' state broadcast for the
        adopted growth epoch (``growth.receive_state``: chunked,
        checksummed, retried) and apply it to the live model, optimizer
        and generators, cutting each parameter's piece by its own current
        layout (the joiner built it on the grown mesh). Raises
        ``retry.StoreOpError`` when the broadcast is missing or fails
        verification: the caller's fallback is
        ``restore_from_checkpoint``."""
        from . import growth as _growth
        from ..api import local_piece
        st = _growth.receive_state(store, epoch, timeout=timeout)
        for i, p in enumerate(self._params):
            v = st.get(f"param::{i}")
            if v is None:
                continue
            val = torch.as_tensor(np.asarray(v))
            attr = getattr(p, "_dist_attr", None)
            if attr is not None:
                val = local_piece(val, attr)
            p.set_value(val)
        self._apply_aux_state(st)
        from ...observability import metrics
        metrics.inc("resilience.bcast_restores")
        _note("bcast_restore", epoch=int(epoch))
        return st

    def _apply_aux_state(self, st: Dict):
        """Apply the non-parameter leaves of a loaded or received state
        (optimizer states, master weights, step count, LR scheduler, the
        generators, the step index) to the live objects, keyed by
        parameter index."""
        opt = self._opt
        if opt is not None:
            states: Dict = {}
            master: Dict = {}
            for key, v in st.items():
                if v is None:
                    continue   # key absent from the loaded generation
                if key.startswith("opt::state:"):
                    _, _, i_k = key.partition("opt::state:")
                    i, _, k = i_k.partition(":")
                    p = self._params[int(i)]
                    # a low-precision parameter's states live in its
                    # master's float32 when the optimizer keeps one
                    low = opt._multi_precision and p._t.dtype in (
                        torch.bfloat16, torch.float16)
                    states.setdefault(id(p), {})[k] = _dist_piece(
                        v, p, torch.float32 if low else p._t.dtype)
                elif key.startswith("opt::master:"):
                    p = self._params[int(key.rsplit(":", 1)[1])]
                    master[id(p)] = _dist_piece(v, p, torch.float32)
            # unconditional: the loaded generation's leaves are the
            # optimizer state now (none means the checkpoint predates the
            # first step, and live leftovers would be stale)
            opt._states = states
            opt._master = master
            opt._step_count = int(st.get("opt::step_count") or 0)
            if st.get("opt::lr") is not None \
                    and hasattr(opt._lr, "set_state_dict"):
                opt._lr.set_state_dict(dict(st["opt::lr"]))
        for p in self._params:
            p.clear_grad()
        from ..._core import random as _rng
        if st.get("rng::key") is not None:
            with _rng._LOCK:
                _rng._seed = st.get("rng::seed")
                saved = {torch.device(d): torch.as_tensor(np.asarray(s))
                         for d, s in dict(st["rng::key"]).items()}
                for dev in list(_rng._generators):
                    if dev not in saved:
                        del _rng._generators[dev]
                for dev, state in saved.items():
                    gen = _rng._generators.get(dev)
                    if gen is None:
                        gen = _rng._generators[dev] = \
                            torch.Generator(device=dev)
                    gen.set_state(state)
        # the step counter rewinds with the state: replayed steps keep
        # their original step:: site numbering and save() step metadata
        if st.get("meta::step_index") is not None:
            self._elastic.step_index = int(st["meta::step_index"])

    # --------------------------------------------------------------- run
    def run(self, step_fn: Callable, *args, **kw):
        """One adaptive train step: poll membership, run under the
        elastic snapshot/rollback wrapper, and when even the in-memory
        rollback budget is exhausted, fall back to the newest verified
        checkpoint generation and try once more."""
        self._poll_events()
        try:
            out = self._elastic.run(step_fn, *args, **kw)
        except _RETRYABLE_STEP:
            if self.ckpt is None or self.ckpt.latest() is None:
                raise
            # the whole quiesce -> reload -> re-run window is badput: the
            # goodput ledger prices it under recovery
            _goodput = None
            if _OBS.GOODPUT:
                from ...observability import goodput as _goodput
                _goodput.recovery_begin()
            try:
                self._quiesce(drop=True)
                self.restore_from_checkpoint()
                out = self._elastic.run(step_fn, *args, **kw)
            finally:
                if _goodput is not None:
                    _goodput.recovery_end()
        if self._replan_t0 is not None:
            self.last_replan_latency_s = \
                time.perf_counter() - self._replan_t0
            self._replan_t0 = None
            from ...observability import metrics
            metrics.observe(self._latency_hist,
                            self.last_replan_latency_s * 1e6)
            if self._latency_hist == "resilience.grow_us":
                self.last_grow_latency_s = self.last_replan_latency_s
            self._latency_hist = "resilience.replan_us"
            _note("replan_done",
                  latency_us=int(self.last_replan_latency_s * 1e6))
        # periodic cadence: the ctor's checkpoint_every wins; 0 falls
        # through to FLAGS_checkpoint_interval_steps (0 = off)
        every = self._ckpt_every or int(
            _flags.flag_value("FLAGS_checkpoint_interval_steps") or 0)
        if self.ckpt is not None and every > 0 \
                and self._elastic.step_index % every == 0:
            self.save_checkpoint()
        return out


def _note(event: str, **detail):
    """A flight-recorder note of the trainer (one check when off)."""
    if _OBS.FLIGHT:
        from ...observability import flight
        flight.note("adaptive", event, **detail)


def _spanned(name: str, hist: str, body, *args, **span_args):
    """``body(*args)`` inside span ``name`` while a plane is on."""
    if not _OBS.ACTIVE:
        return body(*args)
    from ...observability.spans import span
    sp = span(name, hist=hist, **span_args).begin()
    try:
        out = body(*args)
    except BaseException as e:
        sp.end(error=e)
        raise
    sp.end()
    return out
