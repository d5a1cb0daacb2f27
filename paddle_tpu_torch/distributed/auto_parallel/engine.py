"""Auto-parallel Engine, the counterpart of
``paddle_tpu/distributed/auto_parallel/engine.py`` (upstream
``auto_parallel/static/engine.py:99``; ``.fit:1562``, ``.prepare:2015``;
``dist.to_static`` at ``auto_parallel/api.py:2988``).

``Engine`` drives eager train, eval and predict loops on the current mesh,
as the reference's does: each rank runs the model on what it holds, and
the model's layers carry their own collectives (the port's eager
multi-process regime). Strategy toggles map: amp -> ``amp.auto_cast``,
recompute -> ``fleet.recompute`` around the forward, gradient_merge ->
accumulation steps. ``Engine.build_rank_programs`` is the static build
path: the strategy program passes, completion and the partitioner over a
recorded ``static.Program``, one rank-local program per mesh coordinate
(run composed by ``partitioner.run_partitioned``). ``cost`` and ``tune``
hand the model's parameter count and the mesh's degrees to the auto
tuner.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...io import DataLoader, Dataset
from ..mesh import ProcessMesh, get_mesh, set_mesh


class Strategy:
    """auto_parallel Strategy (reference strategy.py): nested toggle
    groups with the reference's names."""

    class _Group(dict):
        __getattr__ = dict.get

        def __setattr__(self, k, v):
            self[k] = v

    def __init__(self, config=None):
        c = config or {}

        def group(name, **defaults):
            defaults.update(c.get(name, {}))
            return Strategy._Group(defaults)

        self.amp = group("amp", enable=False, dtype="bfloat16", level="O1")
        self.recompute = group("recompute", enable=False)
        self.sharding = group("sharding", enable=False, stage=1, degree=-1)
        self.gradient_merge = group("gradient_merge", enable=False,
                                    k_steps=1, avg=True)
        self.pipeline = group("pipeline", enable=False,
                              schedule_mode="1F1B", micro_batch_size=1,
                              accumulate_steps=1)


class Engine:
    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 strategy: Optional[Strategy] = None, cluster=None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics else [])
        self._strategy = strategy or Strategy()
        self._prepared = False
        self.history = None

    # ---------------------------------------------------------- prepare
    def prepare(self, inputs_spec=None, labels_spec=None, mode="train"):
        """engine.py:2015: upstream builds and partitions the program
        here; the eager loops need only a mesh installed (a one-rank
        ``dp`` mesh when there is none)."""
        if get_mesh() is None:
            # a one-rank mesh keeps the flow uniform
            set_mesh(ProcessMesh(np.array([0]), ["dp"]))
        self._prepared = True
        return self

    def _forward(self, *inputs):
        if self._strategy.recompute.enable:
            from ..fleet.recompute import recompute
            return recompute(self._model, *inputs)
        return self._model(*inputs)

    def _loader(self, data, batch_size):
        if isinstance(data, DataLoader) or data is None:
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=False)
        return data

    def _amp_ctx(self):
        from ...amp import auto_cast
        s = self._strategy.amp
        if s.enable:
            return auto_cast(enable=True, level=s.level or "O1",
                             dtype=s.dtype or "bfloat16")
        import contextlib
        return contextlib.nullcontext()

    # -------------------------------------------------------------- fit
    def fit(self, train_data, train_sample_split=None, batch_size=1,
            epochs=1, steps_per_epoch=None, log_freq=10, save_dir=None,
            save_freq=1, valid_data=None, valid_sample_split=None,
            valid_freq=1, valid_steps=None, collate_fn=None,
            callbacks=None, verbose=0, nvprof_range=(-1, -1)):
        if not self._prepared:
            self.prepare()
        loader = self._loader(train_data, batch_size)
        k_steps = max(self._strategy.gradient_merge.k_steps, 1) if \
            self._strategy.gradient_merge.enable else 1
        history = {"loss": [], "eval_loss": []}
        total_step = 0
        for epoch in range(epochs):
            accum = 0
            for epoch_step, batch in enumerate(loader):
                inputs, labels = batch[:-1], batch[-1]
                with self._amp_ctx():
                    out = self._forward(*inputs)
                    loss = self._loss(out, labels)
                (loss / k_steps).backward()
                accum += 1
                if accum % k_steps == 0:
                    self._optimizer.step()
                    self._optimizer.clear_grad()
                history["loss"].append(float(loss.numpy()))
                total_step += 1
                if verbose and total_step % log_freq == 0:
                    print(f"[AutoParallel Engine] epoch {epoch} step "
                          f"{total_step} loss "
                          f"{history['loss'][-1]:.4f}")
                if steps_per_epoch and epoch_step + 1 >= steps_per_epoch:
                    break
            if accum % k_steps:
                # flush tail micro-batches so partial merges don't bleed
                # into the next epoch's first merge group
                self._optimizer.step()
                self._optimizer.clear_grad()
            if valid_data is not None and (epoch + 1) % max(valid_freq,
                                                           1) == 0:
                res = self.evaluate(valid_data, batch_size=batch_size,
                                    steps=valid_steps, verbose=verbose)
                history["eval_loss"].append(res["loss"][0])
        self.history = history
        return history

    def evaluate(self, valid_data, valid_sample_split=None, batch_size=1,
                 steps=None, log_freq=10, collate_fn=None, callbacks=None,
                 verbose=0):
        if not self._prepared:
            self.prepare()
        from ..._core.autograd import no_grad
        loader = self._loader(valid_data, batch_size)
        losses = []
        with no_grad():
            for i, batch in enumerate(loader):
                inputs, labels = batch[:-1], batch[-1]
                out = self._model(*inputs)
                losses.append(float(self._loss(out, labels).numpy()))
                if steps and i + 1 >= steps:
                    break
        return {"loss": [float(np.mean(losses))] if losses else [0.0]}

    def predict(self, test_data, test_sample_split=None, batch_size=1,
                steps=None, collate_fn=None, callbacks=None, verbose=0):
        if not self._prepared:
            self.prepare()
        from ..._core.autograd import no_grad
        loader = self._loader(test_data, batch_size)
        outs = []
        with no_grad():
            for i, batch in enumerate(loader):
                inputs = batch[:-1] if len(batch) > 1 else batch
                outs.append(self._model(*inputs))
                if steps and i + 1 >= steps:
                    break
        return outs

    # -------------------------------------------------------- save/load
    def save(self, path, training=True):
        from ... import save as _save
        _save(self._model.state_dict(), path + ".pdparams")

    def load(self, path, strict=True, load_optimizer=True):
        from ... import load as _load
        self._model.set_state_dict(_load(path + ".pdparams"))
        return self

    def cost(self, mode="train", **overrides):
        """Predicted (seconds/step, bytes/card) for THIS model on the
        current mesh (reference engine.cost / engine.py:cost): the real
        parameter count and the mesh's dp/mp/pp degrees feed the
        auto_tuner analytic model; kwargs override any knob."""
        from ..auto_tuner.cost_model import (estimate_memory,
                                             estimate_step_cost)
        cfg = {}
        mesh = get_mesh()
        if mesh is not None:
            for axis, size in zip(mesh.dim_names, mesh.shape):
                if axis in ("dp", "mp", "pp"):
                    cfg[f"{axis}_degree"] = int(size)
        n = self._n_params()
        if n:
            cfg["n_params"] = n
        cfg.update(overrides)
        return {"step_time": estimate_step_cost(cfg),
                "memory": estimate_memory(cfg)}

    def _n_params(self) -> int:
        if self._model is None:
            return 0
        return int(sum(p._t.numel() for p in self._model.parameters()))

    def tune(self, world_size=None, tune_space=None, max_trials=0,
             run_trials=False):
        """Search parallel configs for this model (reference
        auto_tuner entry): analytic ranking, optionally refined by real
        subprocess trial jobs."""
        from ..auto_tuner import AutoTuner, measure_step_time
        cfg = {}
        n = self._n_params()
        if n:
            cfg["n_params"] = n
        if run_trials and max_trials <= 0:
            max_trials = 3   # "run trials" must actually run some
        tuner = AutoTuner(
            cfg, world_size or _device_count(),
            tune_space=tune_space,
            trial_fn=measure_step_time if run_trials else None,
            max_trials=max_trials)
        return tuner.tune()


def _device_count() -> int:
    """The cards on a card, else the world's ranks (the reference counts
    its devices)."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    from ..parallel_env import get_world_size
    return get_world_size()


def to_static(layer=None, loader=None, loss=None, optimizer=None,
              strategy=None):
    """dist.to_static (api.py:2988): wrap dygraph pieces into an Engine
    ready to fit on the current mesh."""
    e = Engine(model=layer, loss=loss, optimizer=optimizer,
               strategy=strategy)
    e.prepare()
    return e


# ---------------------------------------------------- static partitioning
def _engine_build_rank_programs(self, program, fetch_var,
                                mesh: Optional[ProcessMesh] = None,
                                seed_placements=None):
    """The reference Engine's build path (engine.py _build ->
    completion -> Partitioner -> passes): run the strategy program
    passes + completion over the recorded static Program, then emit one
    rank-local program per mesh coordinate. Returns
    (rank_programs, workspace, dist_ctx)."""
    from ...ir import Workspace
    from ..passes import (DistContext, ShardingCompletionPass,
                          build_strategy_passes)
    from .partitioner import Partitioner

    mesh = mesh or get_mesh()
    if mesh is None:
        raise ValueError("build_rank_programs needs a ProcessMesh")
    ctx = DistContext(mesh)
    for var, pl in (seed_placements or {}).items():
        ctx.shard(var, pl)
    ws = Workspace(program)
    protected = frozenset([id(fetch_var)])
    for p in build_strategy_passes(self._strategy):
        p.run(ws, protected)
    ShardingCompletionPass(ctx).run(ws, protected)
    stage_map = None
    if "pp" in mesh.dim_names:
        # cost-based stage cuts (planner_v2 role) instead of uniform
        # op-count splitting
        from .planner import plan_stage_map
        n_stages = mesh.shape[mesh.dim_names.index("pp")]
        stage_map = plan_stage_map(ws, n_stages)
    parts = Partitioner(ctx, mesh,
                        stage_map=stage_map).partition_all(ws)
    return parts, ws, ctx


Engine.build_rank_programs = _engine_build_rank_programs
