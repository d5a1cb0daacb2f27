"""Distributed program passes, the counterpart of
``paddle_tpu/distributed/passes/__init__.py`` (upstream
``python/paddle/distributed/passes/``) over the port's ``ir`` and
``static`` (``ir/pass_base.py`` ``Workspace`` / ``Pass``).

- ``ShardingCompletionPass``: the completion analog. Given seed
  placements on feeds and parameters (``DistContext``), it propagates a
  ``TensorDistAttr`` through every recorded op with the per-op SPMD rules
  (``auto_parallel/spmd_rules.py``) and records the ``PartitionSpec`` of
  each materialized sharded value in ``ws.shardings``; the partitioner
  (``auto_parallel/partitioner.py``) reads the attrs to emit each rank's
  program with its collectives.

The strategy program passes live at the bottom of this module:
``GradientMergePass`` (the 1/k loss rescale and the k-step contract in
``ws.meta``; the accumulation loop itself is ``Engine.fit``'s),
``RecomputeProgramPass`` (recompute segments recorded in
``ws.meta["remat_segments"]``) and the IR ``AutoMixedPrecisionPass``
reused for amp.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ...ir.pass_base import Pass, Workspace
from ..auto_parallel import spmd_rules as R
from ..mesh import ProcessMesh
from ..placements import Placement


class DistContext:
    """Holds the mesh and the per-Variable dist attrs decided so far
    (auto_parallel/static/dist_context.py analog)."""

    def __init__(self, mesh: ProcessMesh):
        self.mesh = mesh
        self.attrs: Dict[int, R.TensorDistAttr] = {}

    def shard(self, var, placements: Sequence[Placement]):
        """Seed a placement decision for a feed var or captured param."""
        if hasattr(var, "var_shape"):       # static.Variable placeholder
            ndim = len(var.var_shape)
        elif hasattr(var, "ndim"):
            ndim = var.ndim
        else:
            ndim = len(var.shape)
        self.attrs[id(var)] = R.from_placements(placements, ndim)
        return self

    def attr_of(self, var) -> Optional[R.TensorDistAttr]:
        return self.attrs.get(id(var))


class ShardingCompletionPass(Pass):
    """Forward dist-attr propagation over the recorded graph."""

    name = "auto_parallel_completion"

    def __init__(self, ctx: DistContext):
        self.ctx = ctx

    def _attr_for(self, ws, t):
        from ...static import Variable
        if t is None:
            return None
        if isinstance(t, Variable):
            t = ws.resolve(t)
        a = self.ctx.attrs.get(id(t))
        if a is not None:
            return a
        ndim = (len(t.var_shape) if hasattr(t, "var_shape")
                else (t.ndim if hasattr(t, "ndim")
                      else getattr(t, "ndim", 0)))
        return R.TensorDistAttr([-1] * ndim)

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        mesh = self.ctx.mesh
        changed = False
        from ...static import Variable
        for node in ws.ops:
            in_attrs = [self._attr_for(ws, t) for t in node.inputs
                        if t is not None]
            if not in_attrs:
                continue
            attrs = dict(node.attrs)
            if node.op_name == "reshape" and isinstance(
                    node.inputs[0], Variable):
                attrs.setdefault("x_shape", node.inputs[0].var_shape)
            try:
                inferred, outs = R.resolve(node.op_name, in_attrs, **attrs)
            except Exception:
                inferred, outs = R.default_replicated(*in_attrs)
            for var, attr in zip(node.outputs, outs):
                if attr.ndim != len(var.var_shape):
                    continue  # rule lacked shape info; leave unplaced
                self.ctx.attrs[id(var)] = attr
                # only materialized (non-partial) placements are recorded;
                # a Partial tensor stays unreduced until the all-reduce the
                # partitioner puts after its producer
                if not attr.partial_status and not attr.is_replicated():
                    ws.shardings[id(var)] = R.to_partition_spec(
                        attr, mesh.dim_names)
                    changed = True
        return changed


def apply_completion(program, mesh: ProcessMesh,
                     seed_placements: Dict) -> DistContext:
    """Convenience: build a DistContext seeded with {var: placements}."""
    ctx = DistContext(mesh)
    for var, pl in seed_placements.items():
        ctx.shard(var, pl)
    return ctx


__all__ = ["DistContext", "ShardingCompletionPass", "apply_completion"]


# ------------------------------------------------ strategy program passes
# Upstream's distributed program-pass family
# (passes/auto_parallel_amp.py, auto_parallel_gradient_merge.py,
# auto_parallel_recompute.py), runnable from Engine strategies through
# Executor.run(extra_passes=...).

class GradientMergePass(Pass):
    """auto_parallel_gradient_merge.py analog: rewrite the program so
    one micro-step contributes loss/k (avg mode), and record the
    accumulation contract in ws.meta for the runner (which steps the
    optimizer every k micro-batches)."""

    name = "auto_parallel_gradient_merge"

    def __init__(self, k_steps: int, avg: bool = True):
        self.k = int(k_steps)
        self.avg = bool(avg)

    def run(self, ws, protected) -> bool:
        if self.k <= 1:
            return False
        meta = getattr(ws, "meta", None)
        if meta is None:
            ws.meta = meta = {}
        if "gradient_merge" in meta:
            return False  # idempotent under fixpoint pass managers
        applied = []
        from ...static import OpNode, Variable
        if self.avg and ws.ops:
            # scale every protected (fetched-loss) output by 1/k, using
            # the producer-rename idiom: the producer writes a fresh
            # @RAW var and a scale op re-materializes the ORIGINAL
            # variable, so no alias cycles and the fetch is untouched
            for loss in list(protected_vars(ws, protected)):
                if any(any(t is loss for t in n.inputs)
                       for n in ws.ops):
                    continue  # only a terminal loss is safe to rescale
                raw = Variable(f"{loss.name}@RAW", loss.var_shape,
                               loss.var_dtype, ws.program)
                for n in ws.ops:
                    for i, o in enumerate(n.outputs):
                        if o is loss:
                            n.outputs[i] = raw
                ws.ops.append(OpNode(
                    "scale", {"scale": 1.0 / self.k, "bias": 0.0,
                              "bias_after_scale": True}, [raw], [loss]))
                applied.append(loss.name)
        # honest contract: record whether the 1/k average actually
        # landed (a consumed loss cannot be terminally rescaled)
        meta["gradient_merge"] = {
            "k_steps": self.k, "avg": self.avg,
            "avg_applied": bool(applied) if self.avg else False,
            "scaled_losses": applied}
        return True


class RecomputeProgramPass(Pass):
    """auto_parallel_recompute.py analog: segment the op stream into
    recompute regions recorded in ws.meta["remat_segments"], for a runner
    that keeps only each region's inputs for the backward (the static
    Executor replays without gradients, where a region changes
    nothing)."""

    name = "auto_parallel_recompute"

    def __init__(self, segments: int = None):
        if segments is None:
            from ..._core.flags import flag_value
            segments = flag_value("FLAGS_recompute_segments")
        self.segments = max(int(segments), 1)

    def run(self, ws, protected) -> bool:
        n = len(ws.ops)
        if n == 0:
            return False
        meta = getattr(ws, "meta", None)
        if meta is None:
            ws.meta = meta = {}
        per = max(-(-n // self.segments), 1)
        meta["remat_segments"] = [
            (i, min(i + per, n)) for i in range(0, n, per)]
        return True


def protected_vars(ws, protected):
    from ...static import Variable
    for node in ws.ops:
        for var in node.outputs:
            if id(var) in protected and isinstance(var, Variable):
                yield var


def build_strategy_passes(strategy, dist_ctx=None):
    """Engine-strategy -> program-pass pipeline (the reference builds
    the same list in engine.py _apply_pre_optimization)."""
    passes = []
    if getattr(strategy.amp, "enable", False):
        from ...ir.passes import AutoMixedPrecisionPass
        passes.append(AutoMixedPrecisionPass(
            dtype=strategy.amp.dtype or "bfloat16"))
    if getattr(strategy.recompute, "enable", False):
        passes.append(RecomputeProgramPass())
    if getattr(strategy.gradient_merge, "enable", False):
        passes.append(GradientMergePass(
            strategy.gradient_merge.k_steps,
            avg=strategy.gradient_merge.get("avg", True)))
    if dist_ctx is not None:
        passes.append(ShardingCompletionPass(dist_ctx))
    return passes


__all__ += ["GradientMergePass", "RecomputeProgramPass",
            "build_strategy_passes"]
