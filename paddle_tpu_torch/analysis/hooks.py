"""The sanitizer's runtime hook for world-shrink recovery: the counterpart
of ``on_world_shrink`` of ``paddle_tpu/analysis/hooks.py``.

The reference's other hooks (the segment flush, the pass manager, the
reshard lowering, the pipeline runtime's construction, the SOT guards)
run under ``FLAGS_static_checks``, which the port does not define yet
(``ROADMAP.md`` §1 item 9). This one runs whatever that flag would say.
"""
from __future__ import annotations


def on_world_shrink(transitions, pipeline=None):
    """Post-recovery validation (``resilience.shrink_world`` and
    ``grow_world``): every planned reshard transition, and the new
    pipeline schedule when one is in play, is checked BEFORE anything
    moves. Always in 'error' semantics: recovering onto a broken layout
    (out-of-range shard, uneven split, deadlocking schedule over the new
    world) is worse than failing loudly.

    ``transitions`` is a list of (val_ndim, src_attr, dst_attr,
    global_shape); ``pipeline`` is (schedule, pp_size, num_micro,
    num_chunks) or None."""
    from ..observability import metrics
    metrics.counter("sanitizer.shrink_sweeps").inc()
    from .diagnostics import CheckReport
    from .distributed_checks import check_pipeline_schedule, check_reshard
    report = CheckReport("world-shrink recovery plan")
    for val_ndim, src, dst, gshape in transitions:
        check_reshard(val_ndim, src, dst, report, global_shape=gshape)
    if pipeline is not None:
        schedule, pp_size, num_micro, num_chunks = pipeline
        check_pipeline_schedule(schedule, pp_size, num_micro,
                                num_chunks, report=report)
    report.emit("error", stacklevel=4)
    return report
