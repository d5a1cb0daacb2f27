"""The sanitizer's runtime hook for world-shrink recovery and the call-site
provenance of a record-time diagnostic: the counterparts of
``on_world_shrink`` and ``call_site`` of ``paddle_tpu/analysis/hooks.py``.

The reference's other hooks (the segment flush, the pass manager, the
reshard lowering, the pipeline runtime's construction, the SOT guards)
run under ``FLAGS_static_checks``, which the port does not define yet
(``ROADMAP.md`` §1 item 9). This one runs whatever that flag would say.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

# the installed package directory (not a name substring: user code under a
# path that contains the package's name still gets provenance) and the
# standard library's, whose frames (runpy starting a -m CLI, threading
# glue) are plumbing
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) \
    + os.sep
_STDLIB_DIR = os.path.dirname(os.__file__) + os.sep
_IS_FRAMEWORK_FILE: dict = {}   # co_filename -> bool (abspath memo)


def call_site() -> Optional[str]:
    """'file:line' of the first user frame below the framework: the Python
    source a record-time diagnostic (the NaN/Inf scan's message, the
    compute plane's op scopes) points at. Stdlib and frozen bootstrap
    frames are skipped; "<stdin>" and "<string>" stay user frames."""
    f = sys._getframe(1)
    while f is not None:
        fname = f.f_code.co_filename
        fw = _IS_FRAMEWORK_FILE.get(fname)
        if fw is None:
            ap = os.path.abspath(fname)
            fw = ap.startswith(_PKG_DIR) \
                or ap.startswith(_STDLIB_DIR) \
                or fname.startswith("<frozen")
            _IS_FRAMEWORK_FILE[fname] = fw
        if not fw:
            return f"{fname}:{f.f_lineno}"
        f = f.f_back
    return None


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
