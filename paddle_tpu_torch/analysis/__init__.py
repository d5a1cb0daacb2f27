"""The counterpart of ``paddle_tpu/analysis``, so far what the world-shrink
sweep needs: the structured diagnostics (``diagnostics``), the distributed
checkers (``distributed_checks``: reshard placements and pipeline
schedules) and the one hook that runs them (``hooks.on_world_shrink``).

The rest of the program sanitizer (``FLAGS_static_checks``, the segment,
program and SOT checkers, autofix, the perf lints, the planner and the
CLI) is ``ROADMAP.md`` §1 item 9.
"""
from __future__ import annotations

from . import diagnostics, distributed_checks, hooks  # noqa: F401
from .diagnostics import (CheckReport, Diagnostic,  # noqa: F401
                          StaticCheckError, StaticCheckWarning)
