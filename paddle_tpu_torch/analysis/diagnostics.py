"""Structured diagnostics of the program sanitizer: the counterpart of
``paddle_tpu/analysis/diagnostics.py``.

Every checker reports through a ``CheckReport`` of ``Diagnostic``s
carrying (checker, severity, op index, op name, provenance, message, fix
hint), machine-readable, so ``error`` mode raises with the full finding
set and tests can assert exact diagnostics. The port's one caller so far
is the world-shrink sweep (``hooks.on_world_shrink``). With the flight
recorder armed, an error-severity finding is noted in its ring and an
error-mode trip dumps it, as the reference's does.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"
# Performance lint severity (perf_checks / sharding_prop findings):
# the program is CORRECT but pays for it — a fusion-window break, a
# host sync, an implicit reshard. Never raises in 'error' mode (a slow
# program must not be stopped like a corrupting one) and never emitted
# by the flush-hook correctness sweep, only by the perf surfaces
# (check_perf / check_sharding / the analysis --perf CLI).
SEVERITY_PERF = "perf"


class StaticCheckWarning(UserWarning):
    """Emitted in FLAGS_static_checks=warn mode; one per CheckReport."""


class StaticCheckError(RuntimeError):
    """Raised in FLAGS_static_checks=error mode. `.report` holds the
    structured findings."""

    def __init__(self, report: "CheckReport"):
        self.report = report
        super().__init__(report.render())
        from ..observability import _state as _obs
        if _obs.FLIGHT:
            # the runtime events that led to the bad plan survive it
            from ..observability import flight
            flight.on_error("static_check", report.render())


class Diagnostic:
    __slots__ = ("checker", "severity", "message", "op_index", "op_name",
                 "provenance", "hint", "data")

    def __init__(self, checker: str, message: str,
                 severity: str = SEVERITY_ERROR,
                 op_index: Optional[int] = None,
                 op_name: Optional[str] = None,
                 provenance: Optional[str] = None,
                 hint: Optional[str] = None,
                 data: Optional[dict] = None):
        self.checker = checker
        self.severity = severity
        self.message = message
        self.op_index = op_index
        self.op_name = op_name
        self.provenance = provenance
        self.hint = hint
        # machine-readable finding payload (input index, donate slot,
        # dead op list, ...) — what fixes.py plans repairs from, so the
        # autofixer never has to re-parse rendered messages
        self.data = data

    def render(self) -> str:
        where = ""
        if self.op_index is not None or self.op_name is not None:
            idx = "?" if self.op_index is None else str(self.op_index)
            where = f" [op #{idx}" + (
                f" {self.op_name}]" if self.op_name else "]")
        src = f" (recorded at {self.provenance})" if self.provenance else ""
        hint = f"\n      hint: {self.hint}" if self.hint else ""
        return (f"{self.severity}: {self.checker}:{where} "
                f"{self.message}{src}{hint}")

    def __repr__(self):
        return f"Diagnostic<{self.render()}>"


class CheckReport:
    """Findings of one sanitizer run over one program/segment."""

    def __init__(self, subject: str = ""):
        self.subject = subject
        self.diagnostics: List[Diagnostic] = []

    def add(self, checker: str, message: str, **kw) -> Diagnostic:
        d = Diagnostic(checker, message, **kw)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "CheckReport"):
        self.diagnostics.extend(other.diagnostics)
        return self

    def by_checker(self, checker: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.checker == checker]

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == SEVERITY_ERROR]

    def render(self) -> str:
        head = (f"static checks: {len(self.diagnostics)} finding(s)"
                + (f" in {self.subject}" if self.subject else ""))
        return "\n".join([head] + ["  " + d.render()
                                   for d in self.diagnostics])

    def to_dict(self) -> dict:
        """JSON-shaped report (the analysis CLI's --json payload)."""
        return {
            "subject": self.subject,
            "findings": len(self.diagnostics),
            "diagnostics": [
                {"checker": d.checker, "severity": d.severity,
                 "message": d.message, "op_index": d.op_index,
                 "op_name": d.op_name, "provenance": d.provenance,
                 "hint": d.hint, "data": d.data}
                for d in self.diagnostics],
        }

    def account(self):
        """Fold the findings into the observability registry: one
        `sanitizer.diagnostics.<checker>` counter bump per diagnostic
        (unconditional: this path only runs in warn/error/fix mode), and
        a flight-recorder note of each error-severity finding."""
        if not self.diagnostics:
            return
        from ..observability import _state as _obs
        from ..observability import metrics
        for d in self.diagnostics:
            metrics.inc("sanitizer.diagnostics." + d.checker)
            if d.severity == SEVERITY_ERROR and _obs.FLIGHT:
                from ..observability import flight
                flight.note("sanitz", d.checker,
                            op=d.op_name, message=d.message[:160])

    def emit(self, mode: str, stacklevel: int = 3):
        """Surface the findings per FLAGS_static_checks semantics:
        'error' raises when any error-severity finding exists (warnings
        still warn); 'warn' warns; 'fix' warns for whatever the
        autofixer could not repair (callers emit the residual report);
        'off' is a no-op."""
        if not self.diagnostics or mode == "off":
            return
        self.account()
        if mode == "error" and self.errors:
            raise StaticCheckError(self)
        warnings.warn(self.render(), StaticCheckWarning,
                      stacklevel=stacklevel)

    def __repr__(self):
        return (f"CheckReport({self.subject!r}, "
                f"{len(self.diagnostics)} diagnostics)")
