"""Deterministic fault injection (``FLAGS_fault_inject``): the counterpart
of ``paddle_tpu/distributed/resilience/faults.py``.

A ``FaultPlan`` injects failures at *named sites*. The port's sites so far
are the checkpoint's, ``ckpt::save`` and ``ckpt::load``
(``distributed/checkpoint.py``); the store, process-group, collective,
compile and elastic-step sites of the reference come with
``ElasticStep`` and the store's retry policy (``ROADMAP.md`` §1 item
8.7). ``inject(site)`` is the hook a site calls; ``ACTIVE`` says whether a
plan is armed, kept in step with the flag by a watcher.

Plan grammar (semicolon- or comma-separated entries), the reference's::

    seed=N                      # seeds the probabilistic draws
    <site>[@occ]=<kind>[(arg)][:prob]

- ``site`` names an injection point; a trailing ``*`` wildcards
  (``ckpt::*``).
- ``@occ`` fires on the occ-th *matching occurrence* (1-based); omitted =
  the first occurrence only (so a retry of the same site succeeds).
  ``@*`` fires on every occurrence.
- ``kind``: ``fail`` (raise ``TransientFault``), ``die`` (raise
  ``RankDeath``, not retryable), ``delay(s)`` (sleep s seconds, then
  proceed), ``stuck(s)`` (sleep s seconds, then raise
  ``CollectiveTimeout``), ``oom`` (raise ``ResourceExhausted``).
- ``:prob`` makes the entry probabilistic; draws come from a per-entry
  ``random.Random`` seeded by (seed, entry index), so the same seed and
  the same call sequence give the same injection schedule as the
  reference's.

The reference also counts each injected fault (``resilience.*``) and
notes it in its flight recorder; both wait for the measurement plane
(``ROADMAP.md`` §1 item 9).
"""
from __future__ import annotations

import re
import threading
import time
from typing import List, Optional, Tuple

from ..._core import flags as _flags


class FaultError(Exception):
    """Base class for injected faults; carries the site and kind."""

    def __init__(self, site: str, kind: str, occurrence: int):
        self.site = site
        self.kind = kind
        self.occurrence = occurrence
        super().__init__(
            f"injected fault '{kind}' at {site} "
            f"(occurrence {occurrence}, FLAGS_fault_inject)")


class TransientFault(FaultError):
    """Retryable: a dropped message, transient compile failure, flaky
    transfer — the class RetryPolicy re-attempts."""


class CollectiveTimeout(TransientFault):
    """A collective that stalled past its deadline (the watchdog's
    quarry). Retryable: re-running the collective can succeed."""


class RankDeath(FaultError):
    """A peer rank is gone. NOT retryable — the reaction is rollback +
    world-shrink over the survivors, not a retry of the same op."""


class ResourceExhausted(FaultError):
    """A synthetic out-of-memory error (kind ``oom``), with the status
    name the reference's execute sites match on. Not retryable."""

    def __init__(self, site: str, kind: str, occurrence: int):
        FaultError.__init__(self, site, kind, occurrence)
        self.args = (self.args[0]
                     + " [synthetic RESOURCE_EXHAUSTED: out of memory]",)


_DELAY_KINDS = ("delay", "stuck")
_RAISE = {"fail": TransientFault, "drop": TransientFault,
          "die": RankDeath, "stuck": CollectiveTimeout,
          "oom": ResourceExhausted}

_ENTRY_RE = re.compile(
    r"^(?P<site>[^@=]+?)(?:@(?P<occ>\*|\d+))?="
    r"(?P<kind>[a-z]+)(?:\((?P<arg>[0-9.]+)\))?(?::(?P<prob>[0-9.]+))?$")


class _Rule:
    __slots__ = ("site", "occ", "kind", "arg", "prob", "rng", "index")

    def __init__(self, site, occ, kind, arg, prob, seed, index):
        self.site = site
        self.occ = occ              # int occurrence, or None = every
        self.kind = kind
        self.arg = arg
        self.prob = prob
        self.index = index
        import random
        # per-rule stream: draws depend only on (seed, rule index) and
        # the matching-call order — same seed => same schedule
        self.rng = random.Random(seed * 1000003 + index) \
            if prob is not None else None

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site


class FaultPlan:
    """Parsed FLAGS_fault_inject plan. Thread-safe; ``fire(site)`` is
    called by every instrumented site while the plan is armed."""

    def __init__(self, spec: str, sleep=time.sleep):
        self.spec = spec
        self.seed = 0
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counts: dict = {}          # rule -> matching occurrences
        self.fired: List[Tuple[str, int, str]] = []
        self.rules: List[_Rule] = []
        entries = [e.strip() for e in re.split(r"[;,]", spec) if e.strip()]
        # seed= entries apply to every rule, wherever they appear
        for e in entries:
            if e.startswith("seed="):
                self.seed = int(e[5:])
        idx = 0
        for e in entries:
            if e.startswith("seed="):
                continue
            m = _ENTRY_RE.match(e)
            if m is None:
                raise ValueError(
                    f"FLAGS_fault_inject: cannot parse entry {e!r} "
                    f"(expected 'site[@occ]=kind[(arg)][:prob]')")
            kind = m.group("kind")
            if kind not in _RAISE and kind not in _DELAY_KINDS:
                raise ValueError(
                    f"FLAGS_fault_inject: unknown kind {kind!r} in "
                    f"{e!r} (fail | die | delay(s) | stuck(s) | oom)")
            occ = m.group("occ")
            occ = None if occ == "*" else (1 if occ is None else int(occ))
            arg = float(m.group("arg")) if m.group("arg") else 0.0
            prob = float(m.group("prob")) if m.group("prob") else None
            self.rules.append(_Rule(m.group("site").strip(), occ, kind,
                                    arg, prob, self.seed, idx))
            idx += 1

    # ------------------------------------------------------------- fire
    def fire(self, site: str) -> None:
        """Evaluate every matching rule for this occurrence of `site`;
        sleeps and/or raises per the plan."""
        act: Optional[_Rule] = None
        occurrence = 0
        with self._lock:
            for r in self.rules:
                if not r.matches(site):
                    continue
                n = self._counts.get(r.index, 0) + 1
                self._counts[r.index] = n
                if r.occ is not None and n != r.occ:
                    continue
                if r.rng is not None and r.rng.random() >= r.prob:
                    continue
                if act is None:       # first matching rule wins
                    act = r
                    occurrence = n
            if act is not None:
                self.fired.append((site, occurrence, act.kind))
        if act is None:
            return
        if act.kind in _DELAY_KINDS and act.arg:
            self._sleep(act.arg)
        exc = _RAISE.get(act.kind)
        if exc is not None:
            raise exc(site, act.kind, occurrence)

    def reset(self):
        """Forget occurrence counts and the fired log (rule RNG streams
        are NOT rewound — build a fresh plan for a fresh schedule)."""
        with self._lock:
            self._counts.clear()
            self.fired = []


# --------------------------------------------------------- module gate
# True while FLAGS_fault_inject names a plan, with the parsed plan
# attached; the watcher below keeps both in step with the environment and
# every set_flags.
ACTIVE = False
_PLAN: Optional[FaultPlan] = None


def _sync_plan(value):
    global ACTIVE, _PLAN
    spec = str(value).strip()
    _PLAN = FaultPlan(spec) if spec else None
    ACTIVE = _PLAN is not None


_flags.watch_flag("FLAGS_fault_inject", _sync_plan)


def plan() -> Optional[FaultPlan]:
    return _PLAN


def inject(site: str) -> None:
    """The site hook: no-op unless a plan is armed. Callers pre-gate on
    this module's ``ACTIVE``."""
    p = _PLAN
    if p is not None:
        p.fire(site)
