"""Retry / timeout / backoff policies for the transient-failure class: the
counterpart of ``paddle_tpu/distributed/resilience/retry.py``.

A ``RetryPolicy`` re-attempts an operation on *retryable* errors with
exponential backoff and deterministic jitter (derived from the rank, the
policy name and the attempt number, not a global RNG: two runs of the same
failing sequence sleep the same schedule). Applied to the host-side
control plane: TCPStore ops (``store_policy``, ``distributed/store.py``),
process-group bring-up (``bringup_policy``, ``parallel_env.py``), the
eager collectives (``comm_policy``, ``communication.py``), checkpoint I/O
(``ckpt_policy``, ``checkpoint.py``) and the growth broadcast
(``grow_policy``, ``resilience/growth.py``).

Every re-attempt counts ``resilience.retries`` and an exhausted budget
``resilience.gave_up``, each noted in the flight recorder while it is
armed; a first-attempt success does no registry work.
"""
from __future__ import annotations

import time
import zlib
from typing import Callable, Optional, Tuple, Type

from ..._core import flags as _flags
from .faults import RankDeath, TransientFault

# Default retryable classes: injected transients plus the OS-level
# flakiness the store/bring-up paths actually see. RankDeath is a
# FaultError but NOT retryable — its reaction is world-shrink.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    TransientFault, TimeoutError, ConnectionError, InterruptedError)


class StoreOpError(RuntimeError):
    """A TCPStore set/get/wait failed (socket hiccup, busy server, wait
    deadline): the class the store and bring-up policies retry. Raised by
    ``distributed/store.py``, which re-exports it; defined here because
    the store imports this module."""


class RetryPolicy:
    __slots__ = ("name", "max_attempts", "base_delay", "multiplier",
                 "max_delay", "jitter", "retryable", "sleep")

    def __init__(self, name: str = "retry",
                 max_attempts: Optional[int] = None,
                 base_delay: Optional[float] = None,
                 multiplier: float = 2.0, max_delay: float = 5.0,
                 jitter: float = 0.25,
                 retryable: Tuple[Type[BaseException], ...] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.name = name
        # None = read the flag live at run() time (set_flags mid-session
        # takes effect on the next attempt loop, the flags contract)
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.multiplier = multiplier
        self.max_delay = max_delay
        self.jitter = jitter
        self.retryable = retryable or DEFAULT_RETRYABLE
        self.sleep = sleep

    # ---------------------------------------------------------- schedule
    def delay(self, attempt: int) -> float:
        """Backoff before re-attempt `attempt` (1-based count of
        failures so far): exponential, capped, plus a deterministic
        jitter fraction hashed from (rank, name, attempt) — the rank
        term decorrelates N ranks retrying the same op after a shared
        fault (otherwise they all re-hit the single store at the same
        instant), while two identical runs of the same rank still
        sleep the same schedule."""
        base = self.base_delay if self.base_delay is not None \
            else float(_flags.flag_value("FLAGS_retry_backoff_s"))
        d = min(base * (self.multiplier ** (attempt - 1)), self.max_delay)
        import os
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
        frac = (zlib.crc32(f"{rank}:{self.name}:{attempt}".encode())
                & 0xFFFF) / 65535.0
        return d * (1.0 + self.jitter * frac)

    def _is_retryable(self, e: BaseException) -> bool:
        if isinstance(e, RankDeath):
            return False
        return isinstance(e, self.retryable)

    # --------------------------------------------------------------- run
    def run(self, fn: Callable, *args, what: Optional[str] = None, **kw):
        """Call ``fn(*args, **kw)``, re-attempting retryable failures up
        to the attempt budget."""
        budget = self.max_attempts if self.max_attempts is not None \
            else int(_flags.flag_value("FLAGS_retry_max_attempts"))
        budget = max(budget, 1)
        label = what or self.name
        attempt = 0
        while True:
            try:
                return fn(*args, **kw)
            except BaseException as e:
                attempt += 1
                if not self._is_retryable(e) or attempt >= budget:
                    if self._is_retryable(e):
                        from ...observability import metrics
                        metrics.inc("resilience.gave_up")
                        self._flight("gave_up", label, attempt, e)
                    raise
                wait = self.delay(attempt)
                from ...observability import metrics
                metrics.inc("resilience.retries")
                self._flight("retry", label, attempt, e, wait=wait)
                if wait > 0:
                    self.sleep(wait)

    @staticmethod
    def _flight(kind: str, label: str, attempt: int, e: BaseException,
                wait: float = None):
        from ...observability import _state as _OBS
        if not _OBS.FLIGHT:
            return
        from ...observability import flight
        detail = {"attempt": attempt, "error": repr(e)[:160]}
        if wait is not None:
            detail["backoff_s"] = round(wait, 4)
        flight.note(kind, label, **detail)


# ------------------------------------------------------------- presets
# One shared instance per consumer class (policies are stateless between
# run() calls, so sharing is safe); attempt budget and base delay read
# the flags live.

_STORE = RetryPolicy(
    "store", retryable=DEFAULT_RETRYABLE + (OSError, StoreOpError))
_BRINGUP = RetryPolicy(
    "pg_init", multiplier=2.0, max_delay=10.0,
    retryable=DEFAULT_RETRYABLE + (OSError, StoreOpError))
_COMM = RetryPolicy("comm")
_CKPT = RetryPolicy(
    "checkpoint", retryable=DEFAULT_RETRYABLE + (OSError,))
_GROW = RetryPolicy(
    "grow_bcast", retryable=DEFAULT_RETRYABLE + (OSError, StoreOpError))


def store_policy() -> RetryPolicy:
    """TCPStore get/set/add/wait."""
    return _STORE


def bringup_policy() -> RetryPolicy:
    """Process-group construction / transport negotiation."""
    return _BRINGUP


def comm_policy() -> RetryPolicy:
    """Host-driven eager collectives."""
    return _COMM


def ckpt_policy() -> RetryPolicy:
    """Checkpoint file I/O."""
    return _CKPT


def grow_policy() -> RetryPolicy:
    """Survivor->joiner state broadcast through the TCPStore
    (growth.py): chunk publishes and fetches re-attempt the transient
    store class; a checksum mismatch is NOT retried here — the joiner
    falls back to the newest verified checkpoint generation."""
    return _GROW
