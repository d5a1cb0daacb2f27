"""The off-thread segment-flush executor: the counterpart of
``paddle_tpu/_core/async_flush.py`` (``FLAGS_async_flush``, off by
default, as in the reference).

``CaptureContext.flush`` seals a segment at the cap or at the end of a
guard and hands it to one FIFO worker; the recording thread resumes at
once, with every live output bound to a ``PendingValue`` that carries the
recorded metadata and materializes at the next read.

- Ordering: one worker, FIFO, so segments run in the order they were
  sealed. Work on the recording thread that shares the stream or writes
  payloads in place (a synchronous flush, a fused backward, an optimizer
  step, an eager op) waits for the worker first (``quiesce``).
- Device, stream and modes: the worker runs each segment under the
  recording thread's device and current CUDA stream (the current stream
  is per thread in torch), and the runner re-enters each op's recorded
  grad mode (per thread too) and AMP rule.
- Errors: a worker failure fails every ``PendingValue`` of its segment and
  is latched by the executor; the next sync point (a read, ``drain()``)
  re-raises it with its original type.
- Backpressure: ``submit`` blocks while ``max_inflight`` segments are
  queued or running. Shutdown drains and joins the worker, at exit too.

A worker's error keeps its own type through the latch, so an injected
``FaultError`` (``segment::compile``, ``exec::oom``) or a
``StaticCheckError`` reaches ``ElasticStep`` as what it is; the elastic
step drains the executor before its snapshot and discards the failed
step's latched errors before its restore (``drain(raise_latched=False)``).

A latched error triggers the distributed telemetry's postmortem while
``FLAGS_distributed_telemetry`` is on; an out-of-memory error arrives
already typed (``ResourceExhaustedError``: the lazy window's worker job
converts it). Left out: the reference's ``EnforceNotMet`` wrapping of other
foreign errors (the port re-raises the original error).
"""
from __future__ import annotations

import atexit
import queue
import threading
from typing import Any, Callable, List, Optional

from . import lazy

_WORKER_NAME = "paddle_tpu_torch-flush-worker"


class PendingValue(lazy._Deferred):
    """Placeholder payload for one output of an in-flight segment: the
    recorded metadata, and ``resolve()``, which blocks until the worker
    lands the value (or re-raises its error)."""

    _is_pending_value = True
    __slots__ = ("shape", "dtype", "device", "requires_grad", "_event",
                 "_value", "_error", "__weakref__")

    def __init__(self, meta):
        self.shape, self.dtype, self.device, self.requires_grad = meta
        self._event = threading.Event()
        self._value = None
        self._error = None

    def add_tref(self, tensor):
        pass

    def done(self) -> bool:
        return self._event.is_set()

    def _fill(self, value):
        self._value = value
        self._event.set()

    def _fail(self, error: BaseException):
        self._error = error
        self._event.set()

    def resolve(self):
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._value

    def materialize(self, tensor):
        v = self.resolve()
        if tensor._payload is self:
            tensor._payload = v
        return v


lazy.DEFERRED.add(PendingValue)


def resolve_pending(vals) -> list:
    """Every ``PendingValue`` in a payload list resolved (blocking)."""
    return [v.resolve() if v.__class__ is PendingValue else v for v in vals]


_MAX_INFLIGHT = 4


class FlushExecutor:
    """Single-worker FIFO executor for sealed segments."""

    def __init__(self, max_inflight: int = _MAX_INFLIGHT):
        self._max_inflight = max(int(max_inflight), 1)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._latched: List[BaseException] = []
        self._stopped = False

    def _ensure_worker_locked(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._loop, name=_WORKER_NAME,
                                        daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except BaseException as e:   # latched, surfaced at sync
                with self._lock:
                    self._latched.append(e)
                from ..observability import _state as _OBS
                if _OBS.DIST:
                    # a latched worker error triggers the distributed
                    # postmortem now, before the ring wraps past the
                    # failing flush (never raises)
                    from ..observability import distributed as _dtel
                    _dtel.trigger_postmortem(
                        f"async_flush worker error: {e!r}")
            finally:
                with self._idle:
                    self._inflight -= 1
                    self._idle.notify_all()

    def submit(self, fn: Callable[[], Any]):
        """Queue one sealed-segment job; blocks while ``max_inflight``
        jobs are queued or running (waiting on the condition, which
        releases the lock the worker needs to finish one)."""
        with self._idle:
            while not self._stopped \
                    and self._inflight >= self._max_inflight:
                self._idle.wait()
            if self._stopped:
                raise RuntimeError("flush executor is shut down")
            self._inflight += 1
            self._ensure_worker_locked()
            self._q.put(fn)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def drain(self, raise_latched: bool = True):
        """Block until every submitted job finished; re-raise the first
        worker error latched since the last drain (or discard them)."""
        with self._idle:
            while self._inflight:
                self._idle.wait()
            errs, self._latched = self._latched, []
        if raise_latched and errs:
            raise errs[0]

    def shutdown(self, timeout: float = 5.0):
        """Drain, stop the worker and join it; latched errors of unread
        jobs are discarded."""
        with self._idle:
            if self._stopped:
                return
            self._stopped = True
            self._idle.notify_all()
            while self._inflight:
                self._idle.wait()
            self._latched = []
            th = self._thread
            self._q.put(None)
        if th is not None:
            th.join(timeout)


_EXECUTOR: Optional[FlushExecutor] = None
_EXEC_LOCK = threading.Lock()


def get_executor() -> FlushExecutor:
    global _EXECUTOR
    with _EXEC_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = FlushExecutor()
        return _EXECUTOR


def drain(raise_latched: bool = True):
    """Wait for every in-flight segment (a sync point)."""
    ex = _EXECUTOR
    if ex is not None:
        ex.drain(raise_latched=raise_latched)


def quiesce():
    """Wait for in-flight segments; their errors stay latched for the next
    sync point (and on their values)."""
    ex = _EXECUTOR
    if ex is not None and ex._inflight:
        with ex._idle:
            while ex._inflight:
                ex._idle.wait()


def shutdown():
    """Drain and retire the worker; the next async flush starts a new
    one."""
    global _EXECUTOR
    with _EXEC_LOCK:
        ex, _EXECUTOR = _EXECUTOR, None
    if ex is not None:
        ex.shutdown()


atexit.register(shutdown)
