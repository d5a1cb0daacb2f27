"""Comm/step watchdog: ``CommTaskManager``, the counterpart of
``paddle_tpu/distributed/watchdog.py`` (upstream
``phi/core/distributed/comm_task_manager.h:37,52``).

A background thread times out tasks that stop beating. The collectives
are ``torch.distributed``'s, whose own timeouts fail a stuck call (gloo's
and NCCL's); the watchdog guards the unit above them, the training step
(and any host-driven transfer). Register a task, heartbeat it each step;
on timeout the checker thread captures every thread's stack and fires the
task's handler (default: the stacks to stderr), and the waiting thread
raises on its next ``check``. The thread is a daemon; ``shutdown()`` stops
and joins it. Each firing counts ``resilience.watchdog_fired`` before it
is visible to ``check`` and before the handler runs; with the flight
recorder armed (``FLAGS_flight_recorder``) it also notes the firing and
dumps the ring with the stacks, as the reference does.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from ..observability import metrics


class CommTask:
    def __init__(self, name: str, timeout: float):
        self.name = name
        self.timeout = timeout
        self.last_beat = time.monotonic()
        self.timed_out = False
        self.stacks = ""   # host stacks captured when the timeout fired


def _dump_stacks() -> str:
    lines = []
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {tid} ---")
        lines.extend(l.rstrip() for l in traceback.format_stack(frame))
    return "\n".join(lines)


class CommTaskManager:
    def __init__(self, check_interval: float = None,
                 on_timeout: Optional[Callable] = None):
        if check_interval is None:
            from .._core.flags import flag_value
            check_interval = flag_value("FLAGS_watchdog_check_interval_s")
        self._tasks: Dict[str, CommTask] = {}
        self._lock = threading.Lock()
        self._interval = check_interval
        self._on_timeout = on_timeout or self._default_handler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_handler(self, task: CommTask):
        sys.stderr.write(
            f"[watchdog] task '{task.name}' exceeded {task.timeout}s "
            f"without a heartbeat; host stacks:\n{task.stacks}\n")

    # ------------------------------------------------------------- tasks
    def register(self, name: str, timeout: float = None) -> CommTask:
        if timeout is None:
            from .._core.flags import flag_value
            timeout = float(flag_value("FLAGS_comm_task_timeout_s"))
        with self._lock:
            t = CommTask(name, timeout)
            self._tasks[name] = t
        self._ensure_thread()
        return t

    def heartbeat(self, name: str):
        with self._lock:
            t = self._tasks.get(name)
            if t is not None:
                t.last_beat = time.monotonic()
                if t.timed_out:
                    t.timed_out = False  # recovered

    def deregister(self, name: str):
        with self._lock:
            self._tasks.pop(name, None)

    def set_timeout(self, name: str, timeout: float):
        """Retune a live task's deadline."""
        with self._lock:
            t = self._tasks.get(name)
            if t is not None:
                t.timeout = float(timeout)

    def timed_out(self, name: str) -> bool:
        with self._lock:
            t = self._tasks.get(name)
            return bool(t and t.timed_out)

    def check(self, name: str) -> None:
        """Raise in the caller (the waiting thread) if ``name`` has timed
        out, with the host stacks captured when it fired; a
        ``heartbeat()`` recovers a task instead."""
        with self._lock:
            t = self._tasks.get(name)
            fired = bool(t and t.timed_out)
            stacks = t.stacks if fired else ""
        if fired:
            from ..base.core import EnforceNotMet
            raise EnforceNotMet(
                f"watchdog: task '{name}' exceeded {t.timeout}s without "
                f"a heartbeat",
                context=f"host stacks at timeout:\n{stacks}"
                if stacks else "")

    # ----------------------------------------------------------- thread
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="comm-task-watchdog")
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._interval):
            now = time.monotonic()
            fired = []
            with self._lock:
                for t in self._tasks.values():
                    if not t.timed_out and now - t.last_beat > t.timeout:
                        # the stacks before timed_out becomes visible: a
                        # waiting thread's check() must not raise without
                        # them; the count too (a raising handler must not
                        # lose it)
                        t.stacks = _dump_stacks()
                        metrics.inc("resilience.watchdog_fired")
                        t.timed_out = True
                        fired.append(t)
            for t in fired:
                self._flight_dump(t)
                try:
                    self._on_timeout(t)
                except Exception:
                    # a raising handler cannot kill the watchdog loop; the
                    # waiting thread raises on its next check()
                    pass

    @staticmethod
    def _flight_dump(t: CommTask):
        """The stacks land in the flight record file itself: a post-mortem
        must not depend on stderr capture."""
        from ..observability import _state as _OBS
        if _OBS.FLIGHT:
            from ..observability import flight
            flight.note("watchdg", t.name, timeout_s=t.timeout)
            flight.dump(reason=f"watchdog: task '{t.name}' exceeded "
                               f"{t.timeout}s; host stacks:\n{t.stacks}")

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_manager: Optional[CommTaskManager] = None


def get_comm_task_manager() -> CommTaskManager:
    global _manager
    if _manager is None:
        _manager = CommTaskManager()
    return _manager
