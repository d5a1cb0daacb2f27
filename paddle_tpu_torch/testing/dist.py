"""Run a function on n ranks of a ``torch.distributed`` world of spawned
processes, and collect each rank's result.

Each rank is a process started with the ``spawn`` method (a process that
has JAX or a card initialised must not be forked), joined to the world
through a ``file://`` rendezvous in a temporary directory: gloo on the CPU
(``device="cpu"``) or NCCL on the cards, rank r on card r. Workers run
with one intra-op thread and never import ``jax``: a worker that finds it
imported after a task fails that task.

``run(fn, n, *args)`` starts a world, runs ``fn(*args)`` on every rank and
stops the world. ``World(n)`` keeps one alive for many tasks (a test
module's fixture): ``world.run(fn, *args)``, then ``world.close()``. A
task's function must be importable by name from a module that does not
import ``jax`` (the workers import it to unpickle it). A task that raises
on any rank raises ``RankError`` here with that rank's traceback, and the
world is stopped (its other ranks may be waiting on a collective).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

# the longest a task may take before the world is declared hung
TASK_TIMEOUT = 300.0


class RankError(RuntimeError):
    pass


def _worker(rank: int, n: int, init_method: str, device: str, tasks,
            results) -> None:
    import torch
    torch.set_num_threads(1)
    from ..distributed import parallel_env
    try:
        parallel_env.init_parallel_env(init_method, rank, n, device)
    except Exception:  # report the failure, the parent stops the world
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            value = fn(*args)
            if "jax" in sys.modules:
                raise RuntimeError("a rank imported jax")
            results.put((rank, True, value))
        except Exception:  # the task's failure is the parent's to raise
            results.put((rank, False, traceback.format_exc()))
    parallel_env.destroy_process_group()


class World:
    """n ranks kept alive between tasks."""

    def __init__(self, n: int, device: str = "cpu",
                 timeout: float = TASK_TIMEOUT):
        self.n, self.device, self.timeout = n, device, timeout
        self._procs: List[Any] = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="pt_world_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, self.n, init, self.device, self._tasks[r], self._results))
            for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(*args)`` on every rank; the results by rank."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args))
        out: List[Optional[Any]] = [None] * self.n
        deadline = time.monotonic() + self.timeout
        for _ in range(self.n):
            rank, ok, value = self._next(fn, deadline)
            if not ok:
                self.close(wait=False)
                raise RankError(f"{fn.__name__} failed on rank {rank}:\n"
                                f"{value}")
            out[rank] = value
        return out

    def _next(self, fn, deadline):
        """The next result; raises if a rank has died or time is up."""
        while True:
            try:
                return self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                late = time.monotonic() > deadline
                if dead or late:
                    self.close(wait=False)
                    why = (f"rank {dead[0]} exited" if dead else
                           f"no result within {self.timeout:.0f} s")
                    raise RankError(f"{fn.__name__}: {why}") from None

    def close(self, wait: bool = True) -> None:
        """Stop the ranks (asking them first when ``wait``, then
        terminating what is left) and remove the rendezvous directory."""
        if not self._procs:
            return
        if wait:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run(fn: Callable, n: int, *args, device: str = "cpu",
        timeout: float = TASK_TIMEOUT) -> List[Any]:
    """``fn(*args)`` on each rank of a new n-rank world; the results by
    rank."""
    with World(n, device, timeout) as world:
        return world.run(fn, *args)
