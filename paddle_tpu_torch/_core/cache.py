"""Bounded LRU for the runtime's runner caches: the counterpart of
``paddle_tpu/_core/cache.py``.

``ExecCache`` is a drop-in dict with LRU eviction; its capacity is read
live from a flag at insertion time, so ``set_flags`` takes effect
mid-session. A cache made with ``stat="segment"`` counts its hits and
misses in plain integers (``hits`` / ``misses``) and, while
``FLAGS_observability`` is on, into the registry as
``cache.<stat>.{hit,miss}`` (one module-level check per lookup when off).
Each entry may carry the memory plane's note (``note_memory``: the
runner's argument, output and temp bytes) and the compute plane's
(``note_cost``: its FLOPs and bytes); both are pruned with the entry.
The reference's per-entry compiled-collective estimate has no
counterpart: no runner of the port compiles a collective in.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ..observability import _state as _obs


class ExecCache(OrderedDict):
    """dict-compatible LRU; capacity from ``flag`` (0 = unlimited)."""

    def __init__(self, flag: str = "FLAGS_executable_cache_capacity",
                 stat: Optional[str] = None):
        super().__init__()
        self._flag = flag
        self.stat = stat
        self.hits = 0
        self.misses = 0
        self._mem: dict = {}
        self._cost: dict = {}
        # direct Counter handles: metrics.reset() zeroes them in place
        if stat is not None:
            from ..observability import metrics
            self._hit = metrics.counter(f"cache.{stat}.hit")
            self._miss = metrics.counter(f"cache.{stat}.miss")
        else:
            self._hit = self._miss = None

    def _capacity(self) -> int:
        from .flags import flag_value
        return flag_value(self._flag)

    def get(self, key, default=None):
        try:
            val = OrderedDict.__getitem__(self, key)
        except KeyError:
            self.misses += 1
            if _obs.METRICS and self._miss is not None:
                self._miss.inc()
            return default
        try:
            # the async worker's eviction may race this touch: the value
            # is in hand, so a lost touch is benign
            self.move_to_end(key)
        except KeyError:
            pass
        self.hits += 1
        if _obs.METRICS and self._hit is not None:
            self._hit.inc()
        return val

    def __getitem__(self, key):
        val = OrderedDict.__getitem__(self, key)
        self.move_to_end(key)
        return val

    def __setitem__(self, key, val):
        OrderedDict.__setitem__(self, key, val)
        self.move_to_end(key)
        cap = self._capacity()
        while cap and len(self) > cap:
            try:
                oldest = next(iter(self))
                OrderedDict.__delitem__(self, oldest)
                self._mem.pop(oldest, None)
                self._cost.pop(oldest, None)
            except (KeyError, StopIteration, RuntimeError):
                break

    def note_memory(self, key, info: dict):
        """Attach a runner's memory note to its entry
        (``observability/memory.py``, ``FLAGS_memory_telemetry``)."""
        self._mem[key] = info

    def memory_info(self, key, default=None):
        return self._mem.get(key, default)

    def note_cost(self, key, info: dict):
        """Attach a runner's FLOP and byte count to its entry
        (``observability/compute.py``, ``FLAGS_compute_telemetry``)."""
        self._cost[key] = info

    def cost_info(self, key, default=None):
        return self._cost.get(key, default)

    def clear(self):
        OrderedDict.clear(self)
        self._mem.clear()
        self._cost.clear()
