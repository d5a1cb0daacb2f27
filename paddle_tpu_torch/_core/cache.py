"""Bounded LRU for the runtime's runner caches: the counterpart of
``paddle_tpu/_core/cache.py``.

``ExecCache`` is a drop-in dict with LRU eviction; its capacity is read
live from a flag at insertion time, so ``set_flags`` takes effect
mid-session. A cache made with ``stat="segment"`` counts its hits and
misses in plain integers (``hits`` / ``misses``) under the reference's
stat name; the observability plane that reads them comes with
``ROADMAP.md`` §1 item 9, as do the reference's per-entry memory, cost
and collective notes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional


class ExecCache(OrderedDict):
    """dict-compatible LRU; capacity from ``flag`` (0 = unlimited)."""

    def __init__(self, flag: str = "FLAGS_executable_cache_capacity",
                 stat: Optional[str] = None):
        super().__init__()
        self._flag = flag
        self.stat = stat
        self.hits = 0
        self.misses = 0

    def _capacity(self) -> int:
        from .flags import flag_value
        return flag_value(self._flag)

    def get(self, key, default=None):
        try:
            val = OrderedDict.__getitem__(self, key)
        except KeyError:
            self.misses += 1
            return default
        self.move_to_end(key)
        self.hits += 1
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
            OrderedDict.__delitem__(self, next(iter(self)))
