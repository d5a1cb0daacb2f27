"""Elastic training manager: the counterpart of
``paddle_tpu/distributed/fleet/elastic.py`` (upstream
``fleet/elastic/manager.py:125``).

Upstream registers nodes in etcd, watches for faults and relaunches with
re-ranked environments. Here the registry is the native TCPStore
(``csrc/tcp_store.cc``): nodes heartbeat under ``__elastic/node/<id>``;
the master scans the heartbeats (with an eviction debounce:
``FLAGS_elastic_eviction_debounce`` consecutive missed probes), adopts
announced nodes, and publishes a membership epoch (``{epoch, members}``)
that every node polls; preemption notices ride the same store. The
``AdaptiveTrainer`` (``resilience/adaptive.py``) reads both at each step
boundary.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..store import TCPStore


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    def __init__(self, node_id: str, store: TCPStore,
                 min_np: int = 1, max_np: int = -1,
                 heartbeat_interval: float = None,
                 node_timeout: float = 2.0,
                 eviction_debounce: int = None,
                 on_membership_change: Optional[Callable] = None):
        self.node_id = node_id
        self.store = store
        self.min_np = min_np
        self.max_np = max_np if max_np > 0 else 10 ** 9
        from ..._core.flags import flag_value
        if heartbeat_interval is None:
            heartbeat_interval = flag_value(
                "FLAGS_elastic_heartbeat_interval_s")
        self.interval = heartbeat_interval
        self.node_timeout = node_timeout
        # eviction debounce: a member leaves only after this many
        # consecutive stale or missed probes. Under CPU starvation a
        # single scan can see every peer stale, and publishing a leave
        # epoch off one bad scan sets the trainers re-planning for
        # nothing. 1 evicts on the first miss.
        self.eviction_debounce = max(
            int(eviction_debounce if eviction_debounce is not None
                else flag_value("FLAGS_elastic_eviction_debounce")), 1)
        self._miss_counts: Dict[str, int] = {}
        self.on_membership_change = on_membership_change
        self.epoch = 0
        self.members: List[str] = []
        self._preempt_seen = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # ----------------------------------------------------------- node side
    def register(self):
        """Join the registry and start heartbeating."""
        self._beat()
        t = threading.Thread(target=self._heartbeat_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _beat(self):
        self.store.set(f"__elastic/node/{self.node_id}",
                       json.dumps({"t": time.time()}))

    def _heartbeat_loop(self):
        failures = 0
        while not self._stop.wait(self.interval):
            try:
                self._beat()
                failures = 0
            except Exception:
                # transient store errors must not kill the heartbeat (a
                # dead heartbeat thread gets the node falsely evicted);
                # give up only after sustained failure
                failures += 1
                if failures > 20:
                    return

    def _probe(self, key: str):
        """Short, un-retried key probe (None = missing/slow). A plain
        `get` waits the store's FULL timeout for a missing key — one
        unregistered node would freeze the whole heartbeat scan."""
        f = getattr(self.store, "try_get", None)
        if f is not None:
            return f(key, timeout=max(self.interval, 0.25))
        try:
            return self.store.get(key)
        except Exception:
            return None

    def current_membership(self) -> Dict:
        raw = self._probe("__elastic/membership")
        if raw is None:
            return {"epoch": 0, "members": []}
        try:
            return json.loads(raw.decode())
        except ValueError:
            return {"epoch": 0, "members": []}

    def my_rank(self) -> int:
        m = self.current_membership()
        try:
            return m["members"].index(self.node_id)
        except ValueError:
            return -1

    def wait_for_members(self, predicate: Callable[[Dict], bool],
                         timeout: float = 30.0) -> Dict:
        """Block until `predicate(membership)` holds — initial
        rendezvous (`len(m["members"]) == world`), or waiting for a
        death to be noticed (`"3" not in m["members"]`). Returns the
        latest membership either way; the caller re-checks the
        predicate to distinguish success from timeout."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            m = self.current_membership()
            if predicate(m):
                return m
            time.sleep(min(0.05, self.interval))
        return self.current_membership()

    # --------------------------------------------------------- master side
    def watch(self, known_nodes: List[str]):
        """Master: scan heartbeats, publish membership epochs on change.
        known_nodes seeds the candidate set; new nodes announce themselves
        via the __elastic/announce counter key."""
        self._known = set(known_nodes)
        t = threading.Thread(target=self._watch_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def announce(self):
        """New node: make the master aware of this node id."""
        seq = self.store.add("__elastic/announce_count", 1)
        self.store.set(f"__elastic/announce/{seq}", self.node_id)

    # ----------------------------------------------------- preemption
    def announce_preemption(self, node_id: Optional[str] = None):
        """Publish a preemption NOTICE for `node_id` (default: this
        node) — the cloud scheduler's grace-period signal, relayed
        through the store so every trainer's step-boundary poll sees
        it and checkpoints immediately (AdaptiveTrainer's
        `preempt::notice` reaction). Same counter-then-key scheme as
        `announce`, so notices are ordered and none is lost."""
        seq = self.store.add("__elastic/preempt_count", 1)
        self.store.set(f"__elastic/preempt/{seq}",
                       node_id or self.node_id)
        return seq

    def poll_preemption(self) -> List[str]:
        """Node ids with NEW preemption notices since the last poll
        (empty almost always — one `add(.., 0)` probe on the shared
        counter). Each notice is returned exactly once per manager."""
        try:
            cnt = self.store.add("__elastic/preempt_count", 0)
        except Exception:
            return []
        out: List[str] = []
        while self._preempt_seen < cnt:
            raw = self._probe(
                f"__elastic/preempt/{self._preempt_seen + 1}")
            if raw is None:
                break   # counter visible before key: next poll
            self._preempt_seen += 1
            out.append(raw.decode())
        return out

    def _alive(self, node: str) -> bool:
        raw = self._probe(f"__elastic/node/{node}")
        if raw is None:
            return False
        try:
            return time.time() - json.loads(raw.decode())["t"] \
                < self.node_timeout
        except (ValueError, KeyError):
            return False

    def _scan_alive(self, last: List[str]) -> List[str]:
        """One heartbeat scan with eviction debounce: a node already in
        the membership survives up to eviction_debounce-1 consecutive
        stale/missed probes (one starved scan must not evict the
        world); a node never seen alive gets no such grace."""
        alive = []
        for n in sorted(self._known):
            if self._alive(n):
                self._miss_counts.pop(n, None)
                alive.append(n)
            else:
                c = self._miss_counts.get(n, 0) + 1
                self._miss_counts[n] = c
                if n in last and c < self.eviction_debounce:
                    alive.append(n)   # debounced, not yet evicted
        return alive

    def _watch_loop(self):
        last: List[str] = []
        announced = 0
        failures = 0
        while not self._stop.wait(self.interval):
            try:
                cnt = self.store.add("__elastic/announce_count", 0)
                while announced < cnt:  # adopt announced node ids
                    raw = self._probe(
                        f"__elastic/announce/{announced + 1}")
                    if raw is None:
                        break   # counter visible before key: next scan
                    announced += 1
                    self._known.add(raw.decode())
                alive = self._scan_alive(last)
                if alive != last and len(alive) >= self.min_np:
                    self.epoch += 1
                    self.members = alive[:self.max_np]
                    self.store.set("__elastic/membership", json.dumps(
                        {"epoch": self.epoch, "members": self.members}))
                    last = alive
                    if self.on_membership_change:
                        self.on_membership_change(self.epoch,
                                                  self.members)
                failures = 0
            except Exception:
                # keep watching through transient store errors; a dead
                # watcher silently freezes membership for the whole job
                failures += 1
                if failures > 20:
                    return

    def add_known_node(self, node_id: str):
        self._known.add(node_id)

    def shutdown(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()


def enable_elastic(args=None):
    return os.environ.get("PADDLE_ELASTIC_SERVER") is not None
