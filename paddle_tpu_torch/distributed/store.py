"""The TCP key-value store: the counterpart of
``paddle_tpu/distributed/store.py``, over the same C++ server and client
(``csrc/tcp_store.cc``, bound through ``_core/native.get_lib``).

Rank 0 hosts the server; every rank connects a client. ``set``, ``get``
(which waits for the key), ``add``, ``wait``, ``delete`` and a reusable
``barrier`` by key serve rendezvous and coordination outside the
collectives, which run over ``torch.distributed`` (``communication.py``).
``FLAGS_tcp_store_timeout_s`` bounds every wait.

``set``, ``get`` and ``wait`` are each one attempt under
``retry.store_policy()`` that fires its fault site (``store::set``,
``store::get``, ``store::wait``) first and raises ``StoreOpError`` on a
native failure, the class that policy retries. ``add`` fires
``store::add`` but is not retried: an increment applied and then
re-sent would count twice. ``try_get`` is a probe: one short attempt,
never a fault site, None when the key is missing or slow.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

from .._core import native
from .resilience import faults as _faults
from .resilience import retry as _retry

# the store's error (defined in resilience.retry, which this module
# imports; the reverse import would cycle)
StoreOpError = _retry.StoreOpError


class TCPStore:

    # barrier rounds wrap here: a round's keys are deleted when its last
    # rank leaves, so every rank reuses the same numbers in the same order
    _BARRIER_ROUND_WRAP = 1 << 16

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: Optional[float] = None):
        if timeout is None:
            from .._core.flags import flag_value
            timeout = float(flag_value("FLAGS_tcp_store_timeout_s"))
        self._lib = native.get_lib(required=True)
        self._server = None
        self._client = None
        self._timeout_ms = int(timeout * 1000)
        self._barrier_rounds = {}
        if is_master:
            self._server = self._lib.pt_store_server_start(port)
            if not self._server:
                raise RuntimeError(
                    f"TCPStore server failed: {native.last_error()}")
            port = self._lib.pt_store_server_port(self._server)
        self.host = host
        self.port = port
        self.world_size = world_size
        self._client = self._lib.pt_store_client_connect(
            host.encode(), port, self._timeout_ms)
        if not self._client:
            self._close_server()
            raise RuntimeError(
                f"TCPStore connect failed: {native.last_error()}")

    def set(self, key: str, value) -> None:
        data = value.encode() if isinstance(value, str) else bytes(value)
        _retry.store_policy().run(self._set_once, key, data,
                                  what=f"store::set({key})")

    def _set_once(self, key: str, data: bytes) -> None:
        if _faults.ACTIVE:
            _faults.inject("store::set")
        if self._lib.pt_store_set(self._client, key.encode(), data,
                                  len(data)) != 0:
            raise StoreOpError(f"TCPStore.set('{key}') failed: "
                               f"{native.last_error()}")

    def get(self, key: str) -> bytes:
        """The key's value, waiting for it up to the store's timeout."""
        return _retry.store_policy().run(self._get_once, key,
                                         what=f"store::get({key})")

    def _get_once(self, key: str) -> bytes:
        if _faults.ACTIVE:
            _faults.inject("store::get")
        out = self._sized_read(key, self._timeout_ms)
        if isinstance(out, int):
            reason = native.last_error() or "value kept changing size"
            raise StoreOpError(f"TCPStore.get('{key}') failed: {reason}")
        return out

    def try_get(self, key: str, timeout: float = 0.25):
        """The key's value now, or None when it is missing or slow: one
        attempt with its own short deadline, never retried and never a
        fault site (heartbeat scans and membership polls call it, and a
        probe must neither block for the store's timeout nor use up a
        drill's ``store::get`` occurrences)."""
        out = self._sized_read(key, max(int(timeout * 1000), 1))
        return None if isinstance(out, int) else out

    def _sized_read(self, key: str, ms: int):
        """The native get's size, then the copy; the value may grow
        between the two calls (the copy is then skipped and the new
        length returned): read again. The bytes, or the failing native
        code (an int < 0; -1 for a value that would not hold still)."""
        n = self._lib.pt_store_get(self._client, key.encode(), None, 0, ms)
        if n < 0:
            return int(n)
        for _ in range(3):
            buf = ctypes.create_string_buffer(int(n))
            n2 = self._lib.pt_store_get(self._client, key.encode(), buf, n,
                                        ms)
            if n2 < 0:
                return int(n2)
            if n2 <= n:
                return buf.raw[:n2]
            n = n2
        return -1

    def add(self, key: str, amount: int = 1) -> int:
        if _faults.ACTIVE:
            _faults.inject("store::add")
        r = self._lib.pt_store_add(self._client, key.encode(), amount)
        if r < 0 and native.last_error():
            raise RuntimeError(f"TCPStore.add('{key}') failed: "
                               f"{native.last_error()}")
        return int(r)

    def wait(self, key: str, timeout: Optional[float] = None) -> None:
        _retry.store_policy().run(self._wait_once, key, timeout,
                                  what=f"store::wait({key})")

    def _wait_once(self, key: str, timeout: Optional[float]) -> None:
        if _faults.ACTIVE:
            _faults.inject("store::wait")
        ms = self._timeout_ms if timeout is None else int(timeout * 1000)
        if self._lib.pt_store_wait(self._client, key.encode(), ms) != 0:
            raise StoreOpError(f"TCPStore.wait('{key}') timed out")

    def delete(self, key: str) -> None:
        if self._lib.pt_store_del(self._client, key.encode()) != 0:
            raise RuntimeError(f"TCPStore.delete('{key}') failed: "
                               f"{native.last_error()}")

    def barrier(self, key: str = "barrier",
                timeout: Optional[float] = None) -> None:
        """All ``world_size`` ranks arrive, then all go on. Each use of a
        key is a new round (every rank calls it as often), and the last
        rank out deletes the round's keys."""
        rnd = self._barrier_rounds.get(key, 0)
        self._barrier_rounds[key] = (rnd + 1) % self._BARRIER_ROUND_WRAP
        base = f"__bar/{key}/{rnd}"
        if self.add(f"{base}/count", 1) >= self.world_size:
            self.set(f"{base}/done", b"1")
        self.wait(f"{base}/done", timeout)
        if self.add(f"{base}/left", 1) >= self.world_size:
            for suffix in ("count", "done", "left"):
                self.delete(f"{base}/{suffix}")

    def _close_server(self) -> None:
        if self._server:
            self._lib.pt_store_server_stop(self._server)
            self._server = None

    def close(self) -> None:
        if self._client:
            self._lib.pt_store_client_close(self._client)
            self._client = None
        self._close_server()

    def __enter__(self) -> "TCPStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError, OSError):
            pass  # interpreter teardown: the library may be gone


_global_store: Optional[TCPStore] = None


def create_or_get_global_tcp_store() -> TCPStore:
    """The job's store, made once from the environment: ``PADDLE_MASTER``
    (``host:port``) or ``MASTER_ADDR``/``MASTER_PORT``; rank 0
    (``PADDLE_TRAINER_ID``) hosts it for ``PADDLE_TRAINERS_NUM`` ranks."""
    global _global_store
    if _global_store is None:
        master = os.environ.get("PADDLE_MASTER") or "{}:{}".format(
            os.environ.get("MASTER_ADDR", "127.0.0.1"),
            os.environ.get("MASTER_PORT", "6170"))
        host, port = master.rsplit(":", 1)
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        _global_store = TCPStore(host, int(port), is_master=rank == 0,
                                 world_size=world)
    return _global_store
