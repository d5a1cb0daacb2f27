"""The TCP key-value store: the counterpart of
``paddle_tpu/distributed/store.py``, over the same C++ server and client
(``csrc/tcp_store.cc``, bound through ``_core/native.get_lib``).

Rank 0 hosts the server; every rank connects a client. ``set``, ``get``
(which waits for the key), ``add``, ``wait``, ``delete`` and a reusable
``barrier`` by key serve rendezvous and coordination outside the
collectives, which run over ``torch.distributed`` (``communication.py``).
``FLAGS_tcp_store_timeout_s`` bounds every wait. The reference's retry
policy and fault sites come with its resilience plane (``ROADMAP.md`` §1
item 8).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

from .._core import native


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
        if self._lib.pt_store_set(self._client, key.encode(), data,
                                  len(data)) != 0:
            raise RuntimeError(f"TCPStore.set('{key}') failed: "
                               f"{native.last_error()}")

    def get(self, key: str) -> bytes:
        """The key's value, waiting for it up to the store's timeout. The
        value may grow between the size read and the copy: read again."""
        n = self._lib.pt_store_get(self._client, key.encode(), None, 0,
                                   self._timeout_ms)
        for _ in range(3):
            if n < 0:
                break
            buf = ctypes.create_string_buffer(int(n))
            n2 = self._lib.pt_store_get(self._client, key.encode(), buf, n,
                                        self._timeout_ms)
            if 0 <= n2 <= n:
                return buf.raw[:n2]
            n = n2
        raise RuntimeError(f"TCPStore.get('{key}') failed: "
                           f"{native.last_error() or 'value kept changing'}")

    def add(self, key: str, amount: int = 1) -> int:
        r = self._lib.pt_store_add(self._client, key.encode(), amount)
        if r < 0 and native.last_error():
            raise RuntimeError(f"TCPStore.add('{key}') failed: "
                               f"{native.last_error()}")
        return int(r)

    def wait(self, key: str, timeout: Optional[float] = None) -> None:
        ms = self._timeout_ms if timeout is None else int(timeout * 1000)
        if self._lib.pt_store_wait(self._client, key.encode(), ms) != 0:
            raise RuntimeError(f"TCPStore.wait('{key}') timed out")

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
