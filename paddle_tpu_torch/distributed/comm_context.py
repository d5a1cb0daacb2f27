"""Host collectives on numpy arrays for one set of ranks: ``CommContext``,
the counterpart of ``paddle_tpu/distributed/comm_context.py`` (upstream
``phi/core/distributed/comm_context_manager.h:43``).

The reference runs these over its own socket engine
(``csrc/comm_context.cc``). In the port gloo plays that role, as it does
for the communication API: each context is a gloo process group of its
own ranks, made without the default group. Rank 0 serves a
``torch.distributed.TCPStore`` for the group's rendezvous and publishes
its endpoint through the caller's store (the reference exchanges its
socket endpoints the same way). Reductions of types outside gloo's set
used here (float32, float64, int32, int64, uint8; so bf16, fp16, the
small ints) run in float32 (float64 for wider ones) and are cast back;
broadcast, all-gather and send/receive move bytes.

``FLAGS_comm_idle_poll_limit`` (the reference's engine's count of 60 s
polls without progress before a transfer fails) becomes the group's
timeout, that many minutes; a ``PT_COMM_IDLE_POLL_LIMIT`` in the
environment wins over the flag, as in the reference, where the engine
reads that variable.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_GLOO_TYPES = ("float32", "float64", "int32", "int64", "uint8")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
        "avg": dist.ReduceOp.SUM}


def _poll_limit() -> int:
    env = os.environ.get("PT_COMM_IDLE_POLL_LIMIT")
    if env is not None:
        return int(env)
    from .._core.flags import flag_value
    return int(flag_value("FLAGS_comm_idle_poll_limit"))


def _advertised_host() -> str:
    return os.environ.get("PADDLE_LOCAL_IP",
                          os.environ.get("POD_IP", "127.0.0.1"))


def _bytes_of(arr: np.ndarray) -> torch.Tensor:
    """A uint8 tensor sharing ``arr``'s memory (``arr`` contiguous)."""
    return torch.from_numpy(arr.reshape(-1).view(np.uint8))


class CommContext:
    """One gloo group for one (group, instance) key."""

    def __init__(self, store, rank: int, world: int, key: str):
        self.rank = rank
        self.world = world
        self.timeout = datetime.timedelta(seconds=60 * _poll_limit())
        if rank == 0:
            self._store = dist.TCPStore(
                _advertised_host(), 0, world, True, timeout=self.timeout,
                wait_for_workers=False)
            store.set(f"{key}/ep", f"{_advertised_host()}:"
                      f"{self._store.port}")
        else:
            host, port = store.get(f"{key}/ep").decode().rsplit(":", 1)
            self._store = dist.TCPStore(host, int(port), world, False,
                                        timeout=self.timeout)
        self._pg = dist.ProcessGroupGloo(
            dist.PrefixStore(f"{key}/gloo/", self._store), rank, world,
            self.timeout)

    @classmethod
    def create_negotiated(cls, store, rank: int, world: int,
                          key: str) -> Optional["CommContext"]:
        """Collective transport selection: every rank publishes whether it
        can run the transport before anyone blocks in the rendezvous; the
        context is made only when all ranks can (a per-rank fallback would
        leave the peers waiting). None otherwise, on every rank."""
        from .._core.flags import flag_value
        ok = bool(flag_value("FLAGS_pg_native_transport")) \
            and dist.is_gloo_available()
        store.set(f"{key}/cap/{rank}", b"1" if ok else b"0")
        caps = [store.get(f"{key}/cap/{r}") for r in range(world)]
        if any(c != b"1" for c in caps):
            return None
        return cls(store, rank, world, key)

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _reduce_view(arr: np.ndarray):
        """(contiguous copy, restore_fn) for reductions."""
        arr = np.ascontiguousarray(arr)
        if arr.dtype.name in _GLOO_TYPES:
            return arr.copy(), lambda a: a
        up = arr.astype(np.float32 if arr.dtype.itemsize <= 2
                        else np.float64)
        orig = arr.dtype
        return up, lambda a: a.astype(orig)

    def _all_reduce_buf(self, buf: np.ndarray, op: str) -> np.ndarray:
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        self._pg.allreduce([torch.from_numpy(buf)], opts).wait()
        return buf / self.world if op == "avg" else buf

    # --------------------------------------------------------- collectives
    def all_reduce(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        buf, restore = self._reduce_view(arr)
        out = restore(self._all_reduce_buf(buf, op))
        return np.asarray(out, dtype=arr.dtype).reshape(arr.shape)

    def reduce_scatter(self, arr: np.ndarray, op: str = "sum"):
        """arr: concatenation of world equal parts along axis 0; returns
        this rank's reduced part."""
        buf, restore = self._reduce_view(arr)
        flat = self._all_reduce_buf(buf, op).reshape(-1)
        per = flat.size // self.world
        part = flat[self.rank * per:(self.rank + 1) * per]
        part_shape = (arr.shape[0] // self.world,) + arr.shape[1:]
        return np.asarray(restore(part),
                          dtype=arr.dtype).reshape(part_shape)

    def all_gather_bytes(self, data: bytes) -> list:
        """Equal-size byte blobs, rank-major."""
        n = len(data)
        if n == 0:
            return [b""] * self.world
        inb = np.frombuffer(data, np.uint8).copy()
        outs = [np.empty(n, np.uint8) for _ in range(self.world)]
        self._pg.allgather([[torch.from_numpy(o) for o in outs]],
                           [torch.from_numpy(inb)]).wait()
        return [o.tobytes() for o in outs]

    def all_gather(self, arr: np.ndarray) -> list:
        arr = np.ascontiguousarray(arr)
        blobs = self.all_gather_bytes(arr.tobytes())
        return [np.frombuffer(b, arr.dtype).reshape(arr.shape).copy()
                for b in blobs]

    def broadcast_bytes(self, data: Optional[bytes], root: int,
                        nbytes: int) -> bytes:
        buf = np.frombuffer(data, np.uint8).copy() if data is not None \
            else np.empty(nbytes, np.uint8)
        if nbytes:
            opts = dist.BroadcastOptions()
            opts.rootRank = root
            opts.rootTensor = 0
            self._pg.broadcast([torch.from_numpy(buf)], opts).wait()
        return buf.tobytes()

    def send(self, arr: np.ndarray, dst: int):
        arr = np.ascontiguousarray(arr)
        self._pg.send([_bytes_of(arr)], dst, 0).wait()

    def recv_into(self, arr: np.ndarray, src: int) -> np.ndarray:
        self._pg.recv([_bytes_of(arr)], src, 0).wait()
        return arr

    def barrier(self):
        self._pg.barrier(dist.BarrierOptions()).wait()
