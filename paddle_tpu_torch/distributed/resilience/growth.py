"""Join-driven growth, the joiner's half: the counterpart of
``paddle_tpu/distributed/resilience/growth.py``.

``grow_world`` (``elastic.py``) is the survivors' half of a membership
growth. A fresh process admitted under a new membership epoch has no
state at all; the cheap path is a state broadcast: one survivor publishes
the full training state through the TCPStore the membership already rides
on, and the joiner receives it:

- chunked (``FLAGS_elastic_grow_chunk_kb``): the native store moves one
  value per message, and a multi-GB pickle in one key would stall the
  heartbeats behind it;
- checksummed: sha256 per chunk and over the whole payload, verified
  before unpickling (a truncated chunk falls back cleanly, never runs a
  corrupt pickle stream);
- retried (``retry.grow_policy()``): each chunk's set and get re-attempt
  the transient store class; a checksum mismatch is not retried (the
  publication itself is bad), so ``receive_state`` raises
  ``StoreOpError`` and the joiner falls back to the newest verified
  checkpoint.

Keys live under ``__elastic/grow/<epoch>/`` so epochs never alias; the
meta key is written last, so a visible meta always describes chunks
already published.

Counters: ``resilience.grow_bcast_chunks`` / ``grow_bcast_bytes`` on the
publishing side, ``resilience.grow_state_received`` /
``grow_bcast_rejects`` on the receiving side, ``resilience.grow_joins``
on admission; each also a flight-recorder note while it is armed
(``_note``).
"""
from __future__ import annotations

import hashlib
import json
import pickle
from typing import Dict, Optional

from ..._core import flags as _flags
from . import retry as _retry


def _sha(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def _chunk_bytes() -> int:
    kb = int(_flags.flag_value("FLAGS_elastic_grow_chunk_kb") or 512)
    return max(kb, 1) << 10


def _prefix(epoch: int) -> str:
    return f"__elastic/grow/{int(epoch)}"


def publish_state(store, state: Dict, epoch: int) -> int:
    """Survivor side: pickle `state` (numpy/host values — the caller
    converts device shards to global host arrays first, see
    AdaptiveTrainer._broadcast_state), chunk it, and publish every
    chunk plus a final meta record under the growth epoch. Returns the
    number of chunks published. Each store op is retry-wrapped; the
    meta key lands last so a reader never sees a half-published
    payload with a complete-looking index."""
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    size = _chunk_bytes()
    chunks = [blob[i:i + size] for i in range(0, len(blob), size)] \
        or [b""]
    policy = _retry.grow_policy()
    pre = _prefix(epoch)
    sums = []
    for i, c in enumerate(chunks):
        sums.append(_sha(c))
        policy.run(store.set, f"{pre}/chunk/{i}", c,
                   what=f"grow::publish({i})")
    meta = {"nchunks": len(chunks), "bytes": len(blob),
            "sha256": _sha(blob), "chunk_sha256": sums}
    policy.run(store.set, f"{pre}/meta", json.dumps(meta),
               what="grow::publish(meta)")
    from ...observability import metrics
    metrics.inc("resilience.grow_bcast_chunks", len(chunks))
    metrics.inc("resilience.grow_bcast_bytes", len(blob))
    _note("publish_state", epoch=int(epoch), chunks=len(chunks),
          bytes=len(blob))
    return len(chunks)


def _note(event: str, **detail):
    from ...observability import _state as _OBS
    if _OBS.FLIGHT:
        from ...observability import flight
        flight.note("grow", event, **detail)


def receive_state(store, epoch: int, *,
                  timeout: float = 30.0) -> Dict:
    """Joiner side: wait for the epoch's meta record, fetch every
    chunk (retry-wrapped), verify each chunk's checksum and the whole
    payload's BEFORE unpickling. Raises `retry.StoreOpError` on a
    missing/timed-out publication or any integrity failure — the
    caller's fallback is the newest verified checkpoint generation."""
    policy = _retry.grow_policy()
    pre = _prefix(epoch)
    try:
        policy.run(store.wait, f"{pre}/meta", timeout,
                   what="grow::receive(meta)")
        raw = policy.run(store.get, f"{pre}/meta",
                         what="grow::receive(meta)")
        meta = json.loads(raw.decode())
        parts = []
        for i in range(int(meta["nchunks"])):
            c = policy.run(store.get, f"{pre}/chunk/{i}",
                           what=f"grow::receive({i})")
            want = meta["chunk_sha256"][i]
            if _sha(c) != want:
                raise _ChecksumError(
                    f"grow broadcast chunk {i} of epoch {epoch}: "
                    f"checksum {_sha(c)[:12]}.. does not match the "
                    f"published {want[:12]}..")
            parts.append(c)
        blob = b"".join(parts)
        if len(blob) != int(meta["bytes"]) \
                or _sha(blob) != meta["sha256"]:
            raise _ChecksumError(
                f"grow broadcast payload of epoch {epoch}: "
                f"{len(blob)} bytes / {_sha(blob)[:12]}.. does not "
                f"match the published {meta['bytes']} / "
                f"{meta['sha256'][:12]}..")
    except Exception as e:
        from ...observability import metrics
        metrics.inc("resilience.grow_bcast_rejects")
        _note("receive_reject", epoch=int(epoch), error=repr(e)[:160])
        if isinstance(e, _retry.StoreOpError):
            raise
        raise _retry.StoreOpError(
            f"grow state broadcast for epoch {epoch} unusable: {e}"
        ) from e
    state = pickle.loads(blob)
    from ...observability import metrics
    metrics.inc("resilience.grow_state_received")
    _note("receive_state", epoch=int(epoch), bytes=len(blob))
    return state


class _ChecksumError(ValueError):
    """Integrity failure inside a published broadcast — never
    retried (re-reading the same bad bytes cannot help)."""


def join_world(manager, *, announce: bool = True,
               min_members: Optional[int] = None,
               timeout: float = 60.0) -> Dict:
    """Joining rank's rendezvous: register with the heartbeat plane,
    announce to the master, and block until a published membership
    epoch includes this node (and at least `min_members` peers, when
    given). Returns the adopted membership dict. The caller then joins
    the grown world (``parallel_env.rebuild_world`` over the members
    under ``membership["epoch"]``, which the survivors' ``grow_world``
    forms at the same time), calls ``receive_state(manager.store,
    membership["epoch"])`` (with the newest verified checkpoint as the
    fallback) and builds its step against the grown mesh."""
    manager.register()
    if announce:
        manager.announce()

    def _admitted(m):
        if manager.node_id not in m.get("members", []):
            return False
        return min_members is None \
            or len(m.get("members", [])) >= int(min_members)

    m = manager.wait_for_members(_admitted, timeout=timeout)
    if not _admitted(m):
        raise _retry.StoreOpError(
            f"join rendezvous timed out after {timeout}s: node "
            f"{manager.node_id!r} not admitted (membership {m})")
    from ...observability import metrics
    metrics.inc("resilience.grow_joins")
    _note("join", epoch=int(m.get("epoch", 0)),
          members=len(m.get("members", [])))
    return m
