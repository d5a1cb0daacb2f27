"""Distributed checkpoint: ``save_state_dict`` / ``load_state_dict`` and
generation retention (``CheckpointManager``), the counterpart of
``paddle_tpu/distributed/checkpoint.py`` (upstream
``distributed/checkpoint``).

The format on disk is the reference's version 2, so a checkpoint written
by either package loads in the other:

- ``data_rank0.pkl`` pickles a dict of numpy arrays, each tensor's GLOBAL
  value (and the non-tensor entries as they are);
- ``metadata.pkl`` pickles each tensor's shape, dtype, mesh and
  placements, and ``__checkpoint_format__`` with the sha256 checksum of
  the data file;
- both are written atomically (temp file, fsync, ``os.replace``), data
  first, under ``retry.ckpt_policy()``, and a load checks the checksum
  before unpickling.

``save_state_dict`` is called by every rank: a DistTensor is gathered to
its global value (``unshard_dtensor``, a collective over its mesh; a
Partial one is summed) and rank ``coordinator_rank`` writes the files.
``load_state_dict`` reads them on every rank and cuts each target's piece
by the target's own current placements (reshard on load, no
communication).

bf16: numpy has no bfloat16 without ``ml_dtypes``, which the card's
machine lacks. The port writes a bf16 tensor as float32 (which holds every
bf16 value exactly) and records ``bfloat16`` as its dtype; the loader
casts to the target's dtype, so the port's checkpoints load without
``ml_dtypes`` in either package. The reference pickles bf16 as
``ml_dtypes.bfloat16``: the port loads such a checkpoint where
``ml_dtypes`` can be imported, and refuses it with the unpickler's
``ModuleNotFoundError`` where it cannot.

A generation fallback counts ``resilience.ckpt_fallbacks``; the fault
sites ``ckpt::save`` and ``ckpt::load`` are armed by
``FLAGS_fault_inject``. While a telemetry plane is on, a save runs in a
``ckpt::save`` span and a load in a ``ckpt::load`` span, each carrying the
data file's bytes (the goodput plane's checkpoint bucket), and a
generation fallback leaves a flight-recorder note.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._core.flags import flag_value
from .._core.tensor import Tensor
from ..base.core import EnforceNotMet
from .api import local_piece, unshard_dtensor
from .placements import Partial, Shard
from .resilience import faults as _faults
from .resilience import retry as _retry

_LOG = logging.getLogger(__name__)


def _checksum(blob: bytes) -> str:
    return "sha256:" + hashlib.sha256(blob).hexdigest()


def _atomic_write(path: str, blob: bytes) -> None:
    """Write-to-temp + fsync + os.replace: a crash mid-save leaves the
    previous checkpoint intact instead of a torn pickle that loads
    garbage or half a state dict."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=".tmp_" + os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _placement_to_tuple(p):
    if isinstance(p, Shard):
        return ("shard", p.dim)
    if isinstance(p, Partial):
        return ("partial", p.reduce_type)
    return ("replicate",)


def _global_numpy(t: Tensor) -> np.ndarray:
    """The global value of ``t`` as numpy (bf16 as float32)."""
    v = unshard_dtensor(t)._t.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _ckpt_span(name: str):
    """``ckpt::<name>`` begun (its bytes filled in once known), or None
    while every telemetry plane is off."""
    from ..observability import _state as _OBS
    if not _OBS.ACTIVE:
        return None
    from ..observability.spans import span
    return span("ckpt::" + name, hist=f"ckpt.{name}_us", bytes=0).begin()


def _spanned(name: str, body, *args):
    sp = _ckpt_span(name)
    try:
        out = body(*args, sp)
    except BaseException as e:
        if sp is not None:
            sp.end(error=e)
        raise
    if sp is not None:
        sp.end()
    return out


def save_state_dict(state_dict: Dict[str, Tensor], path: str,
                    process_group=None, coordinator_rank=0):
    if _faults.ACTIVE:
        _faults.inject("ckpt::save")
    _spanned("save", _save, state_dict, path, coordinator_rank)


def _save(state_dict, path, coordinator_rank, sp):
    meta = {}
    data = {}
    for name, t in state_dict.items():
        if isinstance(t, Tensor):
            attr = t._dist_attr
            arr = _global_numpy(t)
            meta[name] = {
                "shape": list(arr.shape),
                "dtype": t.dtype.name,
                "mesh_shape": attr.process_mesh.shape if attr else None,
                "dim_names": attr.process_mesh.dim_names if attr else None,
                "placements": [_placement_to_tuple(p)
                               for p in attr.placements] if attr else None,
            }
            data[name] = arr
        else:
            meta[name] = {"py": True}
            data[name] = t
    if _rank() == coordinator_rank:
        os.makedirs(path, exist_ok=True)
        # the data file's checksum rides the metadata; data lands first,
        # so a crash between the two leaves the OLD metadata, whose
        # checksum then refuses the new data
        data_blob = pickle.dumps(data)
        meta["__checkpoint_format__"] = {
            "version": 2,
            "checksums": {"data_rank0.pkl": _checksum(data_blob)},
        }
        if sp is not None:
            sp.args["bytes"] = len(data_blob)
        ckpt = _retry.ckpt_policy()
        ckpt.run(_atomic_write, os.path.join(path, "data_rank0.pkl"),
                 data_blob, what="ckpt::write(data)")
        ckpt.run(_atomic_write, os.path.join(path, "metadata.pkl"),
                 pickle.dumps(meta), what="ckpt::write(meta)")
    if dist.is_initialized():
        dist.barrier()


def load_state_dict(state_dict: Dict[str, Tensor], path: str,
                    process_group=None, coordinator_rank=0):
    """Fill `state_dict`'s tensors in place; each target keeps its OWN
    current dist_attr (that's the reshard-on-load: stored global values
    are cut to whatever mesh and placements the target uses now)."""
    if _faults.ACTIVE:
        _faults.inject("ckpt::load")
    return _spanned("load", _load, state_dict, path)


def _load(state_dict, path, sp):
    def _read(p):
        with open(p, "rb") as f:
            return f.read()

    ckpt = _retry.ckpt_policy()
    data_blob = ckpt.run(_read, os.path.join(path, "data_rank0.pkl"),
                         what="ckpt::read(data)")
    if sp is not None:
        sp.args["bytes"] = len(data_blob)
    # verify the per-file checksum BEFORE unpickling: a torn or
    # bit-rotted data file fails with a clear framework error instead
    # of loading garbage (or executing a corrupt pickle stream).
    # Checkpoints from the pre-checksum format load unverified.
    meta_path = os.path.join(path, "metadata.pkl")
    if os.path.exists(meta_path):
        meta = pickle.loads(ckpt.run(_read, meta_path,
                                     what="ckpt::read(meta)"))
        fmt = meta.get("__checkpoint_format__")
        expected = (fmt or {}).get("checksums", {}).get("data_rank0.pkl")
        if expected is not None and _checksum(data_blob) != expected:
            raise EnforceNotMet(
                f"checkpoint at {path} is corrupted: data_rank0.pkl "
                f"checksum {_checksum(data_blob)} does not match the "
                f"recorded {expected}",
                context="the file was torn by a crash mid-save or "
                        "modified after save_state_dict; re-save or "
                        "restore from a replica")
    data = pickle.loads(data_blob)
    del data_blob
    if flag_value("FLAGS_ckpt_strict_load"):
        missing = sorted(set(state_dict) - set(data))
        unexpected = sorted(set(data) - set(state_dict))
        if missing or unexpected:
            raise KeyError(
                f"checkpoint at {path} mismatch: missing "
                f"{missing[:5]}, unexpected {unexpected[:5]} — set "
                "FLAGS_ckpt_strict_load=0 to load the intersection")
    for name, t in state_dict.items():
        if name not in data:
            continue
        if not isinstance(t, Tensor):
            state_dict[name] = data[name]
            continue
        arr = np.asarray(data[name])
        if arr.dtype.name == "bfloat16":   # the reference's ml_dtypes bf16
            arr = arr.astype(np.float32)
        value = torch.from_numpy(np.ascontiguousarray(arr))
        if t._dist_attr is not None:
            value = local_piece(value, t._dist_attr)
        t.set_value(value)
    return state_dict


# ------------------------------------------------- generation retention

class CheckpointManager:
    """N verified checkpoint generations under one root.

    Layout::

        <root>/MANIFEST.json          # [{gen, path, step, saved_at}]
        <root>/gen_00000001/          # save_state_dict output
        <root>/gen_00000002/
        ...

    `save` writes a fresh generation (atomic + checksummed via
    save_state_dict), appends it to the manifest (itself written
    atomically, AFTER the data — a crash in between leaves an orphan
    directory the next save harmlessly overwrites), and prunes beyond
    `keep` (`FLAGS_checkpoint_keep` when not pinned). `load` walks
    generations newest-first: a checksum failure (torn save, bit rot)
    falls back to the next older VERIFIED generation with a logged
    reason, raising only when no generation survives verification.
    In a world of several ranks, every rank calls `save` and rank 0
    writes the manifest.
    """

    MANIFEST = "MANIFEST.json"

    def __init__(self, root: str, keep: Optional[int] = None):
        self.root = root
        self._keep = keep

    @property
    def keep(self) -> int:
        if self._keep is not None:
            return max(int(self._keep), 1)
        return max(int(flag_value("FLAGS_checkpoint_keep")), 1)

    # -------------------------------------------------------- manifest
    def _manifest(self) -> List[Dict]:
        path = os.path.join(self.root, self.MANIFEST)
        try:
            with open(path) as f:
                return list(json.load(f)["generations"])
        except (OSError, ValueError, KeyError):
            return []

    def _write_manifest(self, entries: List[Dict]) -> None:
        _atomic_write(
            os.path.join(self.root, self.MANIFEST),
            json.dumps({"generations": entries}, indent=1).encode())

    def generations(self) -> List[int]:
        return sorted(int(e["gen"]) for e in self._manifest())

    def latest(self) -> Optional[int]:
        gens = self.generations()
        return gens[-1] if gens else None

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.root, f"gen_{gen:08d}")

    # ------------------------------------------------------------- save
    def save(self, state_dict: Dict, step: Optional[int] = None) -> int:
        entries = self._manifest()
        gen = (int(entries[-1]["gen"]) + 1) if entries else 1
        save_state_dict(state_dict, self._gen_path(gen))
        if _rank() == 0:
            entries.append({"gen": gen, "path": f"gen_{gen:08d}",
                            "step": step, "saved_at": time.time()})
            while len(entries) > self.keep:
                old = entries.pop(0)
                shutil.rmtree(os.path.join(self.root, old["path"]),
                              ignore_errors=True)
            self._write_manifest(entries)
        if dist.is_initialized():
            dist.barrier()
        return gen

    # ------------------------------------------------------------- load
    def _peek_keys(self, gen: int) -> List[str]:
        """State keys a generation recorded (its metadata, no data
        read) — lets a caller whose live state is SMALLER than the
        checkpoint (fresh optimizer, no moments yet) extend the load
        target instead of silently dropping the extra entries."""
        with open(os.path.join(self._gen_path(gen),
                               "metadata.pkl"), "rb") as f:
            meta = pickle.load(f)
        return [k for k in meta if k != "__checkpoint_format__"]

    def load(self, state_dict: Dict,
             generation: Optional[int] = None,
             augment_missing: bool = False) -> int:
        """Fill `state_dict` from `generation` (default: newest),
        falling back past corrupted generations. Returns the
        generation actually loaded. `augment_missing` adds keys the
        generation recorded but the target lacks (placeholder None,
        replaced by the stored value) so a smaller live state — a
        fresh optimizer with no moments yet — still receives the full
        checkpoint instead of its intersection."""
        gens = self.generations()
        if generation is not None:
            gens = [g for g in gens if g <= int(generation)]
        if not gens:
            raise EnforceNotMet(
                f"no checkpoint generation under {self.root!r}"
                + (f" at or below {generation}" if generation is not None
                   else ""))
        last_err: Optional[BaseException] = None
        for gen in reversed(gens):
            added: List[str] = []
            try:
                if augment_missing:
                    for k in self._peek_keys(gen):
                        if k not in state_dict:
                            state_dict[k] = None
                            added.append(k)
                load_state_dict(state_dict, self._gen_path(gen))
                if last_err is not None:
                    from ..observability import metrics
                    metrics.inc("resilience.ckpt_fallbacks")
                    _LOG.warning(
                        "checkpoint generation fallback: loaded gen %d "
                        "after newer generation(s) failed verification "
                        "(%s)", gen, last_err)
                    from ..observability import _state as _OBS
                    if _OBS.FLIGHT:
                        from ..observability import flight
                        flight.note("ckpt", "fallback", loaded=gen,
                                    error=repr(last_err)[:160])
                return gen
            except (EnforceNotMet, OSError, pickle.UnpicklingError,
                    KeyError) as e:
                # a failed generation's placeholder keys must not leak
                # into the next (older) attempt's strict-load key set.
                # KeyError is load_state_dict's strict-load mismatch
                # (e.g. the generation predates the optimizer's first
                # step and lacks its moment keys): an older generation
                # may still satisfy the key set, and the documented
                # contract is to raise only when NO generation loads.
                for k in added:
                    state_dict.pop(k, None)
                last_err = e
        raise EnforceNotMet(
            f"every checkpoint generation under {self.root!r} failed "
            f"verification; newest error: {last_err}")
