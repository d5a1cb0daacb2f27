"""Datasets, samplers, ``DataLoader`` and ``DevicePrefetcher``: the
counterpart of ``paddle_tpu/io``.

Batches are built on the host with numpy and handed over as ``Tensor``s
on the current device (the card unless ``set_device('cpu')``). Samples
and collated batches stay on the CPU until then: they are built under
``device.on_host()``, and each batch moves to the card once, through the
pinned staging and side stream of the ``DevicePrefetcher`` that every
``DataLoader`` iterates through.

- ``num_workers == 0``: the prefetcher's staging thread builds and places
  ``prefetch_factor`` batches ahead (with ``use_buffer_reader=False`` the
  calling thread builds and places each batch when it is asked for);
- ``num_workers > 0``: worker processes forked by ``iter()`` on the
  calling thread, each reseeded from a base seed and its id (Python
  ``random``, numpy, torch's CPU generator), then
  ``worker_init_fn(worker_id)``; batch k is built by worker k mod
  ``num_workers``, at most ``prefetch_factor`` batches in flight a worker;
  each batch is stacked straight into one of the worker's anonymous
  shared-memory files (``memfd``, reused once the parent lets go of the
  batch in it) and yielded in sampler order. A worker's exception is
  raised in the parent naming the batch; ``timeout`` (0: 120 s, as the
  reference) bounds the wait for one batch. An ``IterableDataset`` falls
  back to the staging thread, with the reference's warning.
  ``persistent_workers`` and ``use_shared_memory`` change no result and
  are accepted as they are (workers start with each epoch; batches always
  go through shared memory).

``RandomSampler`` draws from an unseeded ``np.random.default_rng()``, as
the reference's does: a shuffled order is not reproducible on either side.
``NativeTokenLoader`` (``token_feed.py``) reads a flat int32 token file
through the repo's ``csrc/data_feed.cc``.
"""
from __future__ import annotations

import mmap
import os
import queue
import random
import threading
import time
import types
import warnings
import weakref
from multiprocessing import reduction

import numpy as np
import torch

from .._core import device as _device
from .._core import lazy as _lazy
from .._core import random as rnd
from .._core.tensor import Tensor, to_tensor
from ..observability import _state as _OBS

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "ConcatDataset", "random_split", "DataLoader", "BatchSampler",
           "Sampler", "SequenceSampler", "RandomSampler",
           "DistributedBatchSampler", "default_collate_fn",
           "DevicePrefetcher", "NativeTokenLoader"]

# the reference's flag defaults (paddle_tpu/_core/flags.py): the port has
# no flag registry yet
NUM_WORKERS = 0          # FLAGS_dataloader_num_workers
PREFETCH_FACTOR = 2      # FLAGS_dataloader_prefetch_factor
PREFETCH_DEPTH = 2       # FLAGS_prefetch_depth
WORKER_WAIT = 120.0      # the reference's wait for a batch when timeout is 0
STOP_WAIT = 30.0         # seconds a stopped prefetcher waits for its thread
_ALIGN = 64              # byte alignment of each array in a shared batch


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    """Row ``idx`` of each of ``tensors``."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if d == 0 else int(self.cum[d - 1])
        return self.datasets[d][idx - prev]


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths (or fractions), from a
    permutation seeded by ``paddle.seed`` (0 when unseeded), as the
    reference draws it."""
    n = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(round(l * n)) for l in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    idx = np.random.RandomState(rnd.get_seed() or 0).permutation(n)
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, idx[off:off + l].tolist()))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.default_rng()
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler`` (or a sequential
    or random sampler over ``dataset``); the last short one kept unless
    ``drop_last``."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """The dataset sharded across data-parallel ranks: every rank takes
    ``ceil(n / nranks)`` indices (the first ones repeated to fill the
    last round), rank r the ones at r, r + nranks, ...; shuffled by
    ``np.random.RandomState(epoch)``. World size and rank come from
    ``torch.distributed`` when a process group exists, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        grouped = dist.is_available() and dist.is_initialized()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else (
            dist.get_world_size() if grouped else 1)
        self.local_rank = rank if rank is not None else (
            dist.get_rank() if grouped else 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n)\
                .tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - n)]
        batch = []
        for idx in indices[self.local_rank::self.nranks]:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Samples stacked leaf by leaf (tuples, lists and dicts followed);
    numpy arrays and ``Tensor``s become one ``Tensor``, Python and numpy
    ints an int64 one, floats a float32 one."""
    return _tree_map(lambda x: to_tensor(x) if isinstance(x, np.ndarray)
                     else x, _np_collate(batch))


def _np_collate(batch, stack=np.stack):
    """``default_collate_fn`` with numpy leaves: what the prefetch thread
    builds (the workers pass ``stack=_Stack`` and stack into shared
    memory)."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [_np_collate(list(items), stack) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _np_collate([b[k] for b in batch], stack)
                for k in sample}
    if isinstance(sample, Tensor):
        return stack([s.numpy() for s in batch])
    if isinstance(sample, np.ndarray) and not sample.dtype.hasobject:
        return stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return batch


def _tree_map(fn, obj):
    """``fn`` on every leaf of nested tuples, lists and dicts (their types
    kept)."""
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tree_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return fn(obj)


def _host_array(x):
    """A leaf as a numpy array where it is a tensor (on the CPU here)."""
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


# ------------------------------------------------- shared-memory batches

class _Stack:
    """A leaf of the default collate not stacked yet: its samples' arrays,
    stacked straight into shared memory."""
    __slots__ = ("arrays", "dtype", "shape")

    def __init__(self, arrays):
        self.arrays = arrays
        self.dtype = np.result_type(*arrays)
        self.shape = (len(arrays),) + arrays[0].shape


def _plan(batch):
    """``_np_collate``'s tree with each array leaf left as a ``_Stack``."""
    return _np_collate(batch, stack=_Stack)


class _Slot:
    """An array's place in a shared file: offset, dtype, shape."""
    __slots__ = ("off", "dtype", "shape")

    def __init__(self, off, dtype, shape):
        self.off, self.dtype, self.shape = off, dtype, shape


class _SharedFiles:
    """A worker's anonymous shared-memory files (``memfd``), each reused
    once the parent has let go of the batch it held: writing into pages
    already mapped costs a copy, where a fresh file costs its pages too."""

    def __init__(self, free_q):
        self.free_q = free_q
        self.files = {}          # id -> (fd, mmap, size)
        self.free = set()

    def take(self, size):
        """(id, mapping, whether the parent has not seen it) of a free
        file of at least ``size`` bytes."""
        while True:
            try:
                self.free.add(self.free_q.get_nowait())
            except queue.Empty:
                break
        fits = [i for i in self.free if self.files[i][2] >= size]
        if fits:
            i = min(fits, key=lambda j: self.files[j][2])
            self.free.discard(i)
            return i, self.files[i][1], False
        fd = os.memfd_create("pt_batch", os.MFD_CLOEXEC)
        os.ftruncate(fd, size)
        i = len(self.files)
        self.files[i] = (fd, mmap.mmap(fd, size), size)
        return i, self.files[i][1], True


def _to_shared(tree, files):
    """A batch written into one of ``files``: (the tree with each array,
    stacked or not, replaced by its ``_Slot``, the file's id, its
    descriptor wrapped for the parent the first time it is sent, the
    file's size). Arrays of Python objects stay in the tree (pickled)."""
    leaves, off = [], 0

    def place(x):
        nonlocal off
        x = _host_array(x)
        if isinstance(x, _Stack) or (isinstance(x, np.ndarray)
                                     and not x.dtype.hasobject):
            slot = _Slot(off, np.dtype(x.dtype).str, tuple(x.shape))
            leaves.append((slot, x))
            nbytes = int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
            off += -(-nbytes // _ALIGN) * _ALIGN
            return slot
        return x
    spec = _tree_map(place, tree)
    fid, mm, new = files.take(max(off, _ALIGN))
    for slot, x in leaves:
        view = np.frombuffer(mm, np.dtype(slot.dtype),
                             int(np.prod(slot.shape)), slot.off)\
            .reshape(slot.shape)
        if isinstance(x, _Stack):
            np.stack(x.arrays, out=view)
        else:
            view[...] = x
        del view
    handle = reduction.DupFd(files.files[fid][0]) if new else None
    return spec, fid, handle, files.files[fid][2]


def _release(free_q, fid):
    try:
        free_q.put(fid)
    except (ValueError, OSError):  # the epoch ended: the worker is gone
        pass


def _from_shared(payload, maps, free_q):
    """The batch ``_to_shared`` wrote, its arrays views of the worker's
    file (mapped once per file, in ``maps``); the file goes back to the
    worker when the last view is gone."""
    spec, fid, handle, size = payload
    if handle is not None:
        fd = handle.detach()
        try:
            maps[fid] = mmap.mmap(fd, size)
        finally:
            os.close(fd)
    base = np.frombuffer(maps[fid], np.uint8, size)
    weakref.finalize(base, _release, free_q, fid)

    def view(x):
        if not isinstance(x, _Slot):
            return x
        n = int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
        return base[x.off:x.off + n].view(x.dtype).reshape(x.shape)
    return _tree_map(view, spec)


def _seed_worker(seed: int) -> None:
    """A worker's random state from its seed: Python's ``random``, numpy's
    global generator, torch's CPU generator and the port's CPU generator
    (never the card's: the child must not touch CUDA)."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.default_generator.manual_seed(seed)
    gen = rnd._generators.get(torch.device("cpu"))
    if gen is not None:
        gen.manual_seed(seed)


def _worker_loop(dataset, collate, index_q, data_q, free_q, worker_id, seed,
                 init_fn):
    """A worker process: the port's tensors on the CPU, one torch thread,
    its random state reseeded, ``init_fn(worker_id)``; then each (seq,
    indices) it takes becomes a batch in shared memory, or the error it
    raised, until None."""
    _device._current = "cpu"
    _device._local.cpu = True
    torch.set_num_threads(1)
    _seed_worker(seed)
    files = _SharedFiles(free_q)
    try:
        if init_fn is not None:
            init_fn(worker_id)
    except Exception as e:  # raised in the parent
        data_q.put((None, None, f"worker {worker_id}: worker_init_fn "
                                f"raised {type(e).__name__}: {e}"))
        return
    while True:
        item = index_q.get()
        if item is None:
            break
        seq, idx = item
        try:
            data_q.put((seq, _to_shared(collate([dataset[j] for j in idx]),
                                        files), None))
        except Exception as e:  # raised in the parent
            data_q.put((seq, None, f"{type(e).__name__}: {e}"))


class DataLoader:
    """Batches of ``dataset`` through ``collate_fn`` in sampler order, on
    the current device (module docstring). ``batch_size=None`` yields
    single samples."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=None, use_buffer_reader=True,
                 prefetch_factor=None, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = NUM_WORKERS if num_workers is None \
            else int(num_workers)
        self.prefetch_factor = max(PREFETCH_FACTOR if prefetch_factor is None
                                   else int(prefetch_factor), 1)
        self.prefetch = self.prefetch_factor if use_buffer_reader else 0
        self.timeout = float(timeout or 0)
        self.worker_init_fn = worker_init_fn
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _host_collate(self):
        return _np_collate if self.collate_fn is default_collate_fn \
            else self.collate_fn

    def _worker_collate(self):
        return _plan if self.collate_fn is default_collate_fn \
            else self.collate_fn

    def _index_lists(self):
        if self.batch_sampler is None:
            return ([i] for i in range(len(self.dataset)))
        return iter(self.batch_sampler)

    def _produce(self):
        """Host batches, each built when it is pulled."""
        collate = self._host_collate()
        if isinstance(self.dataset, IterableDataset):
            buf = []
            bs = self.batch_sampler.batch_size \
                if self.batch_sampler is not None else 1
            for item in self.dataset:
                buf.append(item)
                if len(buf) == bs:
                    yield collate(buf)
                    buf = []
            if buf:
                yield collate(buf)
            return
        for idx in self._index_lists():
            yield collate([self.dataset[i] for i in idx])

    def _host_batches(self):
        """This epoch's host batches: from worker processes, forked now
        (``_WorkerBatches``), or built in the thread that pulls them, each
        under ``device.on_host()``."""
        if self.num_workers > 0 and isinstance(self.dataset,
                                               IterableDataset):
            warnings.warn("DataLoader: num_workers>0 with an "
                          "IterableDataset falls back to threaded prefetch")
        elif self.num_workers > 0:
            return _WorkerBatches(self)
        return _on_host(self._produce())

    def __iter__(self):
        # the workers fork here, on the calling thread; the prefetcher's
        # staging thread then pulls, builds (num_workers 0) and places
        # ``prefetch_factor`` batches ahead (none ahead and no thread with
        # use_buffer_reader=False)
        return iter(DevicePrefetcher(self._host_batches(),
                                     depth=self.prefetch))

    def _wait(self, data_q, procs, want):
        """The next message of the workers; raises when a worker died or
        the wait for batch ``want`` outlasts the timeout."""
        limit = self.timeout or WORKER_WAIT
        t0 = time.monotonic()
        while True:
            left = limit - (time.monotonic() - t0)
            if left <= 0:
                raise RuntimeError(f"DataLoader timed out after {limit}s "
                                   f"waiting for batch {want}")
            try:
                return data_q.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [p.pid for p in procs if not p.is_alive()]
                if dead:
                    raise RuntimeError(f"DataLoader worker(s) {dead} died "
                                       f"while batch {want} was pending")


def _on_host(items):
    """``items`` pulled one by one, each under ``device.on_host()`` (the
    thread that pulls places the batch after, on the current device)."""
    items = iter(items)
    while True:
        with _device.on_host():
            try:
                item = next(items)
            except StopIteration:
                return
        yield item


def _terminate(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)


class _WorkerBatches:
    """One epoch of a ``DataLoader``'s worker processes, forked when this
    is made, on the thread that makes it: a fork from a thread other than
    the one running the step could copy a lock that the step's thread
    holds (OpenMP's, logging's) into the child, held for good. Then an
    iterator of the workers' host batches in sampler order, at most
    ``prefetch_factor`` in flight a worker. ``close()`` (also on the last
    batch, an error, or collection) ends the workers."""

    def __init__(self, loader):
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        n = loader.num_workers
        self._loader = loader
        self._index_qs = [ctx.Queue() for _ in range(n)]
        self._free_qs = [ctx.Queue() for _ in range(n)]
        self._maps = [{} for _ in range(n)]
        self._data_q = ctx.Queue()
        base_seed = int(np.random.randint(0, 2**31 - 1))
        self._procs = [ctx.Process(target=_worker_loop, daemon=True, args=(
            loader.dataset, loader._worker_collate(), self._index_qs[wid],
            self._data_q, self._free_qs[wid], wid, base_seed + wid,
            loader.worker_init_fn)) for wid in range(n)]
        for p in self._procs:
            p.start()
        self._end = weakref.finalize(self, _terminate, self._procs)
        self._lists = loader._index_lists()
        self._in_flight = loader.prefetch_factor * n
        self._sent = self._want = 0
        self._pending = {}
        self._send()

    def _send(self):
        while self._end.alive and \
                self._sent - self._want < self._in_flight:
            idx = next(self._lists, None)
            if idx is None:
                return
            # batch k goes to worker k mod W: which worker draws a batch's
            # augmentations does not depend on timing
            self._index_qs[self._sent % len(self._index_qs)].put(
                (self._sent, list(idx)))
            self._sent += 1

    def __iter__(self):
        return self

    def __next__(self):
        while self._want not in self._pending:
            if not self._end.alive or self._want >= self._sent:
                self.close()
                raise StopIteration
            try:
                seq, payload, err = self._loader._wait(
                    self._data_q, self._procs, self._want)
                if err is not None:
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {seq}: {err}")
            except BaseException:
                self.close()
                raise
            # mapped at once: the worker's shared file lives until this
            # process holds it
            wid = seq % len(self._procs)
            self._pending[seq] = _from_shared(payload, self._maps[wid],
                                              self._free_qs[wid])
        batch = self._pending.pop(self._want)
        self._want += 1
        self._send()
        return batch

    def close(self):
        """Ends the workers: each sent its ``None`` once every batch came
        in (a file descriptor may still travel until then), else
        terminated."""
        if not self._end.alive:
            return
        if self._want >= self._sent:
            for q in self._index_qs:
                q.put(None)
            for p in self._procs:
                p.join(timeout=5)
        self._end()


class DevicePrefetcher:
    """Keeps the next ``depth`` batches of ``source`` (numpy arrays or
    ``Tensor``s in nested tuples, lists and dicts: a ``DataLoader``, a
    ``NativeTokenLoader``, a generator) placed on the current device while
    the step runs (default 2: ``FLAGS_prefetch_depth``)::

        for tokens, labels in DevicePrefetcher(loader):
            loss = train_step(tokens, labels)

    A staging thread pulls each batch from ``source`` and places it,
    ``depth`` batches ahead of the one handed out; ``depth`` 0 pulls and
    places each batch in the calling thread when it is asked for (the
    reference's synchronous placement). On the card each leaf is copied
    into a pinned host buffer and from there to the card with
    ``non_blocking=True`` on a side stream (``self.stream``, made when
    iteration starts, on the device current then); the consumer's stream
    waits on the batch's event when the batch is handed out, and
    ``record_stream`` tells the caching allocator that stream uses it. The
    pinned buffers come from torch's caching host allocator, which gives a
    block out again only after the copy recorded on it has finished. A
    ``Tensor`` already on the device passes through untouched. On the CPU,
    numpy leaves become ``Tensor``s (copies) and ``Tensor``s pass. Every
    leaf keeps its type, as in the reference (float64 stays float64). A
    generator ``source`` (or a loader's workers) is closed when iteration
    ends; an exception ``source`` raises is raised to the consumer.

    While a telemetry plane is on, each placed leaf runs in an ``io::h2d``
    span carrying its bytes (the copy is asynchronous on the card: the
    span times its dispatch; the memory plane's census marks it
    ``io:h2d``), and a pull that finds no batch ready blocks the consumer
    inside an ``io::input_wait`` span (the goodput plane's input-wait
    bucket)."""

    def __init__(self, source, depth: int = None):
        self._source = iter(source)
        self._depth = PREFETCH_DEPTH if depth is None else int(depth)
        self.device = self.stream = None  # set when iteration starts

    def _stage(self, x, made):
        if _OBS.ACTIVE and isinstance(x, (torch.Tensor, Tensor, np.ndarray)):
            from ..observability.spans import span
            _memtel = None
            if _OBS.MEM:
                from ..observability import memory as _memtel
                _memtel.set_site("io:h2d")
            nb = int(x.nbytes) if isinstance(x, np.ndarray) else int(
                x.numel() * x.element_size()) if isinstance(
                x, torch.Tensor) else 0
            try:
                with span("io::h2d", hist="io.h2d_us", bytes=nb):
                    return self._stage_leaf(x, made)
            finally:
                if _memtel is not None:
                    _memtel.clear_site()
        return self._stage_leaf(x, made)

    def _stage_leaf(self, x, made):
        if isinstance(x, torch.Tensor):
            x = Tensor(x)
        if isinstance(x, Tensor):
            if x._t.device == self.device:
                return x
            src = x._t.detach()
        elif isinstance(x, np.ndarray) and not x.dtype.hasobject:
            if x.dtype.name == "bfloat16":
                return to_tensor(x, dtype="bfloat16", place=self.device)
            src = torch.from_numpy(np.array(x) if self.stream is None
                                   else np.ascontiguousarray(x))
        else:
            return x
        if self.stream is None:
            return Tensor(src.to(self.device))
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        with torch.cuda.stream(self.stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(pinned, non_blocking=True)
        made.append(out)
        return Tensor(out)

    def _put(self, batch):
        made = []
        tree = _tree_map(lambda x: self._stage(x, made), batch)
        # batches cross threads landed: a consumer never reads a value
        # pending in this thread's lazy window
        _lazy.flush_active("loader")
        event = None
        if made:
            event = torch.cuda.Event()
            event.record(self.stream)
        return tree, made, event

    def _take(self, staged):
        tree, made, event = staged
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in made:
                t.record_stream(cur)
        return tree

    @staticmethod
    def _pull(source):
        """The next item of ``source`` (an iterator, or the staging queue)
        where the consumer waits for it: an ``io::input_wait`` span while a
        telemetry plane is on."""
        get = source.get if isinstance(source, queue.Queue) \
            else lambda: next(source)
        if not _OBS.ACTIVE:
            return get()
        from ..observability.spans import span
        with span("io::input_wait", hist="io.input_wait_us"):
            return get()

    def _close_source(self):
        # a loader's generator or workers stop now, not when collected
        if isinstance(self._source, (types.GeneratorType, _WorkerBatches)):
            self._source.close()

    def __iter__(self):
        self.device = _device.default_device()
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        if self._depth < 1:
            try:
                while True:
                    try:
                        batch = self._pull(self._source)
                    except StopIteration:
                        return
                    yield self._take(self._put(batch))
            finally:
                self._close_source()
        # the staging thread's current stream is the consumer's: a nested
        # prefetcher's batches (a DataLoader's) wait on the right stream
        consumer = torch.cuda.current_stream(self.device) if cuda else None
        q: "queue.Queue" = queue.Queue()
        slots = threading.Semaphore(self._depth)
        stop = threading.Event()

        def work():
            if cuda:
                torch.cuda.set_device(self.device)
                torch.cuda.set_stream(consumer)
            try:
                while True:
                    slots.acquire()
                    if stop.is_set():
                        break
                    try:
                        batch = next(self._source)
                    except StopIteration:
                        break
                    q.put(("batch", self._put(batch)))
            except BaseException as e:  # raised in the consumer
                q.put(("error", e))
            finally:
                self._close_source()
                q.put(("done", None))

        th = threading.Thread(target=work, daemon=True)
        th.start()
        try:
            while True:
                if _OBS.ACTIVE and q.empty():
                    kind, item = self._pull(q)
                else:
                    kind, item = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise item
                slots.release()
                yield self._take(item)
        finally:
            stop.set()
            slots.release()
            th.join(timeout=STOP_WAIT)


from .token_feed import NativeTokenLoader  # noqa: E402,F401
