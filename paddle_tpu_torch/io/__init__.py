"""Datasets, samplers and a single-process ``DataLoader``: the counterpart
of ``paddle_tpu/io``.

Batches are built on the host with numpy and handed over as ``Tensor``s
on the current device (the card unless ``set_device('cpu')``), one batch
at a time in the calling thread. Not ported yet: worker processes
(``num_workers > 0`` raises), ``DistributedBatchSampler`` and
``DevicePrefetcher``.

``RandomSampler`` draws from an unseeded ``np.random.default_rng()``, as
the reference's does: a shuffled order is not reproducible on either side.
"""
from __future__ import annotations

import numpy as np

from .._core import random as rnd
from .._core.tensor import Tensor, to_tensor

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "ConcatDataset", "random_split", "DataLoader", "BatchSampler",
           "Sampler", "SequenceSampler", "RandomSampler",
           "default_collate_fn"]


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


def default_collate_fn(batch):
    """Samples stacked leaf by leaf (tuples, lists and dicts followed);
    numpy arrays and ``Tensor``s become one ``Tensor``, Python and numpy
    ints an int64 one, floats a float32 one."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, Tensor):
        return to_tensor(np.stack([s.numpy() for s in batch]))
    if isinstance(sample, np.ndarray):
        return to_tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return to_tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return to_tensor(np.asarray(batch, dtype=np.float32))
    return batch


class DataLoader:
    """Batches of ``dataset`` through ``collate_fn``, built in the calling
    thread. ``batch_size=None`` yields single samples."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if num_workers:
            raise NotImplementedError("DataLoader: worker processes "
                                      "(num_workers > 0) are not ported yet")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = 0
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

    def __iter__(self):
        if isinstance(self.dataset, IterableDataset):
            buf = []
            bs = self.batch_sampler.batch_size if self.batch_sampler else 1
            for item in self.dataset:
                buf.append(item)
                if len(buf) == bs:
                    yield self.collate_fn(buf)
                    buf = []
            if buf:
                yield self.collate_fn(buf)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
            return
        for batch_idx in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in batch_idx])
