"""The port's input pipeline (``paddle_tpu_torch/io``) against the JAX
package's on the CPU: ``DataLoader`` with worker processes and its
prefetch thread, ``DistributedBatchSampler``, ``DevicePrefetcher`` and
``NativeTokenLoader``.

Every comparison is exact (bit for bit): batches are built from the same
numpy data by the same numpy code on both sides. Every test that forks
worker processes runs under its own time limit (``timeout`` marker) and
passes the loader a ``timeout`` too, so a hung child fails its test and
does not hold the run.
"""
import os
import random
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch import io
from paddle_tpu_torch._core import device as pt_device

FORK_LIMIT = 60  # seconds a forking test may take


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _images(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 6, 5, 3)).astype(np.uint8),
            rng.randint(0, 10, (n,)).astype(np.int64))


def _dataset(P):
    """A map dataset over fixed numpy images: (CHW float32 image, label,
    a dict leaf), the same class on either side."""
    imgs, labels = _images()

    class Images(P.io.Dataset):
        def __len__(self):
            return len(imgs)

        def __getitem__(self, i):
            x = imgs[i].transpose(2, 0, 1).astype(np.float32) / 255.0
            return x, int(labels[i]), {"w": float(i) * 0.5}
    return Images()


def _np(batches):
    out = []
    for b in batches:
        out.append([b[0].numpy(), b[1].numpy(), b[2]["w"].numpy()])
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


@pytest.mark.timeout(FORK_LIMIT)
@pytest.mark.parametrize("drop_last", [False, True])
def test_workers_match_single_process_and_reference(drop_last):
    kw = dict(batch_size=4, drop_last=drop_last)
    single = _np(io.DataLoader(_dataset(pt), **kw))
    workers = _np(io.DataLoader(_dataset(pt), num_workers=2, timeout=30,
                                **kw))
    reference = _np(ref.io.DataLoader(_dataset(ref), num_workers=2,
                                      timeout=30, **kw))
    _equal(workers, single)
    _equal(workers, [[np.asarray(a) for a in b] for b in reference])
    assert len(single) == (5 if drop_last else 6)


@pytest.mark.timeout(FORK_LIMIT)
def test_worker_batches_keep_sampler_order_with_few_in_flight():
    """Three workers, one batch in flight each, a sampler order that is
    not sequential, single samples (``batch_size=1``) and a user
    ``collate_fn``: the order is the sampler's."""
    order = [[5, 1], [0], [7, 3, 2], [4], [6, 8]]
    ds = _dataset(pt)

    def collate(items):
        return np.stack([it[0] for it in items]), [it[1] for it in items]
    got = list(io.DataLoader(ds, batch_sampler=order, num_workers=3,
                             prefetch_factor=1, collate_fn=collate,
                             timeout=30))
    for idx, (x, labels) in zip(order, got):
        np.testing.assert_array_equal(
            x.numpy(), np.stack([ds[i][0] for i in idx]))
        assert labels == [ds[i][1] for i in idx]


def test_thread_and_direct_paths_match():
    single = _np(io.DataLoader(_dataset(pt), batch_size=5))
    direct = _np(io.DataLoader(_dataset(pt), batch_size=5,
                               use_buffer_reader=False))
    _equal(direct, single)
    assert io.NUM_WORKERS == 0 and io.PREFETCH_FACTOR == 2 \
        and io.PREFETCH_DEPTH == 2


class _Failing(io.Dataset):
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 9:
            raise ValueError("sample 9 is broken")
        return np.full((2,), i, np.float32)


@pytest.mark.timeout(FORK_LIMIT)
def test_worker_error_names_its_batch():
    with pytest.raises(RuntimeError, match=r"batch 2: ValueError: sample 9"):
        list(io.DataLoader(_Failing(), batch_size=4, num_workers=2,
                           timeout=30))


def test_thread_error_surfaces():
    with pytest.raises(ValueError, match="sample 9"):
        list(io.DataLoader(_Failing(), batch_size=4))


class _Slow(io.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        import time
        time.sleep(20)
        return np.zeros(2, np.float32)


@pytest.mark.timeout(FORK_LIMIT)
def test_timeout_is_honoured():
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"timed out after 1.0s waiting "
                                           r"for batch 0"):
        list(io.DataLoader(_Slow(), batch_size=2, num_workers=1, timeout=1))
    assert time.monotonic() - t0 < 10


class _Dies(io.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        os._exit(7)


@pytest.mark.timeout(FORK_LIMIT)
def test_a_dead_worker_is_reported():
    with pytest.raises(RuntimeError, match="died while batch 0"):
        list(io.DataLoader(_Dies(), batch_size=2, num_workers=1, timeout=30))


def _stream(P):
    class Stream(P.io.IterableDataset):
        def __len__(self):  # the reference's loader reads it
            return 7

        def __iter__(self):
            for i in range(7):
                yield np.full((3,), i, np.float32)
    return Stream()


@pytest.mark.timeout(FORK_LIMIT)
def test_iterable_dataset_with_workers_falls_back_to_the_thread():
    with pytest.warns(UserWarning, match="falls back to threaded prefetch"):
        got = [b.numpy() for b in io.DataLoader(_stream(pt), batch_size=3,
                                                num_workers=2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [np.asarray(b.numpy()) for b in ref.io.DataLoader(
            _stream(ref), batch_size=3, num_workers=2)]
    _equal([[g] for g in got], [[w] for w in want])
    assert [len(g) for g in got] == [3, 3, 1]


class _Draws(io.Dataset):
    """Each sample: the worker's next draws of Python ``random``, numpy
    and the port's CPU generator."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.array([random.random(), np.random.rand(),
                         float(torch.rand(1)[0])], np.float64)


@pytest.mark.timeout(FORK_LIMIT)
def test_workers_are_reseeded_and_run_worker_init_fn(tmp_path):
    """Each worker's random state comes from a base seed (drawn from
    numpy's global generator in the parent) plus its id, then
    ``worker_init_fn(worker_id)`` runs: two workers draw different
    augmentations, and a reseeded parent gives the same epoch again."""
    def init(worker_id):
        (tmp_path / f"init{worker_id}").write_text(str(os.getpid()))

    def epoch():
        np.random.seed(123)
        return [b.numpy() for b in io.DataLoader(
            _Draws(), batch_size=2, num_workers=2, prefetch_factor=1,
            worker_init_fn=init, timeout=30)]
    a, b = epoch(), epoch()
    _equal([[x] for x in a], [[x] for x in b])
    # batches 0 and 1 come from workers 0 and 1: their first draws differ
    assert not np.array_equal(a[0], a[1])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["init0", "init1"]


@pytest.mark.timeout(FORK_LIMIT)
def test_worker_init_fn_error_is_raised():
    def init(worker_id):
        raise KeyError("no config")
    with pytest.raises(RuntimeError, match="worker_init_fn raised KeyError"):
        list(io.DataLoader(_Draws(), batch_size=2, num_workers=1,
                           worker_init_fn=init, timeout=30))


def test_samples_and_batches_stay_on_the_host(monkeypatch):
    """The loader builds samples under ``on_host``: a dataset that makes
    ``Tensor``s gets CPU ones even when the current device is the card,
    and the batch reaches the current device only at the end."""
    seen = []

    class Makes(io.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            t = pt.to_tensor(np.full((2,), i, np.float32))
            seen.append(str(t.place))
            return t
    monkeypatch.setattr(pt_device, "_current", "gpu:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.to_tensor(np.zeros(1))  # the current device here: the card
    for buffered in (True, False):
        loader = io.DataLoader(Makes(), batch_size=2,
                               use_buffer_reader=buffered)
        host = next(loader._host_batches())
        assert isinstance(host, np.ndarray), type(host)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(iter(loader))  # the finished batch goes to the card
    assert seen and all("cpu" in s.lower() for s in seen), seen
    # and a transform's Tensor is a CPU one whatever the current device
    from paddle_tpu_torch.vision import transforms as T
    img = np.zeros((4, 4, 3), np.uint8)
    assert "cpu" in str(T.ToTensor()(img).place).lower()
    assert "cpu" in str(T.Normalize(0.5, 0.5)(T.ToTensor()(img)).place)\
        .lower()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("nranks", [1, 3, 4])
def test_distributed_batch_sampler_matches_reference(nranks, drop_last,
                                                     shuffle):
    ds = list(range(22))
    for rank in range(nranks):
        for epoch in (0, 3):
            kw = dict(batch_size=4, num_replicas=nranks, rank=rank,
                      shuffle=shuffle, drop_last=drop_last)
            mine = io.DistributedBatchSampler(ds, **kw)
            theirs = ref.io.DistributedBatchSampler(ds, **kw)
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(mine) == list(theirs)
            assert len(mine) == len(theirs)


def test_distributed_batch_sampler_defaults_to_one_rank():
    s = io.DistributedBatchSampler(list(range(10)), batch_size=3)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_device_prefetcher_yields_the_source_in_order(depth):
    rng = np.random.RandomState(4)
    src = [(rng.randn(3, 2), rng.randint(0, 9, (4,)).astype(np.int32))
           for _ in range(6)]
    src.append({"x": pt.to_tensor(rng.randn(2).astype(np.float32)),
                "n": 7, "y": [rng.randn(1).astype(np.float32)]})
    got = list(io.DevicePrefetcher(iter(src), depth=depth))
    assert len(got) == len(src)
    for (x, y), (gx, gy) in zip(src[:-1], got[:-1]):
        assert isinstance(gx, pt.Tensor) and isinstance(gy, pt.Tensor)
        assert gx.dtype == pt.float64 and gy.dtype == pt.int32
        np.testing.assert_array_equal(gx.numpy(), x)
        np.testing.assert_array_equal(gy.numpy(), y)
    last = got[-1]
    assert last["x"] is src[-1]["x"] and last["n"] == 7
    np.testing.assert_array_equal(last["y"][0].numpy(), src[-1]["y"][0])
    # the reference's prefetcher yields the same values
    theirs = list(ref.io.DevicePrefetcher(iter(src[:-1]), depth=depth))
    for (gx, gy), (rx, ry) in zip(got, theirs):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx.numpy()))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(ry.numpy()))


def _token_file(tmp_path, n=50_000, seed=0):
    path = tmp_path / "tokens.bin"
    rng = np.random.default_rng(seed)
    (rng.zipf(1.2, n) % 50304).astype(np.int32).tofile(path)
    return str(path)


@pytest.mark.parametrize("shuffle", [True, False])
def test_native_token_loader_matches_reference(tmp_path, shuffle):
    from paddle_tpu.io import NativeTokenLoader as RefLoader
    path = _token_file(tmp_path)
    mine = io.NativeTokenLoader(path, seq_len=64, batch_size=4,
                                shuffle=shuffle, seed=3)
    theirs = RefLoader(path, seq_len=64, batch_size=4, shuffle=shuffle,
                       seed=3)
    assert mine.num_windows == theirs.num_windows == (50_000 - 1) // 64
    for _ in range(200):  # past one epoch of windows: a reshuffle
        (t, l), (rt, rl) = next(mine), next(theirs)
        assert t.dtype == np.int32 and t.shape == (4, 64)
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(l, rl)
        np.testing.assert_array_equal(l[:, :-1], t[:, 1:])
    mine.close()
    theirs.close()


def test_native_token_loader_builds_its_own_library():
    """The port builds the library the feed is in (the runtime library of
    ``_core/native.py``) from the repo's sources, into its own build
    directory, and binds it without the reference."""
    from paddle_tpu_torch._core import native
    from paddle_tpu_torch.io import token_feed
    path = token_feed.build()
    assert path.parent == native.REPO / "paddle_tpu_torch" / "csrc" / "build"
    assert path.name == "libpt_runtime.so" and path.exists()
    assert token_feed.library() is native.get_lib()
    with open(token_feed.__file__) as f:
        assert "paddle_tpu._core" not in f.read()


def test_native_token_loader_reports_a_missing_file(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open"):
        io.NativeTokenLoader(str(tmp_path / "none.bin"), 8, 2)


def test_token_batches_through_the_prefetcher(tmp_path):
    path = _token_file(tmp_path)
    plain = io.NativeTokenLoader(path, 32, 2, seed=1)
    fed = io.DevicePrefetcher(io.NativeTokenLoader(path, 32, 2, seed=1))
    for _, (t, l) in zip(range(5), fed):
        want_t, want_l = next(plain)
        assert t.dtype == pt.int32
        np.testing.assert_array_equal(t.numpy(), want_t)
        np.testing.assert_array_equal(l.numpy(), want_l)


@pytest.mark.timeout(FORK_LIMIT)
def test_shared_files_are_reused_only_once_released():
    """A worker writes each batch into a shared file it reuses once the
    parent drops the batch: batches held until the end keep their values
    (no file is reused under them), and an epoch whose batches are
    dropped as they come gives the same values."""
    ds = _dataset(pt)
    loader = io.DataLoader(ds, batch_size=2, num_workers=2,
                           prefetch_factor=1, timeout=30)
    held = list(loader._host_batches())          # host batches, all alive
    dropped = [[np.array(a) for a in (b[0], b[1])]
               for b in loader._host_batches()]  # each dropped at once
    single = list(io.DataLoader(ds, batch_size=2)._produce())
    assert len(held) == len(dropped) == len(single) == 12
    for h, d, s in zip(held, dropped, single):
        for k in (0, 1):
            np.testing.assert_array_equal(h[k], s[k])
            np.testing.assert_array_equal(d[k], s[k])


def test_prefetcher_closes_a_generator_source_when_stopped():
    closed = []

    def gen():
        try:
            for i in range(100):
                yield np.full((2,), i, np.float32)
        finally:
            closed.append(True)
    for depth in (0, 1, 3):
        closed.clear()
        it = iter(io.DevicePrefetcher(gen(), depth=depth))
        assert next(it).numpy()[0] == 0 and next(it).numpy()[0] == 1
        it.close()
        assert closed == [True], depth


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_raises_what_its_source_raised(depth):
    def gen():
        yield np.zeros(2, np.float32)
        raise KeyError("bad shard")
    it = iter(io.DevicePrefetcher(gen(), depth=depth))
    assert next(it).numpy().shape == (2,)
    with pytest.raises(KeyError, match="bad shard"):
        next(it)


def test_prefetcher_places_depth_batches_ahead():
    """The staging thread pulls ``depth`` batches ahead of the one handed
    out and then waits; ``depth`` 0 pulls each batch when it is asked for,
    in the calling thread."""
    for depth in (0, 1, 3):
        pulled = []

        def gen():
            for i in range(10):
                pulled.append(threading.get_ident())
                yield np.full((1,), i, np.int64)
        it = iter(io.DevicePrefetcher(gen(), depth=depth))
        assert next(it).numpy()[0] == 0
        t0 = time.monotonic()
        while len(pulled) < 1 + depth and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        time.sleep(0.2)
        assert len(pulled) == 1 + depth, (depth, len(pulled))
        assert (set(pulled) == {threading.get_ident()}) == (depth == 0)
        assert [t.numpy()[0] for t in it] == list(range(1, 10))


@pytest.mark.parametrize("buffered", [True, False])
def test_loader_builds_and_places_each_batch_on_one_thread(monkeypatch,
                                                           buffered):
    """``num_workers`` 0: the prefetcher's staging thread builds each batch
    and places it; with ``use_buffer_reader=False`` the calling thread
    does both, and no thread is started."""
    built, placed = [], []

    class Marks(io.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            built.append(threading.get_ident())
            return np.full((2,), i, np.float32)
    put = io.DevicePrefetcher._put

    def spy(self, batch):
        placed.append(threading.get_ident())
        return put(self, batch)
    monkeypatch.setattr(io.DevicePrefetcher, "_put", spy)
    threads = threading.active_count()
    it = iter(io.DataLoader(Marks(), batch_size=2,
                            use_buffer_reader=buffered))
    first = next(it)
    assert (threading.active_count() > threads) == buffered
    got = [first.numpy()] + [b.numpy() for b in it]
    _equal([[g] for g in got],
           [[np.repeat(np.arange(2 * k, 2 * k + 2, dtype=np.float32)[:, None],
                       2, 1)] for k in range(3)])
    assert len(set(built)) == 1 and set(placed) == set(built)
    assert (built[0] == threading.get_ident()) == (not buffered)


@pytest.mark.timeout(FORK_LIMIT)
def test_workers_fork_on_the_thread_that_calls_iter(monkeypatch):
    """``iter()`` forks the workers itself, before any batch is asked for:
    never the staging thread, which runs beside the step."""
    import multiprocessing.context as mpc
    forks = []
    start = mpc.ForkProcess.start

    def spy(self):
        forks.append(threading.get_ident())
        start(self)
    monkeypatch.setattr(mpc.ForkProcess, "start", spy)
    it = iter(io.DataLoader(_dataset(pt), batch_size=4, num_workers=2,
                            timeout=30))
    assert forks == [threading.get_ident()] * 2
    assert len(list(it)) == 6
    assert len(forks) == 2
