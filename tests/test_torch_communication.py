"""The eager communication API (``paddle_tpu_torch/distributed/
communication.py``, ``process_group.py``, ``store.py``) on the CPU over
gloo ranks: the counterpart of ``tests/test_communication*.py`` and
``tests/test_process_group.py`` of the reference.

Every collective runs on worlds of 2 and 4 spawned ranks
(``paddle_tpu_torch.testing.dist``; the rank functions are
``tests/torch_comm_ranks.py``) and is held against numpy: the sums exactly
as numpy's float32 sums of the same few small integers, AVG of an integer
tensor truncated as the reference's cast truncates, results written into
the argument in place (a leaf keeps ``stop_gradient=False``), lists
appended in rank order, ``reduce`` leaving the other ranks' tensors as they
were. On one rank, before any ``init_parallel_env``, every collective is
the identity, as the reference's. A ``TCPStore`` hosted by this process
serves the ranks' clients.
"""
import numpy as np
import pytest

import paddle_tpu_torch as pt
import torch_comm_ranks as ranks
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.testing.dist import World

NAMES = ["sum", "max", "min", "prod", "avg", "avg_int", "all_gather",
         "all_gather_object", "broadcast", "broadcast_object_list",
         "reduce", "reduce_scatter", "scatter", "gather", "alltoall",
         "alltoall_shapes", "send_recv", "isend_irecv", "barrier",
         "new_group", "stream", "backend"]


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    with World(request.param) as w:
        yield w


def _want(name, r, n):
    b = [ranks.base(k) for k in range(n)]
    if name == "sum":
        return np.sum(b, axis=0), False
    if name == "max":
        return np.max(b, axis=0), False
    if name == "min":
        return np.min(b, axis=0), False
    if name == "prod":
        return np.prod(np.asarray(b, "float32"), axis=0), False
    if name == "avg":
        return np.sum(b, axis=0) / np.float32(n), False
    if name == "avg_int":
        s = np.sum([[7 * k + 1, 5, -3 * k - 2] for k in range(n)], axis=0)
        return np.trunc(s / n).astype("int64")
    if name == "all_gather":
        return np.stack(b)
    if name == "all_gather_object":
        return [{"rank": k, "tag": "x" * k} for k in range(n)]
    if name == "broadcast":
        return b[n - 1]
    if name == "broadcast_object_list":
        return [{"from": 1}, 2]
    if name == "reduce":
        return np.sum(b, axis=0) if r == n - 1 else b[r]
    if name == "reduce_scatter":
        return np.sum([ranks.base(k, (r + 1,)) + 100 * r for k in range(n)],
                      axis=0)
    if name == "scatter":
        return ranks.base(r, (3,))
    if name == "gather":
        return np.stack(b) if r == 0 else None
    if name == "alltoall":
        return np.array([[j, r] for j in range(n)], "float32")
    if name == "alltoall_shapes":
        return [np.full(r + 1, j, "float32") for j in range(n)]
    if name in ("send_recv", "isend_irecv"):
        return b[(r - 1) % n]
    if name == "barrier":
        return True
    if name == "new_group":
        mine = np.sum(b[:2], axis=0) if r < 2 else b[r]
        return mine, 2, r if r < 2 else -1, True
    if name == "stream":
        return np.sum(b, axis=0)
    if name == "backend":
        return "GLOO", n


def _equal(got, want):
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype or want.dtype == np.float64
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, list) and want and isinstance(want[0], np.ndarray):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_collective_against_numpy(world, name):
    results = world.run(ranks.collective, name)
    n = world.n
    for r, (rank, size, got) in enumerate(results):
        assert (rank, size) == (r, n)
        _equal(got, _want(name, r, n))


def test_tcp_store_across_processes(world):
    with D.TCPStore("127.0.0.1", 0, is_master=True, world_size=world.n,
                    timeout=30) as master:
        results = world.run(ranks.store_client, master.port, world.n)
        totals = sorted(t for t, _ in results)
        # the adds of rank r contribute r + 1, in whatever order they came
        assert totals[-1] == sum(range(1, world.n + 1))
        for _, got in results:
            assert got == [f"hello from {k}" for k in range(world.n)]
        assert int(master.add("counter", 0)) == totals[-1]


# ------------------------------------------------ one rank: the identity

@pytest.fixture
def single(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")
    assert D.get_group().nranks == 1 and D.get_group().pg is None


def _x(v=None):
    return pt.to_tensor(np.arange(6, dtype="float32").reshape(2, 3)
                        if v is None else np.asarray(v, "float32"))


def test_one_rank_reductions_are_the_identity(single):
    for op in ("sum", "max", "min", "prod", "avg"):
        x = _x()
        assert D.all_reduce(x, op=op) is x
        np.testing.assert_array_equal(x.numpy(), _x().numpy())
        D.reduce(x, dst=0, op=op)
        D.broadcast(x, src=0)
        np.testing.assert_array_equal(x.numpy(), _x().numpy())


def test_one_rank_list_collectives_copy(single):
    x = _x()
    for fn, args in ((D.all_gather, ([], x)), (D.gather, (x, []))):
        got = fn(*args)
        assert len(got) == 1 and got[0] is not x
        np.testing.assert_array_equal(got[0].numpy(), x.numpy())
    got = D.alltoall([], [x, _x([1, 2])])
    assert [g.shape for g in got] == [[2, 3], [2]]
    y = _x(np.zeros((2, 3)))
    D.reduce_scatter(y, [_x() + 1.0])
    np.testing.assert_array_equal(y.numpy(), _x().numpy() + 1)
    D.scatter(y, [_x()])
    np.testing.assert_array_equal(y.numpy(), _x().numpy())
    objs = [1, "a"]
    assert D.broadcast_object_list(objs) == [1, "a"]
    assert D.all_gather_object([], {"k": 1}) == [{"k": 1}]
    D.barrier()
    D.wait(y)
    assert D.get_backend() in ("GLOO", "NCCL")


def test_one_rank_point_to_point_raises(single):
    with pytest.raises(RuntimeError, match="multi-process group"):
        D.send(_x(), dst=0)
    with pytest.raises(RuntimeError, match="multi-process group"):
        D.recv(_x(), src=0)
