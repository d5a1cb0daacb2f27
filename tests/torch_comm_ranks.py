"""Rank functions of the eager communication API's and ``DataParallel``'s
CPU tests (``tests/test_torch_communication.py``,
``tests/test_torch_data_parallel.py``).

Each runs on every rank of a world from ``paddle_tpu_torch.testing.dist``
(spawned processes joined over gloo) and returns numpy values for the test
to hold against numpy or the reference. The workers import this module to
unpickle the functions, so it imports neither ``jax`` nor the JAX package.
"""
import numpy as np
import torch.distributed as dist

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as D


def _t(v, dtype="float32", stop_gradient=True):
    pt.set_device("cpu")
    return pt.to_tensor(np.asarray(v, dtype), stop_gradient=stop_gradient)


def base(rank, shape=(2, 3)):
    """The test value of ``rank``: its own numbers, 1-based so products
    and minima differ from rank to rank."""
    return np.arange(1, 1 + int(np.prod(shape)),
                     dtype="float32").reshape(shape) + 10 * rank


def collective(name):
    """Runs the collective ``name`` on this rank and returns what the rank
    holds after it (numpy), with the rank and world size."""
    pt.set_device("cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    out = None
    if name in ("sum", "max", "min", "prod", "avg"):
        x = _t(base(r), stop_gradient=False)
        D.all_reduce(x, op=name)
        out = (x.numpy(), x.stop_gradient)
    elif name == "avg_int":
        x = _t([7 * r + 1, 5, -3 * r - 2], "int64")
        D.all_reduce(x, op=D.ReduceOp.AVG)
        out = x.numpy()
    elif name == "all_gather":
        got = []
        D.all_gather(got, _t(base(r)))
        out = np.stack([g.numpy() for g in got])
    elif name == "all_gather_object":
        got = []
        D.all_gather_object(got, {"rank": r, "tag": "x" * r})
        out = got
    elif name == "broadcast":
        x = _t(base(r))
        D.broadcast(x, src=n - 1)
        out = x.numpy()
    elif name == "broadcast_object_list":
        objs = [{"from": r}, r * 2]
        D.broadcast_object_list(objs, src=1)
        out = objs
    elif name == "reduce":
        x = _t(base(r))
        D.reduce(x, dst=n - 1, op=D.ReduceOp.SUM)
        out = x.numpy()
    elif name == "reduce_scatter":
        parts = [_t(base(r, (j + 1,)) + 100 * j) for j in range(n)]
        x = _t(np.zeros(r + 1))
        D.reduce_scatter(x, parts)
        out = x.numpy()
    elif name == "scatter":
        parts = [_t(base(j, (3,))) for j in range(n)] if r == 0 else None
        x = _t(np.zeros(3))
        D.scatter(x, parts, src=0)
        out = x.numpy()
    elif name == "gather":
        got = [] if r == 0 else None
        D.gather(_t(base(r)), got, dst=0)
        out = None if got is None else np.stack([g.numpy() for g in got])
    elif name == "alltoall":
        got = []
        D.alltoall(got, [_t([r, j]) for j in range(n)])
        out = np.stack([g.numpy() for g in got])
    elif name == "alltoall_shapes":
        got = []
        D.alltoall(got, [_t(np.full(j + 1, r)) for j in range(n)])
        out = [g.numpy() for g in got]
    elif name in ("send_recv", "isend_irecv"):
        x = _t(base(r))
        y = _t(np.zeros((2, 3)))
        to, frm = (r + 1) % n, (r - 1) % n
        tasks = []
        for step in ((0, 1) if r % 2 == 0 else (1, 0)):
            if name == "send_recv":
                D.send(x, dst=to) if step == 0 else D.recv(y, src=frm)
            else:
                tasks.append(D.isend(x, dst=to) if step == 0
                             else D.irecv(y, src=frm))
        assert all(t.wait() for t in tasks)
        out = y.numpy()
    elif name == "barrier":
        D.barrier()
        out = True
    elif name == "new_group":
        g = D.new_group([0, 1])
        x = _t(base(r))
        if r in (0, 1):
            D.all_reduce(x, group=g)
        out = (x.numpy(), g.nranks, g.rank, D.get_group(g.id) is g)
    elif name == "stream":
        x = _t(base(r))
        D.stream.all_reduce(x)
        D.wait(x)
        out = x.numpy()
    elif name == "backend":
        out = (D.get_backend(), D.get_group().nranks)
    return r, n, out


# --------------------------------------------------------------- TCPStore

def store_client(port, world):
    """Each rank connects to the test process's store: a set, an add, a
    barrier and a read of every rank's key."""
    r = dist.get_rank()
    store = D.TCPStore("127.0.0.1", port, is_master=False, world_size=world,
                       timeout=30)
    store.set(f"rank{r}", f"hello from {r}")
    total = store.add("counter", r + 1)
    store.barrier("all", timeout=30)
    got = [store.get(f"rank{k}").decode() for k in range(world)]
    store.barrier("all", timeout=30)
    store.close()
    return total, got


# ------------------------------------------------------------ DataParallel

def _gpt(cfg, weights):
    from paddle_tpu_torch.models import gpt
    pt.set_device("cpu")
    model = gpt.GPTForPretraining(gpt.GPTConfig(**cfg))
    model.set_state_dict({k: pt.to_tensor(v) for k, v in weights.items()})
    return model, gpt.GPTPretrainingCriterion()


def dp_gpt(cfg, weights, batches, bucket_mb, lr):
    """DataParallel of the GPT on this rank's half of each batch: batch 0
    under ``no_sync()`` (local accumulation), batch 1 synced and an SGD
    step, batch 2 synced and a second step. Returns the rank's losses, the
    gradients of the first sync, the parameters after, and the buckets and
    collectives of a sync."""
    r, n = dist.get_rank(), dist.get_world_size()
    model, crit = _gpt(cfg, weights)
    dp = D.DataParallel(model, comm_buffer_size=bucket_mb)
    opt = pt.optimizer.SGD(lr, parameters=dp.parameters())

    def half(b):
        x, y = b
        k = x.shape[0] // n
        return pt.to_tensor(x[r * k:(r + 1) * k]), \
            pt.to_tensor(y[r * k:(r + 1) * k])

    losses = []
    with dp.no_sync():
        loss = crit(dp(half(batches[0])[0]), half(batches[0])[1])
        loss.backward()
        losses.append(float(loss.numpy()))
    local = [p.grad.numpy().copy() for p in model.parameters()]
    x, y = half(batches[1])
    loss = crit(dp(x), y)
    loss.backward()
    losses.append(float(loss.numpy()))
    synced = [p.grad.numpy().copy() for p in model.parameters()]
    opt.step()
    opt.clear_grad()
    x, y = half(batches[2])
    loss = crit(dp(x), y)
    loss.backward()
    losses.append(float(loss.numpy()))
    opt.step()
    opt.clear_grad()
    return dict(losses=losses, local=local, synced=synced,
                params=[p.numpy() for p in model.parameters()],
                keys=sorted(dp.state_dict()), buckets=dp.last_buckets,
                collectives=dp.last_collectives)


def dp_start_equal(seed):
    """Replicas built from different seeds are equal once wrapped (rank 0's
    parameters are broadcast)."""
    from paddle_tpu_torch import nn
    pt.set_device("cpu")
    pt.seed(seed + dist.get_rank())
    model = nn.Linear(4, 3)
    D.DataParallel(model)
    return [p.numpy() for p in model.parameters()]


def dp_unused(bucket_mb):
    """Rank 0 uses one branch, rank 1 both (``find_unused_parameters``):
    both issue the same collectives; the unused branch's gradient on rank
    0 counts as zeros."""
    from paddle_tpu_torch import nn
    pt.set_device("cpu")
    r = dist.get_rank()

    class Two(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(4, 2)
            self.b = nn.Linear(4, 2)

        def forward(self, x, use_b):
            out = self.a(x).sum()
            return out + self.b(x).sum() if use_b else out

    pt.seed(0)
    model = Two()
    dp = D.DataParallel(model, comm_buffer_size=bucket_mb,
                        find_unused_parameters=True)
    x = _t(np.arange(8).reshape(2, 4) * (r + 1))
    dp(x, use_b=r == 1).backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}, \
        dp.last_collectives
