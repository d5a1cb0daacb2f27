"""Rank functions of the fleet and ZeRO CPU tests
(``tests/test_torch_fleet_ranks.py``, ``tests/test_torch_sharding.py``),
and the numpy inputs both sides of those tests share.

Each function runs on every rank of a world from
``paddle_tpu_torch.testing.dist`` (spawned processes joined over gloo)
and returns numpy values. The workers import this module to unpickle the
functions, so it imports neither ``jax`` nor the JAX package.
"""
import numpy as np
import torch.distributed as dist

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch.distributed import fleet

# the tensor-parallel model of tests/test_mp_multiproc.py
B, S = 2, 6
VOCAB, H, FF = 12, 8, 16


def tp_weights():
    r = np.random.RandomState(3)
    return {
        "emb": (r.randn(VOCAB, H) * 0.2).astype("float32"),
        "w_col": (r.randn(H, FF) * 0.2).astype("float32"),
        "b_col": (r.randn(FF) * 0.1).astype("float32"),
        "w_row": (r.randn(FF, H) * 0.2).astype("float32"),
        "b_row": (r.randn(H) * 0.1).astype("float32"),
        "w_head": (r.randn(H, VOCAB) * 0.2).astype("float32"),
    }


def tp_data():
    r = np.random.RandomState(5)
    ids = r.randint(0, VOCAB, size=(B, S)).astype("int64")
    labels = r.randint(0, VOCAB, size=(B, S)).astype("int64")
    labels[0, 0] = -100  # a padded token: ignore_index masks it
    return ids, labels


def _init_fleet(mp=1, dp=1, pp=1, sharding=1):
    pt.set_device("cpu")
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp, "sharding_degree": sharding}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def tp_step(gathered):
    """The model on mp = world size: each rank holds numpy slices of the
    full weights; returns the mode, the loss, each rank's shard gradients
    and the row bias after ``distributed_model`` broadcast it. With
    ``gathered`` the first column linear gathers its output and the row
    linear cuts its input again (``mp_concat``, ``mp_split``)."""
    from paddle_tpu_torch.distributed.fleet.mp_layers import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    F = pt.nn.functional
    n = dist.get_world_size()
    hcg = _init_fleet(mp=n)
    rank = hcg.get_model_parallel_rank()

    class Model(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = VocabParallelEmbedding(VOCAB, H)
            self.col = ColumnParallelLinear(H, FF, gather_output=gathered)
            self.row = RowParallelLinear(FF, H,
                                         input_is_parallel=not gathered)
            self.head = ColumnParallelLinear(H, VOCAB, has_bias=False,
                                             gather_output=False)
            self.ce = ParallelCrossEntropy()

        def forward(self, ids, labels):
            h = F.gelu(self.col(self.emb(ids)))
            return self.ce(self.head(self.row(h)), labels).mean()

    m = Model()
    w = tp_weights()
    vper, fper = VOCAB // n, FF // n
    v, f = slice(rank * vper, (rank + 1) * vper), \
        slice(rank * fper, (rank + 1) * fper)
    m.emb.weight.set_value(w["emb"][v])
    m.col.weight.set_value(w["w_col"][:, f])
    m.col.bias.set_value(w["b_col"][f])
    m.row.weight.set_value(w["w_row"][f])
    # replicated: rank 0's value reaches every rank through
    # distributed_model (TensorParallel's broadcast)
    m.row.bias.set_value(w["b_row"] + rank)
    m.head.weight.set_value(w["w_head"][:, v])
    model = fleet.distributed_model(m)
    ids, labels = tp_data()
    # labels with the reference's trailing unit dim
    loss = model(pt.to_tensor(ids), pt.to_tensor(labels[..., None]))
    loss.backward()
    return {
        "mode": hcg.get_parallel_mode(),
        "wrapper": type(model).__name__,
        "b_row": m.row.bias.numpy(),
        "loss": float(loss.numpy()),
        "grads": {"emb": m.emb.weight.grad.numpy(),
                  "w_col": m.col.weight.grad.numpy(),
                  "b_col": m.col.bias.grad.numpy(),
                  "w_row": m.row.weight.grad.numpy(),
                  "b_row": m.row.bias.grad.numpy(),
                  "w_head": m.head.weight.grad.numpy()},
    }


# the hybrid optimizer's model of tests/test_hybrid_optimizer.py
def hybrid_weights():
    r = np.random.RandomState(7)
    return {"w": (r.randn(4, 4) * 0.5).astype("float32"),
            "b": (r.randn(4) * 0.5).astype("float32"),
            "tp": [(r.randn(4, 2) * 0.5).astype("float32")
                   for _ in range(2)]}


def hybrid_x(rank):
    return np.full((2, 4), float(rank + 1), np.float32)


def _hybrid_model(rank):
    w = hybrid_weights()
    layer = pt.nn.Linear(4, 4)
    layer.weight.set_value(w["w"])
    layer.bias.set_value(w["b"])
    tp_w = pt.create_parameter([4, 2], "float32")
    tp_w.set_value(w["tp"][rank])
    tp_w.is_distributed = True
    return layer, tp_w


def hybrid_step():
    """mp 2: the replicated layer's gradients differ between the ranks
    (each sees its own input); ``HybridParallelOptimizer`` averages them
    and clips by the hybrid global norm. Returns the parameters after one
    SGD step and whether the clip was swapped in."""
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        HybridParallelClipGrad
    hcg = _init_fleet(mp=2)
    rank = hcg.get_model_parallel_rank()
    layer, tp_w = _hybrid_model(rank)
    opt = pt.optimizer.SGD(
        0.1, parameters=list(layer.parameters()) + [tp_w],
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    hopt = fleet.distributed_optimizer(opt)
    loss = (layer(pt.to_tensor(hybrid_x(rank))) * tp_w.sum()).sum()
    loss.backward()
    hopt.step()
    return {"swapped": isinstance(opt._grad_clip, HybridParallelClipGrad),
            "wrapper": type(hopt).__name__,
            "w": layer.weight.numpy(), "b": layer.bias.numpy(),
            "tp": tp_w.numpy()}


def scaler_skip():
    """mp 2, fp32 with a loss scale: rank 1 alone finds an inf; the step
    is skipped on both ranks."""
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        HybridParallelGradScaler
    hcg = _init_fleet(mp=2)
    rank = hcg.get_model_parallel_rank()
    layer, tp_w = _hybrid_model(rank)
    opt = pt.optimizer.SGD(0.1, parameters=list(layer.parameters())
                           + [tp_w])
    hopt = fleet.distributed_optimizer(opt)
    scaler = HybridParallelGradScaler(
        pt.amp.GradScaler(init_loss_scaling=1024.0), hcg)
    before = layer.weight.numpy().copy()
    loss = (layer(pt.to_tensor(hybrid_x(rank))) * tp_w.sum()).sum()
    scaler.scale(loss).backward()
    if rank == 1:
        g = tp_w._t.grad
        g[0, 0] = float("inf")
    scaler.step(hopt)
    return {"found_inf": scaler._found_inf,
            "unchanged": bool(np.array_equal(layer.weight.numpy(), before)),
            "scale": scaler._scale}


def metrics_values():
    """The reference test's distributed metrics, on each rank."""
    from paddle_tpu_torch.distributed.fleet import metrics as M
    rank = dist.get_rank()
    pos, neg = np.zeros(10), np.zeros(10)
    if rank == 0:
        pos[9] = 5
    else:
        neg[0] = 5
    return {"sum": M.sum(np.asarray([rank + 1.0])),
            "max": M.max(np.asarray([rank + 1.0])),
            "min": M.min(np.asarray([rank + 1.0])),
            "mean": M.mean(np.asarray([rank + 1.0])),
            "tensor_sum": M.sum(pt.to_tensor(np.asarray([rank + 1.0],
                                                        "float32"))),
            "acc": M.acc(correct=80 + rank * 10, total=100),
            "auc": M.auc(pos, neg)}


def rng_streams():
    """Draws outside and inside the tracker's mp stream on mp 2."""
    from paddle_tpu_torch.distributed.fleet import random_
    _init_fleet(mp=2)
    local, glob = random_.model_parallel_random_seed(100)
    tracker = random_.get_rng_state_tracker()
    outside = pt.rand([6]).numpy()
    with tracker.rng_state():
        inside = pt.rand([6]).numpy()
    return {"local": local, "global": glob, "outside": outside,
            "inside": inside}


# the ZeRO model of tests/test_sharding_eager.py
WORLD = 2
STEPS = 3
DIM = 16


def zero_data():
    r = np.random.RandomState(0)
    # rank r trains on X[r] (data parallel)
    X = r.randn(WORLD, 8, DIM).astype("float32")
    Y = r.randn(WORLD, 8, DIM).astype("float32")
    return X, Y


def zero_weights():
    r = np.random.RandomState(11)
    return [(r.randn(DIM, 32) * 0.25).astype("float32"),
            (r.randn(32) * 0.1).astype("float32"),
            (r.randn(32, DIM) * 0.18).astype("float32"),
            (r.randn(DIM) * 0.1).astype("float32")]


def _zero_model():
    pt.set_device("cpu")
    nn = pt.nn
    model = nn.Sequential(nn.Linear(DIM, 32), nn.ReLU(), nn.Linear(32, DIM))
    for p, w in zip(model.parameters(), zero_weights()):
        p.set_value(w)
    return model


def zero_run(kind):
    """Three AdamW steps, each rank on its batch, through ``kind``: "2"
    (``DygraphShardingOptimizer``), "2off" (with ``offload``), "3"
    (``DygraphShardingStage3``) or a level of ``group_sharded_parallel``
    ("os", "os_g", "p_g_os"), over every rank. Returns the mean losses,
    the parameters and what each rank holds."""
    from paddle_tpu_torch.distributed import sharding as Z
    F = pt.nn.functional
    rank = dist.get_rank()
    model = _zero_model()
    inner = pt.optimizer.AdamW(1e-2, parameters=model.parameters())
    stage3 = net = route = None
    if kind in ("2", "2off", "3"):
        opt = Z.DygraphShardingOptimizer(inner, offload=kind == "2off")
        if kind == "3":
            stage3 = Z.DygraphShardingStage3(model, optimizer=opt)
        net, zero = stage3 or model, opt
    else:
        net, opt, _ = Z.group_sharded_parallel(model, inner, kind)
        if kind == "p_g_os":
            stage3, zero = net, net.sharded_optimizer
            route = type(net).__name__ + (
                "+DygraphShardingStage3" if net._group is not None else "")
        else:
            zero = opt._zero
            route = type(opt).__name__ + "+" + type(zero).__name__
    full_bytes = sum(p._t.numel() * 4 for p in model.parameters())
    X, Y = zero_data()
    x, y = pt.to_tensor(X[rank]), pt.to_tensor(Y[rank])
    losses, collectives = [], []
    for _ in range(STEPS):
        loss = F.mse_loss(net(x), y)
        loss.backward()
        if stage3 is not None and kind == "3":
            stage3.step_and_release()
        else:
            opt.step()
        opt.clear_grad()
        collectives.append(zero.last_collectives)
        t = pt.to_tensor(loss.numpy())
        D.all_reduce(t)
        losses.append(float(t.numpy()) / WORLD)
    report = {"losses": losses, "route": route,
              "collectives": collectives,
              "state_bytes": zero.state_bytes(),
              "n_owned_states": len(zero.inner_opt._states),
              "states_on_cpu": all(
                  v.device.type == "cpu"
                  for st in zero.inner_opt._states.values()
                  for v in st.values()),
              "full_param_bytes": full_bytes}
    if stage3 is not None:
        report["released_param_bytes"] = stage3.param_bytes()
        stage3.materialize()
    report["params"] = [p.numpy() for p in model.parameters()]
    return report


def zero_save(root):
    """One stage-3 step, then ``save_group_sharded_model`` into ``root``
    (read back on the first rank); returns what was saved and what was
    read."""
    from paddle_tpu_torch.distributed import sharding as Z
    from paddle_tpu_torch.framework import load
    import os
    F = pt.nn.functional
    rank = dist.get_rank()
    model = _zero_model()
    inner = pt.optimizer.AdamW(1e-2, parameters=model.parameters())
    net, opt, _ = Z.group_sharded_parallel(model, inner, "p_g_os")
    X, Y = zero_data()
    F.mse_loss(net(pt.to_tensor(X[rank])), pt.to_tensor(Y[rank])).backward()
    opt.step()
    opt.clear_grad()
    Z.save_group_sharded_model(net, root, opt)
    out = {"opt": {k: v.numpy() if hasattr(v, "numpy") else v
                   for k, v in opt.state_dict().items()},
           "model": {k: v.numpy() for k, v in net.state_dict().items()}}
    dist.barrier()
    if rank == 0:
        out["loaded_model"] = {k: v.numpy() for k, v in load(
            os.path.join(root, "model.pdmodel")).items()}
        out["loaded_opt"] = {k: v.numpy() if hasattr(v, "numpy") else v
                             for k, v in load(
                                 os.path.join(root, "model.pdopt")).items()}
    return out


def destroy_forgets_fleet():
    """``fleet.init`` on this world, then ``destroy_process_group()``:
    what the state read before and after (hybrid group, fleet flag,
    global mesh, the mp layers' regime)."""
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.fleet import mp_layers, topology
    hcg = _init_fleet()

    def state():
        return (topology.get_hybrid_communicate_group() is not None,
                fleet.is_initialized(), mesh.get_mesh() is not None,
                mp_layers._regime()[0])

    before = (state(), mesh.get_mesh() is hcg.mesh)
    D.destroy_process_group()
    return before, state(), dist.is_initialized()
