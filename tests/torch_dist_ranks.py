"""Rank functions of the port's multi-rank CPU tests.

Each runs on every rank of a world from ``paddle_tpu_torch.testing.dist``
(spawned processes joined over gloo) and returns numpy values for the test
to gather. The workers import this module to unpickle the functions, so it
imports neither ``jax`` nor the JAX package. A function whose mesh is
smaller than the world returns None on the ranks outside it.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models.convert import shard_for_rank
from paddle_tpu_torch.models.trainer import tree_map


def _mesh(shape, names):
    """The mesh over the first prod(shape) ranks; None outside it. Every
    rank makes the mesh's groups (a collective over the world)."""
    n = int(np.prod(shape))
    mesh = ProcessMesh(np.arange(n).reshape(shape), list(names))
    mesh.groups()
    return mesh if dist.get_rank() < n else None


def _np(t):
    return t.detach().numpy().copy()


def vocab_parallel(shape, names, hidden, weight, labels):
    """The vocab-parallel loss on this rank's rows of ``weight``: the mean
    loss, the per-token loss, d hidden and d (its rows of) weight."""
    from paddle_tpu_torch.distributed.fleet.mp_ops import \
        vocab_parallel_softmax_cross_entropy
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    w = shard_for_rank({"w": weight}, {"w": P("mp", None)}, mesh)["w"]
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(w).requires_grad_()
    tok = vocab_parallel_softmax_cross_entropy(
        h, w, torch.from_numpy(labels), mesh, axis="mp")
    loss = tok.mean()
    loss.backward()
    return float(loss), _np(tok), _np(h.grad), _np(w.grad)


def vocab_lookup(shape, names, weight, ids, cot):
    """The vocab-parallel lookup on this rank's rows: the rows, and d (its
    rows of) weight under the cotangent ``cot``."""
    from paddle_tpu_torch.distributed.fleet.mp_ops import \
        vocab_parallel_lookup
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    w = shard_for_rank({"w": weight}, {"w": P("mp", None)}, mesh)["w"]
    w = torch.from_numpy(w).requires_grad_()
    rows = vocab_parallel_lookup(w, torch.from_numpy(ids),
                                 mesh.get_group("mp"))
    (rows * torch.from_numpy(cot)).sum().backward()
    return _np(rows), _np(w.grad)


def _affine_block(a, blk):
    return torch.tanh(a @ blk["w"] + blk["b"])


def pipeline(pp, num_micro, remat, w, b, x, cot):
    """``pipelined_trunk`` over a pp mesh: the output, and the gradients of
    sum(out * cot) in x and in this stage's layers of w and b."""
    from paddle_tpu_torch.distributed.pipeline_compiled import \
        pipelined_trunk
    mesh = _mesh((pp,), ("pp",))
    if mesh is None:
        return None
    per = w.shape[0] // pp
    stage = slice(mesh.axis_index("pp") * per,
                  (mesh.axis_index("pp") + 1) * per)
    blocks = {"w": torch.from_numpy(w[stage].copy()).requires_grad_(),
              "b": torch.from_numpy(b[stage].copy()).requires_grad_()}
    xt = torch.from_numpy(x).requires_grad_()
    trunk = pipelined_trunk(_affine_block, mesh, num_micro, "pp", remat)
    out = trunk(blocks, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    return (_np(out), _np(xt.grad), _np(blocks["w"].grad),
            _np(blocks["b"].grad))


def flash_spmd(shape, names, q, k, v, do):
    """``mha_spmd`` on this rank's ``[B/dp, H/mp, S, D]`` shard: out, dq,
    dk, dv of the shard under its block of ``do``."""
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.ops.cuda.flash_attention import mha_spmd
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    spec = P("dp", "mp", None, None)
    parts = shard_for_rank({"q": q, "k": k, "v": v, "do": do},
                           {n: spec for n in ("q", "k", "v", "do")}, mesh)
    t = {n: torch.from_numpy(a).requires_grad_() for n, a in parts.items()}
    out = mha_spmd(t["q"], t["k"], t["v"], causal=True)
    (out * t["do"]).sum().backward()
    return _np(out), _np(t["q"].grad), _np(t["k"].grad), _np(t["v"].grad)


def flash_manual(shape, names, q, k, v, do):
    """``mha_manual`` on whole ``[B, H, S, D]`` arrays: None where it takes
    no axis, else out, dq, dk, dv (whole, on every rank)."""
    from paddle_tpu_torch.ops.cuda.flash_attention import mha_manual
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    t = {n: torch.from_numpy(a).requires_grad_()
         for n, a in (("q", q), ("k", k), ("v", v))}
    out = mha_manual(t["q"], t["k"], t["v"], mesh, causal=True)
    if out is None:
        return "none"
    (out * torch.from_numpy(do)).sum().backward()
    return _np(out), _np(t["q"].grad), _np(t["k"].grad), _np(t["v"].grad)


def _model(name):
    from paddle_tpu_torch.models import bert, gpt, llama
    return {"gpt": (gpt, gpt.GPTConfig), "llama": (llama, llama.LlamaConfig),
            "bert": (bert, bert.BertConfig)}[name]


def train(model, config, shape, names, build, params, batches):
    """``models.<model>.build_train_step`` on a mesh from the whole
    ``params``: the loss of each step over ``batches`` (tokens, labels),
    and this rank's shards of the final state (params, master, m, v)."""
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    module, cls = _model(model)
    init_fn, step = module.build_train_step(cls(**config), mesh,
                                            device="cpu", **build)
    state = init_fn(0, params=params)
    losses = []
    for tokens, labels in batches:
        state, loss = step(state, torch.from_numpy(tokens),
                           torch.from_numpy(labels))
        losses.append(float(loss))
    return losses, {k: tree_map(_np, state[k])
                    for k in ("params", "master", "m", "v")}


def pipeline_attention_route(config, shape, names, batch, seq):
    """One GPT step on a pipeline mesh, counting this rank's calls of the
    flash entry (``mha_forward``) from the blocks: the loss and the
    count."""
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    from paddle_tpu_torch.models import gpt
    calls = []
    flash = gpt.mha_forward

    def counted(*args, **kwargs):
        calls.append(1)
        return flash(*args, **kwargs)

    gpt.mha_forward = counted
    try:
        init_fn, step = gpt.build_train_step(
            gpt.GPTConfig(**config), mesh, remat=False, pp_microbatches=2,
            device="cpu")
        state = init_fn(0)
        tokens = torch.zeros((batch, seq), dtype=torch.int64)
        _, loss = step(state, tokens, torch.ones_like(tokens))
    finally:
        gpt.mha_forward = flash
    return float(loss), len(calls)


# ------------------------------------------------ the eager pipeline and
# the semi-auto API (tests/test_torch_pipeline_ranks.py,
# tests/test_torch_dist_api.py, tests/test_torch_dist_checkpoint.py)

def _cpu():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    return pt


def _relu_linear(pt, w, b):
    """relu(x @ w + b) as a port Layer (``w`` is [in, out])."""

    class ReluLinear(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = pt.nn.Linear(w.shape[0], w.shape[1])
            self.lin.set_state_dict({"weight": w, "bias": b})

        def forward(self, x):
            return pt.nn.functional.relu(self.lin(x))

    return ReluLinear()


def _wide(pt, layer, reps, first):
    """The stage ``layer`` with an output of ``reps`` copies of its own
    (the first stage) or an input cut back to its first block (the
    second): the same loss and gradients, an activation ``reps`` times
    wider on the wire."""

    class Wide(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = layer

        def forward(self, x):
            if first:
                return self.inner(x).tile([1, reps])
            return self.inner(x[:, :x.shape[1] // reps])

    return Wide()


_PP_GROUPS = {}


def _pp_group(P):
    """The group of ranks 0 .. P-1 (made once per P, on every rank of the
    world: ``new_group`` is collective over the world)."""
    from paddle_tpu_torch.distributed.process_group import new_group
    if P not in _PP_GROUPS:
        _PP_GROUPS[P] = new_group(list(range(P)))
    return _PP_GROUPS[P]


def eager_pipeline(P, schedule, ws, bs, x, y, m, num_chunks=1, reps=1):
    """``build_pipeline_runtime`` over ranks 0 .. P-1 (None on the others):
    virtual stage v = chunk * P + rank is relu(Linear(ws[v], bs[v])), the
    loss mse; rank 0 holds the m micro-batches of ``x``, the last rank
    those of ``y``. Returns the loss, each chunk's gradients, the stash
    peaks, the ZeroBubble probes, the stage forward calls and the P2P
    sends."""
    pt = _cpu()
    from paddle_tpu_torch.distributed.pipeline import build_pipeline_runtime
    group = _pp_group(P)
    r = group.rank
    if r < 0:
        return None
    chunks = [_relu_linear(pt, ws[c * P + r], bs[c * P + r])
              for c in range(num_chunks)]
    if reps > 1:
        chunks = [_wide(pt, chunks[0], reps, first=r == 0)]
    calls = [0]

    def count(*_):
        calls[0] += 1

    for c in chunks:
        c.register_forward_post_hook(count)
    rt = build_pipeline_runtime(chunks if schedule == "VPP" else chunks[0],
                                group, pt.nn.functional.mse_loss, m,
                                schedule=schedule)
    mb = x.shape[0] // m
    xs = [pt.to_tensor(x[i * mb:(i + 1) * mb]) for i in range(m)] \
        if r == 0 else None
    ys = [pt.to_tensor(y[i * mb:(i + 1) * mb]) for i in range(m)] \
        if r == P - 1 else None
    loss = rt.train_batch(micro_inputs=xs, micro_labels=ys)
    return {"loss": loss,
            "grads": [[_np(p._t.grad) for p in c.parameters()]
                      for c in chunks],
            "max_inflight": rt.max_inflight,
            "max_stash_bytes": rt.max_stash_bytes,
            "counts": getattr(rt, "counts", None),
            "executed": getattr(rt, "executed", None),
            "forward_calls": calls[0], "sends": rt._p2p.sends}


def pipeline_bad_micros(P, schedule, ws, bs, x, y, m):
    """A runtime over ranks 0 .. P-1 handed m - 1 micro-batches on the
    first and last ranks: the error each rank raised and the P2P sends
    made before it (None outside the group)."""
    pt = _cpu()
    from paddle_tpu_torch.distributed.pipeline import build_pipeline_runtime
    group = _pp_group(P)
    r = group.rank
    if r < 0:
        return None
    rt = build_pipeline_runtime(_relu_linear(pt, ws[r], bs[r]), group,
                                pt.nn.functional.mse_loss, m,
                                schedule=schedule)
    short = [pt.to_tensor(x[:2])] * (m - 1)
    try:
        rt.train_batch(micro_inputs=short, micro_labels=short)
    except ValueError as e:
        return f"ValueError: {e}", rt._p2p.sends
    return "no error", rt._p2p.sends


def fleet_pipeline(P, schedule, ws, bs, x, y, m):
    """``fleet.distributed_model`` of a ``PipelineLayer`` of the P stages
    at pp = P (dp takes the rest of the world: one pipeline a dp replica,
    each fed the same batch): the runtime's class and schedule, this
    rank's stage, and the loss and this rank's gradients of one batch
    (the error where it refuses)."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.pipeline import PipelineLayer
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": P, "sharding_degree": 1}
    mb = x.shape[0] // m
    strategy.pipeline_configs = {"accumulate_steps": m,
                                 "micro_batch_size": mb,
                                 "schedule_mode": schedule}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        layers = PipelineLayer(
            [_relu_linear(pt, w, b) for w, b in zip(ws, bs)],
            num_stages=P, loss_fn=pt.nn.functional.mse_loss)
        try:
            rt = fleet.distributed_model(layers)
        except ValueError as e:
            return {"error": str(e)}
        xs = [pt.to_tensor(x[i * mb:(i + 1) * mb]) for i in range(m)]
        ys = [pt.to_tensor(y[i * mb:(i + 1) * mb]) for i in range(m)]
        loss = rt.train_batch(micro_inputs=xs, micro_labels=ys)
        return {"type": type(rt).__name__,
                "schedule": getattr(rt, "schedule", None), "loss": loss,
                "grads": [_np(p._t.grad) for p in rt.stage.parameters()],
                "stage": fleet.get_hybrid_communicate_group().get_stage_id(),
                "pp_ranks": rt.group.ranks}
    finally:
        fleet._forget()


def _placements(spec):
    """A string of "R", "P" and "S<d>" words (one per mesh axis) as
    placements."""
    from paddle_tpu_torch.distributed.placements import (Partial, Replicate,
                                                         Shard)
    return [Replicate() if w == "R" else Partial() if w == "P"
            else Shard(int(w[1:])) for w in spec.split()]


def _dmesh(shape, names):
    from paddle_tpu_torch.distributed.mesh import ProcessMesh
    n = int(np.prod(shape))
    return ProcessMesh(np.arange(n).reshape(shape), list(names))


def reshard_chain(shape, names, x, chain):
    """``x`` given to ``shard_tensor`` replicated, then ``reshard`` to each
    placement list of ``chain`` in turn: this rank's piece after each step
    and the reshard function each step chose (the error where one
    raises)."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api
    from paddle_tpu_torch.distributed.auto_parallel import \
        reshard_functions as rf
    mesh = _dmesh(shape, names)
    t = api.shard_tensor(pt.to_tensor(x), mesh,
                         _placements(" ".join("R" * len(shape))))
    out = []
    for spec in chain:
        cur = t._dist_attr
        chosen = rf.choose_reshard_function(
            rf.DistAttrLite(mesh, cur.placements),
            rf.DistAttrLite(mesh, _placements(spec))).name
        try:
            t = api.reshard(t, mesh, _placements(spec))
        except ValueError as e:
            out.append(("ValueError", str(e)))
            break
        out.append((chosen, _np(t._t), t._dist_attr.global_shape))
    return out


def shard_pieces(shape, names, x, spec):
    """``shard_tensor`` of ``x`` with ``spec``: this rank's piece, or the
    error."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api
    mesh = _dmesh(shape, names)
    try:
        t = api.shard_tensor(pt.to_tensor(x), mesh, _placements(spec))
    except ValueError as e:
        return "ValueError: " + str(e)
    return _np(t._t)


def reshard_grad(shape, names, x, src, dst):
    """d sum(out * out) / d x, where ``out`` is ``x`` sharded with
    ``src`` and moved to ``dst`` (``x`` replicated, every rank's loss its
    own piece's): x's gradient and out's stop_gradient."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api
    mesh = _dmesh(shape, names)
    t = pt.to_tensor(x, stop_gradient=False)
    out = api.reshard(api.shard_tensor(t, mesh, _placements(src)), mesh,
                      _placements(dst))
    if out.stop_gradient:
        return None, True
    (out * out).sum().backward()
    return (None if t.grad is None else _np(t.grad._t)), out.stop_gradient


def cross_mesh(x, src, dst, partial=False):
    """``x`` sharded with ``src`` on ranks [0, 1] (mesh x), moved to ranks
    [2, 3] (mesh y) with ``dst``; with ``partial`` made Partial first and
    the result's backward run. This rank's piece before and after, and
    the result's stop_gradient."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api
    from paddle_tpu_torch.distributed.mesh import ProcessMesh
    mesh_a = ProcessMesh(np.array([0, 1]), ["x"])
    mesh_b = ProcessMesh(np.array([2, 3]), ["y"])
    t = pt.to_tensor(x, stop_gradient=not partial)
    td = api.shard_tensor(t, mesh_a, _placements(src))
    if partial:
        td = api.reshard(td, mesh_a, _placements("P"))
    out = api.reshard(td, mesh_b, _placements(dst))
    if partial and out._t.numel():
        (out * out).sum().backward()
    return _np(td._t), _np(out._t), out.stop_gradient


def local_round_trip(shape, names, x, spec, same_local):
    """``dtensor_from_local`` of this rank's piece of ``x`` under ``spec``
    (or of ``x`` itself on every rank, the reference's single-controller
    case, with ``same_local``), then ``dtensor_to_local`` and
    ``unshard_dtensor``: the global shape, the local piece and the whole
    value; and the gradient d sum(whole * whole) / d local."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api
    mesh = _dmesh(shape, names)
    if same_local:
        local = x
    else:
        local = _np(api.shard_tensor(pt.to_tensor(x), mesh,
                                     _placements(spec))._t)
    lt = pt.to_tensor(local, stop_gradient=False)
    d = api.dtensor_from_local(lt, mesh, _placements(spec))
    whole = api.unshard_dtensor(d)
    (whole * whole).sum().backward()
    return (d._dist_attr.global_shape, _np(api.dtensor_to_local(d)._t),
            _np(whole._t), _np(lt.grad._t),
            [repr(p) for p in api.get_placement_of(d)])


def shard_layer_pieces(shape, names, state, spec):
    """``shard_layer`` of a Linear holding ``state``: its weight Shard by
    ``spec`` (its bias replicated by the default rule). The pieces, and
    whether the parameters stayed the layer's own objects."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api
    mesh = _dmesh(shape, names)
    layer = pt.nn.Linear(*state["weight"].shape)
    layer.set_state_dict(state)
    before = [id(p) for p in layer.parameters()]

    def shard_fn(name, sub, m):
        if isinstance(sub, pt.nn.Linear):
            api.shard_tensor(sub.weight, m, _placements(spec))
            api.shard_tensor(sub.bias, m,
                             _placements(" ".join("R" * len(shape))))

    api.shard_layer(layer, mesh, shard_fn)
    after = [id(p) for p in layer.parameters()]
    return (_np(layer.weight._t), _np(layer.bias._t), before == after,
            [repr(p) for p in layer.weight._dist_attr.placements])


def checkpoint_save(path, shape, names, arrays, specs, extra):
    """``save_state_dict`` of ``arrays`` (name -> whole value) sharded on a
    mesh by ``specs`` (name -> placement words, bf16 where the name ends
    in ``_bf16``), with the non-tensor entries of ``extra``."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api, checkpoint
    mesh = _dmesh(shape, names)
    state = dict(extra)
    for k, a in arrays.items():
        t = pt.to_tensor(a, dtype="bfloat16" if k.endswith("_bf16")
                         else None)
        state[k] = api.shard_tensor(t, mesh, _placements(specs[k]))
    checkpoint.save_state_dict(state, path)
    return sorted(os.listdir(path))


def checkpoint_load(path, shape, names, like, specs, extra):
    """``load_state_dict`` into zero targets shaped as ``like`` (name ->
    whole array) sharded on a mesh by ``specs``: this rank's loaded pieces
    (bf16 ones read as float32) and the non-tensor entries."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api, checkpoint
    mesh = _dmesh(shape, names)
    state = dict.fromkeys(extra)
    for k, a in like.items():
        t = pt.to_tensor(np.zeros_like(a), dtype="bfloat16"
                         if k.endswith("_bf16") else None)
        state[k] = api.shard_tensor(t, mesh, _placements(specs[k]))
    checkpoint.load_state_dict(state, path)
    return ({k: _np(state[k]._t.float()) for k in like},
            {k: state[k] for k in extra})


def context_parallel(kind, shape, names, q, k, v, causal, batch_axis=None,
                     grad=False):
    """``ring_attention_global`` or ``ulysses_attention_global`` (``kind``
    "ring" / "ulysses") of the global q, k, v on a mesh: this rank's
    output piece, its placements and global shape, the unsharded value
    and, with ``grad``, d q, d k, d v of the sum over ranks of
    sum(piece ** 2) (the global sum(out ** 2))."""
    _cpu()
    from paddle_tpu_torch.distributed import api, context_parallel as cp
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    fn = {"ring": cp.ring_attention_global,
          "ulysses": cp.ulysses_attention_global}[kind]
    ts = [torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v)]
    out = fn(*ts, mesh, seq_axis="sep", causal=causal,
             batch_axis=batch_axis)
    res = {"piece": _np(out._t), "full": _np(api.unshard_dtensor(out)._t),
           "placements": [repr(p) for p in out._dist_attr.placements],
           "global_shape": list(out._dist_attr.global_shape)}
    if grad:
        (out._t ** 2).sum().backward()
        res["grads"] = [_np(t.grad) for t in ts]
    return res


def ulysses_heads_error(shape, names, q):
    """``ulysses_attention`` on pieces whose head count the sep axis does
    not divide: the ValueError's message."""
    _cpu()
    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.distributed.mesh import set_mesh
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    set_mesh(mesh)
    try:
        t = torch.from_numpy(q)
        cp.ulysses_attention(t, t, t, "sep")
        return "no error"
    except ValueError as e:
        return str(e)
    finally:
        set_mesh(None)


def ulysses_flash(shape, names, q, k, v, cot):
    """``ulysses_attention`` on this rank's sequence pieces with
    ``attn_fn`` the port's flash entry (causal), and the entry alone on the
    global values: this rank's output piece, the entry's piece, and the
    gradients of sum(out * cot) both ways (the global inputs' gradients
    gathered over the sep axis)."""
    import functools
    _cpu()
    from paddle_tpu_torch.distributed import _collectives as C
    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.distributed.mesh import set_mesh
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    group = mesh.get_group("sep")
    set_mesh(mesh)
    try:
        got = []
        for way in ("ulysses", "entry"):
            ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
            c = torch.from_numpy(cot)
            if way == "ulysses":
                pieces = [C.split(t, 1, group) for t in ts]
                out = cp.ulysses_attention(
                    *pieces, "sep", attn_fn=functools.partial(
                        fa.flash_attention, causal=True))
                (out * C.chunk(c, 1, group)).sum().backward()
            else:
                full = fa.flash_attention(*ts, causal=True)
                out = C.chunk(full, 1, group)
                (full * c).sum().backward()
            got.append([_np(out)] + [_np(t.grad) for t in ts])
        return got
    finally:
        set_mesh(None)


def ring_shift_pair(n, x):
    """``_collectives.ring_shift`` over the first n ranks: this rank's
    received value (x + rank sent on) and the gradient that comes back
    for a cotangent of (rank + 1)."""
    from paddle_tpu_torch.distributed import _collectives as C
    mesh = _mesh((n,), ("sep",))
    if mesh is None:
        return None
    r = dist.get_rank()
    t = torch.from_numpy(x + r).requires_grad_()
    got = C.ring_shift(t, mesh.get_group("sep"))
    (got * float(r + 1)).sum().backward()
    return _np(got), _np(t.grad)


def comm_context_ops(port, n):
    """Every ``CommContext`` operation over the first n ranks, the store's
    server on rank 0 at ``port``: the results by name (numpy), and what
    ``create_negotiated`` gives with FLAGS_pg_native_transport off."""
    from paddle_tpu_torch._core.flags import set_flags
    from paddle_tpu_torch.distributed.comm_context import CommContext
    from paddle_tpu_torch.distributed.store import TCPStore
    rank = dist.get_rank()
    if rank >= n:
        return None
    store = TCPStore("127.0.0.1", port, is_master=rank == 0, world_size=n)
    try:
        cc = CommContext.create_negotiated(store, rank, n, "__cc_test/0")
        out = {"big": cc.all_reduce(np.full(1 << 16, float(rank + 1),
                                            np.float32), "sum")}
        v = np.arange(10, dtype=np.int64) + rank
        out["max"] = cc.all_reduce(v, "max")
        out["min"] = cc.all_reduce(v, "min")
        out["avg"] = cc.all_reduce(np.full(4, float(rank), np.float64),
                                   "avg")
        half = cc.all_reduce(np.full(8, 0.5, np.float16) * (rank + 1),
                             "sum")
        out["f16"] = (half.dtype.name, half.astype(np.float32))
        out["rs"] = cc.reduce_scatter(
            np.arange(n * 6, dtype=np.float32).reshape(n * 3, 2)
            + 100 * rank, "sum")
        out["gather"] = cc.all_gather(np.full((2, 2), rank, np.int32))
        out["bcast"] = cc.broadcast_bytes(
            b"hello-from-1" if rank == 1 else None, 1, 12)
        nxt, prv = (rank + 1) % n, (rank - 1) % n
        msg = np.array([rank * 11.0], np.float64)
        if rank % 2 == 0:
            cc.send(msg, nxt)
            out["p2p"] = cc.recv_into(np.empty(1, np.float64), prv)
        else:
            out["p2p"] = cc.recv_into(np.empty(1, np.float64), prv)
            cc.send(msg, nxt)
        for _ in range(3):
            cc.barrier()
        set_flags({"FLAGS_pg_native_transport": False})
        try:
            out["off"] = CommContext.create_negotiated(store, rank, n,
                                                       "__cc_test/1")
        finally:
            set_flags({"FLAGS_pg_native_transport": True})
        return out
    finally:
        # rank 0 serves the store: the others leave it first
        if rank:
            store.close()
        dist.barrier(group=_mesh((n,), ("cc",)).get_group("cc"))
        if not rank:
            store.close()


def spawned_all_reduce(out_dir):
    """A ``distributed.spawn`` worker: joins the job from the environment
    the spawner set (gloo), all-reduces its rank + 1 and writes what it
    saw to ``out_dir``."""
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.init_parallel_env(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
        f.write(f"{world} {t.item()} {os.environ['PADDLE_TRAINER_ID']} "
                f"{os.environ['PADDLE_CURRENT_ENDPOINT']}")
    parallel_env.destroy_process_group()


# ------------------------------------- elastic resilience
# (tests/test_torch_resilience_ranks.py). A task that changes the world
# leaves every rank, the "lost" one included, in a world of all four again
# (``_whole_world``), so the next task starts from the same world.

_JOB_STORE = []


def _job_store():
    """The job's TCPStore (rank 0 serves it; its port goes round over the
    current world once) and the rendezvous store of every world formed
    after."""
    from paddle_tpu_torch.distributed import parallel_env
    from paddle_tpu_torch.distributed.store import TCPStore
    if not _JOB_STORE:
        rank = dist.get_rank()
        store = TCPStore("127.0.0.1", 0, is_master=rank == 0,
                         world_size=dist.get_world_size(), timeout=60) \
            if rank == 0 else None
        port = [store.port if store is not None else None]
        dist.broadcast_object_list(port, src=0)
        if store is None:
            store = TCPStore("127.0.0.1", port[0], world_size=4, timeout=60)
        _JOB_STORE.append(store)
        parallel_env.rendezvous_store(store)
    return _JOB_STORE[0]


def _whole_world(epoch):
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.rebuild_world(range(4), epoch, pid=_my_id())


def _my_id():
    from paddle_tpu_torch.distributed import parallel_env
    return parallel_env.process_id()


def _sharded_param(pt, mesh, x, spec):
    """A parameter holding ``x`` sharded by ``spec``, in an Adam whose
    moments are set to 2 x and 3 x (cut the same way)."""
    from paddle_tpu_torch.distributed import api
    p = pt.create_parameter(list(x.shape), "float32")
    p.set_value(pt.to_tensor(x))
    api.shard_tensor(p, mesh, _placements(spec))
    opt = pt.optimizer.Adam(1e-3, parameters=[p])
    opt._states[id(p)] = {"m": p._t.detach() * 2, "v": p._t.detach() * 3}
    return p, opt


def _words(placements):
    return " ".join(("S%d" % p.get_dim()) if p.is_shard() else
                    "P" if p.is_partial() else "R" for p in placements)


def _leaves(p, opt):
    st = opt._states[id(p)]
    return _np(p._t), _np(st["m"]), _np(st["v"])


def elastic_shrink(shape, names, x, spec, lost, epoch):
    """Every survivor runs ``shrink_world`` of ``x`` (sharded by ``spec``
    on the mesh of ``shape``) after losing ``lost``; the lost ranks do
    nothing. Each survivor returns its id, its new piece and moments, the
    new mesh and placements (or the error); then all four form one world
    again."""
    pt = _cpu()
    from paddle_tpu_torch.base.core import EnforceNotMet
    from paddle_tpu_torch.distributed.resilience import shrink_world
    store = _job_store()
    mesh = _dmesh(shape, names)
    mesh.groups()
    p, opt = _sharded_param(pt, mesh, x, spec)
    me = _my_id()
    out = None
    if me not in lost:
        try:
            new = shrink_world(mesh, lost, {"w": p}, optimizer=opt,
                               set_global=False, world_epoch=epoch,
                               store=store)
            out = (me, *_leaves(p, opt), new.shape, new.dim_names,
                   [int(i) for i in new.process_ids],
                   _words(p._dist_attr.placements), dist.get_rank(),
                   dist.get_world_size())
        except EnforceNotMet as e:
            out = (me, "EnforceNotMet", str(e), tuple(p._t.shape))
    _whole_world(epoch + 1)
    return out


def elastic_grow(shape, names, x, spec, joined, epoch):
    """The ranks of the mesh of ``shape`` run ``grow_world`` with
    ``joined``; each joiner forms the grown world and cuts its piece of
    ``x`` by its own layout on the grown mesh (what a received broadcast
    gives it). Every rank returns its id, piece and moments, the mesh and
    the placements."""
    pt = _cpu()
    from paddle_tpu_torch.distributed import api, parallel_env
    from paddle_tpu_torch.distributed.resilience import grow_world, plan_grow
    store = _job_store()
    mesh = _dmesh(shape, names)
    mesh.groups()
    me = _my_id()
    if me in mesh.process_ids:
        p, opt = _sharded_param(pt, mesh, x, spec)
        new = grow_world(mesh, joined, {"w": p}, optimizer=opt,
                         set_global=False, world_epoch=epoch, store=store)
        out = (me, *_leaves(p, opt), new.shape, new.dim_names,
               _words(p._dist_attr.placements))
    else:
        parallel_env.rebuild_world(range(4), epoch, store=store)
        new = plan_grow(mesh, joined)
        from paddle_tpu_torch.distributed.resilience.elastic import \
            _shrunk_placements
        attr = api.DistAttr(new, _shrunk_placements(
            _placements(spec), mesh, new, x.shape), x.shape)
        piece = api.local_piece(torch.from_numpy(x), attr)
        out = (me, _np(piece), _np(piece * 2), _np(piece * 3), new.shape,
               new.dim_names, _words(attr.placements))
    _whole_world(epoch + 1)
    return out


def elastic_fallback(shape, names, x, spec, lost, epoch, root):
    """An ``AdaptiveTrainer`` over a parameter sharded by ``spec`` saves a
    checkpoint, then every survivor takes a manager epoch that loses
    ``lost``: where the move cannot be made, the trainer adopts the
    planned layout and reloads the checkpoint. Each survivor returns its
    id, piece and moments, the trainer's mesh and placements, and the
    ``resilience.ckpt_restores`` it counted."""
    pt = _cpu()
    from paddle_tpu_torch.distributed.resilience import (AdaptiveTrainer,
                                                         MembershipEvent)
    from paddle_tpu_torch.observability import metrics
    _job_store()
    mesh = _dmesh(shape, names)
    mesh.groups()
    p, opt = _sharded_param(pt, mesh, x, spec)
    trainer = AdaptiveTrainer(optimizer=opt, mesh=mesh, checkpoint_dir=root)
    trainer.save_checkpoint()
    me = _my_id()
    out = None
    if me not in lost:
        before = metrics.counter("resilience.ckpt_restores").value
        members = [str(i) for i in mesh.process_ids if i not in lost]
        trainer._membership_event(MembershipEvent(
            epoch, members, lost=list(lost), source="manager"))
        out = (me, *_leaves(p, opt), trainer.mesh.shape,
               trainer.mesh.dim_names, _words(p._dist_attr.placements),
               metrics.counter("resilience.ckpt_restores").value - before)
    trainer.shutdown()
    _whole_world(epoch + 1)
    return out


# ------------------------------------------------ cross-rank telemetry

def _telemetry_store():
    """A TCPStore hosted by rank 0 on a free port, its port broadcast over
    the world."""
    from paddle_tpu_torch.distributed.store import TCPStore
    rank, n = dist.get_rank(), dist.get_world_size()
    store = TCPStore("127.0.0.1", 0, is_master=rank == 0, world_size=n,
                     timeout=30) if rank == 0 else None
    port = [store.port if store is not None else None]
    dist.broadcast_object_list(port, src=0)
    if store is None:
        store = TCPStore("127.0.0.1", port[0], world_size=n, timeout=30)
    return store


def telemetry_publish(steps):
    """Every rank publishes a frame a step (a compute chain and a gloo
    all-reduce under ElasticStep, the telemetry plane on); rank 0 polls
    the store. Rank 0 returns the step table, the overlap report, the raw
    frame blobs it read and the port's decode of each; the others None."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.communication import all_reduce
    from paddle_tpu_torch.distributed.resilience import ElasticStep
    from paddle_tpu_torch.observability import distributed as dtel
    pt.set_device("cpu")
    rank, n = dist.get_rank(), dist.get_world_size()
    store = _telemetry_store()
    pt.set_flags({"FLAGS_distributed_telemetry": True})
    try:
        pub = dtel.init(store, rank=rank, world_size=n)
        x = pt.to_tensor(np.ones((16, 16), "float32"))
        grad = pt.to_tensor(np.ones((64, 64), "float32"))
        w = pt.create_parameter([4, 4], "float32")
        elastic = ElasticStep(optimizer=pt.optimizer.SGD(0.0,
                                                         parameters=[w]))

        def step():
            with pt.framework.lazy_guard():
                y = x
                for _ in range(4):
                    y = y * 1.001 + 0.1
            y.numpy()
            all_reduce(grad)

        for _ in range(steps):
            elastic.run(step)
        pub.flush()
        dist.barrier()
        out = None
        if rank == 0:
            agg = dtel.TelemetryAggregator()
            agg.poll_store(store, list(range(n)))
            blobs = [store.try_get(f"__telem/frame/{r}/1", timeout=1.0)
                     for r in range(n)]
            out = {"table": agg.step_table(),
                   "overlap": agg.overlap_report(),
                   "blobs": blobs,
                   "decoded": [dtel.decode_frame(b) for b in blobs]}
        dist.barrier()
        elastic.shutdown()
        return out
    finally:
        pt.set_flags({"FLAGS_distributed_telemetry": False})
        dtel.shutdown()
        dist.barrier()
        store.close()


def telemetry_postmortem(tmp):
    """Rank 1 publishes its flight ring as a postmortem; rank 0 aggregates
    over ranks [0, 1, 2] (rank 2 never existed) into ``tmp``, then once
    more with no new publication (the first pass consumed the keys).
    Rank 0 returns both reports' bodies."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import distributed as dtel
    from paddle_tpu_torch.observability import flight
    rank, n = dist.get_rank(), dist.get_world_size()
    store = _telemetry_store()
    pt.set_flags({"FLAGS_distributed_telemetry": True,
                  "FLAGS_flight_recorder": True})
    try:
        flight.reset()
        flight.note("span", f"rank{rank}::work", dur_us=5.0)
        pub = dtel.init(store, rank=rank, world_size=n)
        if rank == 1:
            pub.publish_postmortem("drill: rank 2 lost")
        dist.barrier()
        out = None
        if rank == 0:
            pub.publish_postmortem("drill: rank 2 lost")
            agg = dtel.TelemetryAggregator()
            p1 = os.path.join(tmp, "post1.txt")
            agg.aggregate_postmortem(store, [0, 1, 2], reason="one",
                                     grace_s=0.3, path=p1)
            p2 = os.path.join(tmp, "post2.txt")
            got = dtel.TelemetryAggregator().aggregate_postmortem(
                store, [1], reason="two", grace_s=0.2, path=p2)
            out = {"first": open(p1).read(), "second": got}
        dist.barrier()
        return out
    finally:
        pt.set_flags({"FLAGS_distributed_telemetry": False,
                      "FLAGS_flight_recorder": False})
        flight.reset()
        dtel.shutdown()
        dist.barrier()
        store.close()
