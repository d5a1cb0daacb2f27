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
