"""Rank functions of the port's multi-rank CPU tests.

Each runs on every rank of a world from ``paddle_tpu_torch.testing.dist``
(spawned processes joined over gloo) and returns numpy values for the test
to gather. The workers import this module to unpickle the functions, so it
imports neither ``jax`` nor the JAX package. A function whose mesh is
smaller than the world returns None on the ranks outside it.
"""
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
