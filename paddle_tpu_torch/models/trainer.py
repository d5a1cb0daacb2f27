"""AdamW trainer: forward, backward and the update, on one device or on a
mesh of ranks.

Counterpart of ``paddle_tpu/models/trainer.py``. The state is the
reference's ``{"params", "master", "m", "v", "step"}``: params in their own
type (bf16 on the training path), an fp32 master copy, fp32 moments and an
int32 step count. The update is the reference's, written out in plain
torch rather than ``torch.optim.AdamW`` (whose decay sits outside the
learning-rate product and would round differently):

    m    = b1 m + (1 - b1) g
    v    = b2 v + (1 - b2) g²
    t    = step + 1
    W    = W - lr (m / (1 - b1ᵗ) / (sqrt(v / (1 - b2ᵗ)) + eps) + wd W)
    p    = W cast to p's type

Where the reference donates the state to the compiled step, this trainer
updates the state's tensors in place.

With a mesh (``distributed.ProcessMesh`` over the default process group;
every rank calls the same functions in the same order) each rank holds
its shard of every leaf, by the leaf's ``PartitionSpec`` (``specs``), and
of its optimizer state, by :func:`zero1_opt_specs` (ZeRO-1: master, m and
v split once more over ``dp`` on the first dim that nothing splits and
``dp`` divides). The step takes the global batch, the same on every rank,
and keeps its ``batch_specs`` block (``P("dp", None)``: its rows). The
loss function returns this rank's share of the global loss (of a mean over
the dp ranks' equal row counts, the mean over its rows over dp), computed
shard-local with the model's own collectives. Each gradient is then summed
over the leaf's ``grad_sum`` axes (the mesh trainers' sequence-parallel
leaves), and over ``dp``: a reduce-scatter along the ZeRO-1 dim where the
leaf has one, an all-reduce where it has none. The update runs on the
shard, and the new params, cast to their type, are all-gathered along the
ZeRO-1 dim. The step returns the sum of the shares over dp: the global
loss, the same on every rank.
"""
from __future__ import annotations

from itertools import repeat
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from .._core.device import DeviceLike, resolve_device


def tree_leaves(tree) -> List[Any]:
    """Leaves of a nested dict in sorted-key order (``jax.tree_util``'s
    order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts; anything else is a
    leaf) and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def filter_specs_for_mesh(specs, mesh):
    """Drop references to axes the mesh doesn't have."""
    from ..distributed.mesh import PartitionSpec as P
    if mesh is None:
        return specs
    names = mesh.dim_names
    return tree_map(lambda sp: P(*(e if e in names else None for e in sp)),
                    specs)


def zero1_opt_specs(specs, param_shapes, mesh, axis: str = "dp"):
    """ZeRO-1: shard optimizer state over the dp axis on the first
    unsharded, divisible dim (each dp rank keeps 1/dp of master, m and
    v; the updated params are all-gathered)."""
    from ..distributed.mesh import PartitionSpec as P
    if mesh is None or axis not in mesh.dim_names:
        return specs
    size = mesh.get_dim_size(axis)

    def _one(sp, shape):
        entries = list(sp) + [None] * (len(shape) - len(sp))
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % size == 0 and dim >= size:
                entries[i] = axis
                return P(*entries)
        return sp

    return tree_map(lambda sp, sh: _one(sp, tuple(sh)), specs, param_shapes)


def fit_specs(specs, param_shapes, mesh):
    """Each split whose dim the axis does not divide made a replication:
    the reference's GSPMD pads such a dim, the shard-local code does not
    split it."""
    from ..distributed.mesh import PartitionSpec as P
    if mesh is None:
        return specs

    def _one(sp, shape):
        return P(*(e if e is None or shape[i] % mesh.get_dim_size(e) == 0
                   else None for i, e in enumerate(sp)))

    return tree_map(lambda sp, sh: _one(sp, tuple(sh)), specs, param_shapes)


def state_specs(specs, param_shapes, mesh, zero1: bool = True):
    """The specs a mesh trainer shards by: the params' (the model's specs
    on the mesh's axes, :func:`fit_specs`) and the optimizer state's
    (ZeRO-1 on top when ``zero1``)."""
    p_specs = fit_specs(filter_specs_for_mesh(specs, mesh), param_shapes,
                        mesh)
    o_specs = zero1_opt_specs(p_specs, param_shapes, mesh) if zero1 \
        else p_specs
    return p_specs, o_specs


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name``; 1 without a mesh or the
    axis."""
    return 1 if mesh is None else mesh.axis_size(name)


def share_of_mean(loss, mesh):
    """This rank's share of a mean over the dp ranks' equal row counts:
    the step sums the shares over dp."""
    dp = axis_size(mesh, "dp")
    return loss / dp if dp > 1 else loss


def check_mp(mesh, dims) -> None:
    """Raises where mp does not divide one of ``dims``, the ``(name,
    size)`` pairs that the model's shard-local layout splits over mp."""
    mp = axis_size(mesh, "mp")
    for what, n in dims:
        if n % mp:
            raise ValueError(f"{what} {n} not divisible by mp {mp}: the "
                             f"shard-local layout splits it over mp")


def adamw_update(p, w, g, m, v, bc1, bc2, lr, wd, b1, b2, eps, use_wd,
                 cast: bool = True) -> None:
    """One AdamW update of master ``w`` and moments ``m``, ``v`` in place
    from gradient ``g``; ``p`` takes ``w`` in its own type when
    ``cast``."""
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if use_wd:
        upd.add_(wd * w)
    w.sub_(lr * upd)
    if cast:
        p.copy_(w)


def _zero_dim(param_spec, opt_spec) -> Optional[int]:
    """The dim ZeRO-1 split over dp (the one where the specs differ)."""
    for i, e in enumerate(opt_spec):
        if e == "dp" and (i >= len(param_spec) or param_spec[i] != "dp"):
            return i
    return None


def build_adamw_train_step(
        loss_fn: Callable,         # (params, *batch) -> scalar loss
        init_params_fn: Callable,  # (seed) -> params tree
        wd_mask,                   # bool tree matching params
        lr: float = 3e-4, wd: float = 0.1, b1: float = 0.9,
        b2: float = 0.95, eps: float = 1e-8, device: DeviceLike = None,
        specs=None,                # PartitionSpec tree (with a mesh)
        mesh=None,                 # distributed.ProcessMesh, or None
        zero1: bool = True,
        batch_specs=None,          # specs of the batch args (default dp)
        split_groups=None,         # {path: groups} (convert.shard_for_rank)
        grad_sum=None):            # tree of axis tuples the grads sum over
    """Returns ``(init_fn, step_fn)``; ``step_fn(state, *batch)`` returns
    ``(state, loss)``, with ``state`` updated in place.
    ``init_fn(seed=0, params=None)`` starts from ``params`` (a whole tree
    of numpy arrays or tensors) when given, else from
    ``init_params_fn(seed)``; with a mesh, the state holds this rank's
    shards. Without one the plan is empty: whole leaves, no collective,
    the whole batch."""
    from ..distributed import _collectives as C
    from ..distributed.mesh import PartitionSpec as P
    from .convert import shard_for_rank

    dev = resolve_device(device)
    hyper = dict(lr=lr, wd=wd, b1=b1, b2=b2, eps=eps)
    names = () if mesh is None else mesh.dim_names
    groups = {} if mesh is None else mesh.groups()  # every rank at once
    dp_group = groups.get("dp")
    # per leaf: the ZeRO-1 dim and the axes its gradient sums over (none
    # without a mesh, so a state made elsewhere steps as it is)
    plan = {} if mesh is not None else {"zero": repeat(None),
                                        "sums": repeat(())}

    def _plan(params):
        shapes = tree_map(lambda p: tuple(p.shape), params)
        p_specs, o_specs = state_specs(specs, shapes, mesh, zero1)
        plan.update(specs=p_specs, opt_specs=o_specs,
                    zero=[_zero_dim(a, b) for a, b in zip(
                        tree_leaves(p_specs), tree_leaves(o_specs))],
                    sums=[tuple(s or ()) for s in tree_leaves(
                        grad_sum if grad_sum is not None
                        else tree_map(lambda _: None, shapes))])

    def init_fn(seed: int = 0, params=None) -> Dict[str, Any]:
        whole = _whole(init_params_fn, seed, params, dev)
        master = tree_map(lambda p: p.detach().float(), whole)
        if mesh is None:
            return _state(whole, tree_map(torch.clone, master), dev)
        _plan(whole)
        local = shard_for_rank(whole, plan["specs"], mesh, None,
                               split_groups)
        master = shard_for_rank(master, plan["opt_specs"], mesh, None,
                                split_groups)
        return _state(local, master, dev)

    def _local_batch(args):
        out = []
        specs = batch_specs or [P("dp" if "dp" in names else None, None)] \
            * len(args)
        for a, sp in zip(args, specs):
            for dim, axis in enumerate(sp):
                if axis is not None and axis in names:
                    a = C.chunk(a, dim, groups[axis])
            out.append(a)
        return out

    def step_fn(state, *batch):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        leaves = tree_leaves(params)
        # profiler ranges: a traced step splits its device time by phase
        # (the backward needs none: autograd launches its kernels from its
        # own thread, outside any range of this one)
        with record_function("forward"):
            loss = loss_fn(params, *_local_batch(batch))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad(), record_function("optimizer"):
            bc1, bc2 = _bias_corrections(state, hyper)
            for p, w, g, m, v, use_wd, zdim, sums in zip(
                    tree_leaves(state["params"]),
                    tree_leaves(state["master"]), grads,
                    tree_leaves(state["m"]), tree_leaves(state["v"]),
                    tree_leaves(wd_mask), plan["zero"], plan["sums"]):
                for axis in sums:
                    g = C.all_reduce(g, groups[axis])
                if zdim is not None:
                    g = C.reduce_scatter(g, zdim, dp_group)
                elif dp_group is not None:
                    g = C.all_reduce(g, dp_group)
                adamw_update(p, w, g, m, v, bc1, bc2, use_wd=use_wd,
                             cast=zdim is None, **hyper)
                if zdim is not None:
                    p.copy_(C.all_gather(w.to(p.dtype), zdim, dp_group))
            loss = loss.detach()
            if dp_group is not None:
                loss = C.all_reduce(loss, dp_group)
        return state, loss

    return init_fn, step_fn


def _whole(init_params_fn, seed, params, dev):
    if params is None:
        return init_params_fn(seed)
    from .convert import tensor_from_numpy
    return tree_map(lambda a: a.detach().to(dev).clone()
                    if isinstance(a, torch.Tensor)
                    else tensor_from_numpy(a, dev), params)


def _state(params, master, dev) -> Dict[str, Any]:
    return {"params": params, "master": master,
            "m": tree_map(torch.zeros_like, master),
            "v": tree_map(torch.zeros_like, master),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _bias_corrections(state, hyper):
    """Counts the step; Adam's ``1 - b1^t`` and ``1 - b2^t``."""
    state["step"] += 1
    t = state["step"].float()
    return 1 - hyper["b1"] ** t, 1 - hyper["b2"] ** t
