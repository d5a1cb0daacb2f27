"""Search, sort, gather and scatter: the counterpart of
``paddle_tpu/ops/search.py``.

Where torch's ops promise less than the reference's, the bodies say more:

- sorting is stable whatever ``stable`` says, and a descending sort is
  the reference's ascending sort of ``-x``: equal values keep their index
  order, NaN comes last both ways (``torch.sort(descending=True)`` would
  put it first); an unsigned input wraps under ``-x`` as in the reference,
  and a descending sort of bool raises, as the reference's ``-x`` does;
- ``topk`` is ``lax.top_k``'s: ties go to the lower index (a stable sort
  of ``x``, or of ``-x`` for ``largest=False``, cut at ``k``);
- ``scatter(overwrite=True)``, ``put_along_axis(reduce='assign')`` and
  ``index_put(accumulate=False)`` with duplicate indices give every
  target the last of its updates, on the card as on the CPU (torch's
  ``index_put_``/``scatter_`` leave the winner to the hardware): the
  winner is the largest update position, found with an ``amax`` scatter;
- adding scatters (``overwrite=False``, ``scatter_nd_add``, ``index_add``)
  sum duplicates with atomics on the card: equal to the CPU's sums up to
  their rounding order.

Index outputs are int64, as the reference's under x64. The ops whose
output shape depends on the data (``nonzero``, ``masked_select``,
``unique``, ``unique_consecutive``, ``where`` with one argument) read
that shape on the host; nothing else here does.
"""
from __future__ import annotations

import torch

from .._core import dtype as dtypes
from .._core import random as rnd
from .._core.dispatch import apply, meta, unwrap
from .._core.op_registry import register_op
from .._core.tensor import Tensor
from ._helper import argsort_nan_last, promoted, tensor_method
from .manipulation import flatten, moveaxis


def _ndim(x):
    return meta(x).dim()


# ------------------------------------------------------ argmax / argmin
@register_op("argmax_")
def _argmax(x, axis, keepdim, dtype):
    out = torch.argmax(x.reshape(-1) if axis is None else x,
                       None if axis is None else axis, keepdim=keepdim
                       and axis is not None)
    if keepdim and axis is None:
        out = out.reshape((1,) * x.dim())
    return out.to(dtypes.to_torch(dtype))


@register_op("argmin_")
def _argmin(x, axis, keepdim, dtype):
    out = torch.argmin(x.reshape(-1) if axis is None else x,
                       None if axis is None else axis, keepdim=keepdim
                       and axis is not None)
    if keepdim and axis is None:
        out = out.reshape((1,) * x.dim())
    return out.to(dtypes.to_torch(dtype))


@tensor_method("argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply("argmax_", _argmax, x, axis=None if axis is None
                 else int(axis), keepdim=bool(keepdim),
                 dtype=dtypes.to_dtype(dtype).name)


@tensor_method("argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply("argmin_", _argmin, x, axis=None if axis is None
                 else int(axis), keepdim=bool(keepdim),
                 dtype=dtypes.to_dtype(dtype).name)


# ------------------------------------------------------ gather family
@register_op("take_along_axis_")
def _take_along_axis(x, idx, axis):
    return torch.take_along_dim(x, idx, axis)


@tensor_method("take_along_axis")
def take_along_axis(x, indices, axis, broadcast=True, name=None):
    return apply("take_along_axis_", _take_along_axis, x, indices,
                 axis=int(axis))


def _last_writer(n_targets, target, device):
    """Per target of ``target`` (int64, one per update, in update order):
    the position of its last update, -1 where none."""
    order = torch.arange(target.numel(), device=device)
    return torch.full((n_targets,), -1, dtype=torch.int64,
                      device=device).scatter_reduce(
        0, target.reshape(-1), order, "amax")


def _assign_rows(xr, target, vr):
    """``xr`` [T, ...] with row ``target[i]`` set to ``vr[i]``, the last
    update winning."""
    win = _last_writer(xr.shape[0], target, xr.device)
    take = vr[win.clamp(min=0)]
    keep = (win >= 0).reshape((-1,) + (1,) * (xr.dim() - 1))
    return torch.where(keep, take.to(xr.dtype), xr)


@register_op("put_along_axis_")
def _put_along_axis(x, idx, v, axis, reduce):
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, dtype=x.dtype, device=x.device)
    v = torch.broadcast_to(v.to(x.dtype), idx.shape)
    if reduce == "assign":
        axis %= x.dim()
        # the flat position in x of each update
        grids = torch.meshgrid(*[torch.arange(s, device=x.device)
                                 for s in idx.shape], indexing="ij")
        pos = list(grids)
        pos[axis] = idx
        x = x.contiguous()
        lin = sum(p * int(st) for p, st in zip(pos, x.stride()))
        out = _assign_rows(x.reshape(-1), lin, v.reshape(-1))
        return out.reshape(x.shape)
    if reduce == "add":
        return x.scatter_add(axis, idx, v)
    if reduce in ("multiply", "mul"):
        return x.scatter_reduce(axis, idx, v, "prod")
    raise ValueError(f"unsupported reduce: {reduce}")


@tensor_method("put_along_axis")
def put_along_axis(x, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    return apply("put_along_axis_", _put_along_axis, x, indices, values,
                 axis=int(axis), reduce=reduce)


@register_op("gather_")
def _gather(x, idx, axis):
    """``jnp.take``; a bf16/fp16 source is gathered in float32 (the same
    values), so the gradient's duplicate indices sum in float32 and round
    once, on the card's atomics as on the CPU."""
    axis %= x.dim()
    low = x.dtype in (torch.bfloat16, torch.float16)
    out = torch.index_select(x.float() if low else x, axis, idx.reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    return out.to(x.dtype) if low else out


@tensor_method("gather")
def gather(x, index, axis=0, name=None):
    if _ndim(index) == 2 and meta(index).shape[1] == 1:
        index = flatten(index)
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply("gather_", _gather, x, index, axis=int(axis))


@register_op("gather_nd_")
def _gather_nd(x, index):
    return x[tuple(torch.movedim(index, -1, 0))]


@tensor_method("gather_nd")
def gather_nd(x, index, name=None):
    return apply("gather_nd_", _gather_nd, x, index)


@register_op("scatter_")
def _scatter(x, index, updates, overwrite):
    if index.dim() == 2 and index.shape[-1] == 1:
        index = index[:, 0]
    updates = updates.to(x.dtype)
    if overwrite:
        return _assign_rows(x, index, updates)
    zeroed = x.index_fill(0, index, 0)
    return zeroed.index_add(0, index, updates)


@tensor_method("scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    return apply("scatter_", _scatter, x, index, updates,
                 overwrite=bool(overwrite))


@register_op("scatter_nd_add_")
def _scatter_nd_add(x, index, updates):
    return x.index_put(tuple(torch.movedim(index, -1, 0)),
                       updates.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return apply("scatter_nd_add_", _scatter_nd_add, x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    t = unwrap(updates)
    zero = Tensor(torch.zeros(tuple(int(s) for s in shape), dtype=t.dtype,
                              device=t.device))
    return scatter_nd_add(zero, index, updates)


@register_op("index_select_")
def _index_select(x, idx, axis):
    return _gather(x, idx, axis)


@tensor_method("index_select")
def index_select(x, index, axis=0, name=None):
    return apply("index_select_", _index_select, x, index, axis=int(axis))


@register_op("index_sample_")
def _index_sample(x, index):
    return torch.take_along_dim(x, index, 1)


def index_sample(x, index):
    return apply("index_sample_", _index_sample, x, index)


@register_op("index_add_")
def _index_add(x, index, value, axis):
    return torch.index_add(x, axis, index, value.to(x.dtype))


@tensor_method("index_add")
def index_add(x, index, axis, value, name=None):
    return apply("index_add_", _index_add, x, index, value, axis=int(axis))


@register_op("index_put_")
def _index_put(x, v, *idx, accumulate):
    if not isinstance(v, torch.Tensor):
        v = torch.full((), v, dtype=x.dtype, device=x.device)
    v = v.to(x.dtype)
    if accumulate:
        return x.index_put(idx, v, accumulate=True)
    k = len(idx)
    idx = torch.broadcast_tensors(*idx)
    lin = torch.zeros_like(idx[0], dtype=torch.int64)
    for i, t in enumerate(idx):
        lin = lin * x.shape[i] + t.to(torch.int64) % x.shape[i]
    rows = x.reshape((-1,) + x.shape[k:])
    vr = torch.broadcast_to(v, idx[0].shape + x.shape[k:]).reshape(
        (-1,) + x.shape[k:])
    return _assign_rows(rows, lin, vr).reshape(x.shape)


@tensor_method("index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    return apply("index_put_", _index_put, x, value, *list(indices),
                 accumulate=bool(accumulate))


# ------------------------------------------------------ topk / sort
@register_op("arg_topk_")
def _arg_topk(x, k, axis, largest):
    v = torch.movedim(x if largest else -x, axis, -1)
    order = torch.sort(v, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


@tensor_method("topk")
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    if isinstance(k, Tensor):
        k = int(k.item())
    axis = int(axis) % _ndim(x)
    idx = apply("arg_topk_", _arg_topk, x, k=int(k), axis=axis,
                largest=bool(largest))
    if axis != _ndim(x) - 1:
        idx = moveaxis(idx, -1, axis)
    return take_along_axis(x, idx, axis), idx


@register_op("argsort_")
def _argsort(x, axis, descending):
    return argsort_nan_last(-x if descending else x, axis)


@tensor_method("argsort")
def argsort(x, axis=-1, descending=False, stable=True, name=None):
    return apply("argsort_", _argsort, x, axis=int(axis),
                 descending=bool(descending))


@tensor_method("sort")
def sort(x, axis=-1, descending=False, stable=True, name=None):
    return take_along_axis(x, argsort(x, axis=axis, descending=descending),
                           axis)


@register_op("kthvalue_k", multi_output=True)
def _kthvalue(x, k, axis, keepdim):
    idx = argsort_nan_last(x, axis).narrow(axis, k - 1, 1)
    val = torch.take_along_dim(x, idx, axis)
    return (val, idx) if keepdim else (val.squeeze(axis), idx.squeeze(axis))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return tuple(apply("kthvalue_k", _kthvalue, x, k=int(k),
                       axis=int(axis) % _ndim(x), keepdim=bool(keepdim)))


@register_op("mode_k", multi_output=True)
def _mode(x):
    """Most frequent value along the last axis: ties to the smallest
    value, the index of its last occurrence (the reference's run-length
    formulation, vectorised: a run's length at each position is the
    position less the run's start, from a running max of run starts)."""
    n = x.shape[-1]
    s = torch.sort(x, -1).values
    pos = torch.arange(n, device=x.device).expand(s.shape)
    new = torch.ones_like(s, dtype=torch.bool)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    start = torch.cummax(torch.where(new, pos, 0), -1).values
    best = torch.argmax(pos - start, -1, keepdim=True)  # first longest run
    values = torch.take_along_dim(s, best, -1)
    idx = torch.argmax(torch.where(x == values, pos, -1), -1)
    return values[..., 0], idx


def mode(x, axis=-1, keepdim=False, name=None):
    from .manipulation import transpose, unsqueeze
    nd = _ndim(x)
    axis %= nd
    perm = [i for i in range(nd) if i != axis] + [axis]
    xt = transpose(x, perm) if axis != nd - 1 else x
    values, idx = apply("mode_k", _mode, xt)
    if keepdim:
        values, idx = unsqueeze(values, axis), unsqueeze(idx, axis)
    return values, idx


@register_op("searchsorted_")
def _searchsorted(a, v, right):
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=right)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    out = apply("searchsorted_", _searchsorted, sorted_sequence, values,
                right=bool(right))
    return out.astype("int32") if out_int32 else out


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


# ------------------------------------------------------ where / dynamic ops
@register_op("where_")
def _where(c, x, y):
    if isinstance(x, torch.Tensor):
        x, y = promoted(x, y, scalars=False)
    else:
        y, x = promoted(y, x, scalars=False)
    return torch.where(c.bool(), x, y)


@tensor_method("where")
def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return apply("where_", _where, condition, x, y)


def nonzero(x, as_tuple=False):
    """Data-dependent shape: torch reads the count on the host."""
    idx = apply("nonzero", lambda t: torch.nonzero(t), x)
    if as_tuple:
        return tuple(idx[:, i:i + 1] for i in range(_ndim(x)))
    return idx


@tensor_method("masked_select")
def masked_select(x, mask, name=None):
    """Data-dependent shape: torch reads the count on the host; the
    gather stays on the device and gradients flow through it."""
    return apply("masked_select", lambda t, m: torch.masked_select(t, m),
                 x, mask)


def _first_index(inverse, n_unique):
    """Per unique value, the first position holding it."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    return torch.full((n_unique,), inverse.numel(), dtype=torch.int64,
                      device=inverse.device).scatter_reduce(
        0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``'s outputs (sorted values, first indices, inverse,
    counts); data-dependent shape: torch reads the count on the host."""
    t = unwrap(x).detach()
    vals, inv, counts = torch.unique(t, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        outs.append(_first_index(inv, vals.shape[0] if axis is not None
                                 else vals.numel()))
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(counts)
    outs = [Tensor(o) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    t = unwrap(x).detach()
    vals, inv, counts = torch.unique_consecutive(
        t, return_inverse=True, return_counts=True,
        dim=None if axis is None else 0)
    outs = [vals] + ([inv.reshape(-1)] if return_inverse else []) + \
        ([counts] if return_counts else [])
    outs = [Tensor(o) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


@register_op("top_p_sampling", multi_output=True)
def _top_p(x, ps, seed):
    """Nucleus sampling: per row, the smallest set of the most probable
    ids whose mass reaches ``ps`` (always one), renormalised, one id
    drawn. ``seed`` < 0 draws from the device's generator."""
    sorted_p, sorted_idx = torch.sort(x, dim=-1, descending=True,
                                      stable=True)
    cum = torch.cumsum(sorted_p, -1)
    keep = (cum - sorted_p) < ps.unsqueeze(-1)
    filt = torch.where(keep, sorted_p, 0.0)
    filt = filt / filt.sum(-1, keepdim=True)
    gen = rnd.generator(x.device) if seed < 0 else \
        torch.Generator(device=x.device).manual_seed(seed)
    flat = filt.reshape(-1, filt.shape[-1]).detach().float()
    choice = torch.multinomial(flat, 1, generator=gen).reshape(
        filt.shape[:-1] + (1,))
    ids = torch.take_along_dim(sorted_idx, choice, -1)
    probs = torch.take_along_dim(filt, choice, -1)
    return probs, ids


def top_p_sampling(x, ps, threshold=None, seed=None, name=None, **kw):
    """``x`` [B, V] probabilities, ``ps`` [B] the nucleus mass per row:
    (sampled probabilities, sampled ids), each [B, 1]."""
    return apply("top_p_sampling", _top_p, x, ps,
                 seed=-1 if seed is None or seed < 0 else int(seed))
