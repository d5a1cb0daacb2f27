"""The semi-auto parallel API: ``shard_tensor``, ``reshard``,
``dtensor_from_local`` / ``dtensor_to_local``, ``unshard_dtensor``,
``shard_layer`` and ``DistAttr``, the counterpart of
``paddle_tpu/distributed/api.py`` (upstream ``auto_parallel/api.py``).

A DistTensor is a ``Tensor`` with a ``_dist_attr``: its mesh, its
placements (one per mesh axis) and its global shape. The reference's
payload is the global array, laid out over the devices of one process; in
the port each rank is a process and a DistTensor holds this rank's piece:
its block for ``Shard``, the whole value for ``Replicate``, its own
contribution for ``Partial``. So ``shape``, ``numpy()`` and every op of a
DistTensor see the piece (an op's result is a plain tensor), and no
collective runs behind them; the global value is what ``unshard_dtensor``
returns, a collective that every rank of the mesh calls. A rank outside
the mesh holds an empty piece.

``shard_tensor``, ``reshard`` and ``unshard_dtensor`` run on every rank of
the world at the same point (a mesh makes its process groups on first
use). ``shard_tensor`` takes the global value (the same on every rank) and
cuts this rank's piece; a parameter is sharded in place, so layers keep
their identity. A move that changes only the layout keeps the autograd
edge (``auto_parallel/reshard_functions.py``); a move to or from
``Partial`` does not, as in the reference. ``dtensor_from_local`` and
``dtensor_to_local`` keep the edge: the piece is the same data.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .._core.tensor import Tensor, to_tensor
from ..nn.layer import Layer, Parameter
from .auto_parallel.reshard_functions import in_mesh, reshard_value
from .mesh import PartitionSpec, ProcessMesh
from .placements import Placement, Replicate, Shard


class DistAttr:
    """(mesh, placements) pair hung on ``Tensor._dist_attr``
    (TensorDistAttr analog, dist_attr.h), with the global shape."""

    __slots__ = ("process_mesh", "placements", "global_shape")

    def __init__(self, process_mesh: ProcessMesh,
                 placements: Sequence[Placement],
                 global_shape: Optional[Sequence[int]] = None):
        self.process_mesh = process_mesh
        self.placements = list(placements)
        self.global_shape = None if global_shape is None \
            else [int(d) for d in global_shape]

    def __repr__(self):
        return (f"DistAttr(mesh={self.process_mesh}, "
                f"placements={self.placements}, "
                f"global_shape={self.global_shape})")


def placements_to_spec(placements: Sequence[Placement], mesh: ProcessMesh,
                       ndim: int) -> PartitionSpec:
    """placements are per-MESH-dim (paddle convention): placements[i]
    describes how mesh axis i is used."""
    entries: List = [None] * ndim
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim
            axis_name = mesh.dim_names[mesh_dim]
            if entries[d] is None:
                entries[d] = axis_name
            elif isinstance(entries[d], tuple):
                entries[d] = entries[d] + (axis_name,)
            else:
                entries[d] = (entries[d], axis_name)
    return PartitionSpec(*entries)


def _kept(val: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``val`` as a new tensor of the graph where it is ``like`` itself (a
    move that changed nothing), so a result is never the input's leaf."""
    return val.view_as(val) if val is like and val.requires_grad else val


def shard_tensor(x, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, place=None, stop_gradient=None) -> Tensor:
    """``x``, the global value on every rank, distributed onto ``mesh``
    with ``placements``: this rank's piece."""
    if not isinstance(x, Tensor):
        x = to_tensor(x, dtype=dtype, place=place)
    gshape = x.shape
    val, _ = reshard_value(x._t, mesh, [Replicate()] * len(placements),
                           mesh, placements, gshape)
    if isinstance(x, Parameter):
        out = x  # shard parameters in place so layers keep identity
        if val is not x._t:
            out._t = val.detach().requires_grad_(x._t.requires_grad)
    else:
        out = Tensor(_kept(val, x._t))
        if stop_gradient is not None:
            out.stop_gradient = stop_gradient
    out._dist_attr = DistAttr(mesh, placements, gshape)
    return out


def reshard(x: Tensor, mesh: ProcessMesh,
            placements: Sequence[Placement]) -> Tensor:
    """``x`` moved to ``placements`` on ``mesh`` through the reshard
    function registry (``auto_parallel/reshard_functions.py``)."""
    cur = x._dist_attr
    src_mesh = cur.process_mesh if cur is not None else mesh
    src_placements = list(cur.placements) if cur is not None else \
        [Replicate()] * len(placements)
    gshape = cur.global_shape if cur is not None else x.shape
    layout_only = not any(p.is_partial() for p in src_placements) \
        and not any(p.is_partial() for p in placements)
    val = x._t if layout_only else x._t.detach()
    new_val, _ = reshard_value(val, src_mesh, src_placements, mesh,
                               placements, gshape)
    if layout_only:
        out = Tensor(_kept(new_val, val))
    else:
        # Partial changes the meaning of the piece: grad-opaque
        out = Tensor(new_val.detach())
        if not x.stop_gradient and new_val.is_floating_point():
            out.stop_gradient = False
    out._dist_attr = DistAttr(mesh, placements, gshape)
    return out


def dtensor_from_local(local, mesh: ProcessMesh,
                       placements: Sequence[Placement]) -> Tensor:
    """The DistTensor whose piece on this rank is ``local`` (api.py:725):
    its global shape is ``local``'s with each sharded dim times the ranks
    of the axes that split it."""
    if not isinstance(local, Tensor):
        local = to_tensor(local)
    global_shape = list(local.shape)
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            global_shape[p.dim] *= mesh.shape[mesh_dim]
    lval = local._t
    t = Tensor(_kept(lval, lval))
    t._dist_attr = DistAttr(mesh, placements, global_shape)
    return t


def dtensor_to_local(x: Tensor, mesh=None, placements=None) -> Tensor:
    """This rank's piece, as a plain tensor."""
    return Tensor(_kept(x._t, x._t))


def unshard_dtensor(x: Tensor) -> Tensor:
    """Gather to a fully replicated dense tensor."""
    attr = x._dist_attr
    if attr is None:
        return x
    return reshard(x, attr.process_mesh,
                   [Replicate()] * len(attr.placements))


def shard_layer(layer: Layer, process_mesh: ProcessMesh,
                shard_fn=None, input_fn=None, output_fn=None) -> Layer:
    """Shard a layer's parameters over `process_mesh` (api.py:908). With no
    shard_fn, parameters replicate (dp-style); shard_fn(name, layer, mesh)
    applies per-layer placements."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for pname, p in list(sublayer._parameters.items()):
                if p is not None and p._dist_attr is None:
                    shard_tensor(p, mesh, [Replicate()] * mesh.ndim)
    for name, sub in layer.named_sublayers(include_self=True):
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda l, inp, out: output_fn(out, process_mesh))
    return layer


def get_placement_of(x: Tensor):
    return None if x._dist_attr is None else x._dist_attr.placements


def local_piece(global_value: torch.Tensor, attr: DistAttr) -> torch.Tensor:
    """This rank's piece of ``global_value`` (the same on every rank) under
    ``attr``, cut without communication: its block for Shard (the layout
    of ``models/convert.py`` ``shard_index``), the value on the first
    coordinate of a Partial axis and zeros on the others, an empty piece
    outside the mesh."""
    from ..models.convert import shard_index
    from .auto_parallel.reshard_functions import coords
    mesh = attr.process_mesh
    if not in_mesh(mesh):
        return global_value.new_empty((0,))
    c = coords(mesh)
    spec = placements_to_spec(attr.placements, mesh, global_value.dim())
    piece = global_value[shard_index(tuple(global_value.shape), spec, mesh,
                                     c)]
    if any(p.is_partial() and c[name] != 0 for p, name in
           zip(attr.placements, mesh.dim_names)):
        return torch.zeros_like(piece)
    return piece
