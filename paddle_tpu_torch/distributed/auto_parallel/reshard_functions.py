"""Reshard function registry: the explicit pairwise {r,s,p} x {r,s,p} moves,
the counterpart of ``paddle_tpu/distributed/auto_parallel/
reshard_functions.py`` (upstream ``reshard_function_registry.cc`` and the
``*_reshard_function.cc`` family).

Every placement change is owned by a registered ``ReshardFunction``,
chosen by ``choose_reshard_function``: the same classes, registered in the
same order as the reference's, so the same class is chosen for every pair.
``SameNdMesh`` breaks a multi-axis change into one pairwise step per mesh
axis (Partial axes first), and ``CrossMesh`` goes through a replicated
value on each mesh.

Each rank holds its piece of a distributed value and each move runs
explicit ``torch.distributed`` collectives over the group of the mesh axis
that changes (``ProcessMesh.groups``); every rank of the mesh calls the
same move at the same point of its program. A piece is the rank's block
for ``Shard`` (a dim split over several axes numbered with the earlier
axis the major one, ``models/convert.py`` ``shard_index``), the whole
value for ``Replicate`` and its own contribution for ``Partial`` (the
value is the sum of the contributions over the axis):

- ``r_to_s``: a local slice; ``s_to_r``: an all-gather; ``s_to_s``: an
  all-to-all;
- ``p_to_r``: an all-reduce; ``p_to_s``: a reduce-scatter;
- ``r_to_p``: the value on the axis's first coordinate, zeros on the others
  (the reference's split); ``s_to_p``: ``s_to_r`` then ``r_to_p``;
  ``p_to_p``: no change.

The layout moves (no Partial on either side) use the differentiable forms
of ``_collectives.py``; a move that involves Partial is cut from the
autograd graph by its caller (``api.reshard``), as in the reference. A
dim that the mesh does not divide raises ``ValueError`` where the move
would split it, as the reference's ``device_put`` does. In a process with
no process group a mesh has one rank and every move is local.

The reference holds a Partial value as the stack of every coordinate's
contribution (``[n_axis, *global]``); a rank's piece here is the slice of
that stack at its coordinate. The reference's sanitizer hook on each
reshard waits for the analysis plane (``ROADMAP.md`` §1 item 9).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import _collectives as C
from ..mesh import ProcessMesh
from ..placements import Placement, Replicate, Shard

_REGISTRY: List["ReshardFunction"] = []


def register_reshard_function(fn: "ReshardFunction"):
    _REGISTRY.append(fn)
    return fn


def all_reshard_functions():
    return list(_REGISTRY)


def choose_reshard_function(src_attr, dst_attr) -> "ReshardFunction":
    """First registered function whose is_suitable accepts the pair
    (reshard_function_registry.cc ChooseProperReshardFunction)."""
    for fn in _REGISTRY:
        if fn.is_suitable(src_attr, dst_attr):
            return fn
    raise NotImplementedError(
        f"no reshard function for {src_attr.placements} -> "
        f"{dst_attr.placements}")


class DistAttrLite:
    """(mesh, placements) pair the functions dispatch on, with the global
    shape of the value."""

    def __init__(self, mesh: ProcessMesh, placements: Sequence[Placement],
                 global_shape: Optional[Sequence[int]] = None):
        self.mesh = mesh
        self.placements = list(placements)
        self.global_shape = None if global_shape is None \
            else [int(d) for d in global_shape]

    def partial_dims(self):
        return [i for i, p in enumerate(self.placements)
                if p.is_partial()]

    def with_placement(self, i: int, p: Placement) -> "DistAttrLite":
        pl = list(self.placements)
        pl[i] = p
        return DistAttrLite(self.mesh, pl, self.global_shape)

    def replicated(self) -> "DistAttrLite":
        return DistAttrLite(self.mesh, [Replicate()] * len(self.placements),
                            self.global_shape)

    def __repr__(self):
        return f"DistAttrLite({self.placements})"


# ------------------------------------------------------ this rank's view

def in_mesh(mesh: ProcessMesh) -> bool:
    """Whether this process holds a piece on ``mesh``."""
    if not dist.is_initialized():
        return True
    from ..parallel_env import process_id
    return process_id() in mesh.process_ids


def coords(mesh: ProcessMesh):
    """This rank's coordinate on each axis of ``mesh``."""
    if not dist.is_initialized():
        if mesh.size != 1:
            raise RuntimeError(f"a mesh of {mesh.size} ranks needs "
                               "init_parallel_env() first")
        return dict.fromkeys(mesh.dim_names, 0)
    return mesh.coords()


def _group(mesh: ProcessMesh, i: int):
    """The process group of mesh axis ``i`` through this rank (None in a
    process with no process group, where the mesh has one rank)."""
    if not dist.is_initialized():
        coords(mesh)
        return None
    return mesh.groups()[mesh.dim_names[i]]


def _shard_axes(placements, d: int) -> List[int]:
    """The mesh axes that split tensor dim ``d``, in mesh order."""
    return [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == d]


def _split(x, d, mesh, i):
    g = _group(mesh, i)
    return x if g is None else C.split(x, d, g)


def _gather(x, d, mesh, i):
    g = _group(mesh, i)
    return x if g is None else C.gather(x, d, g)


def _relayout_dim(x, src: DistAttrLite, dst: DistAttrLite, d: int):
    """Dim ``d`` of the piece moved from ``src``'s split to ``dst``'s
    through the whole dim: gathered over each axis that splits it (the
    innermost first), then split over each of ``dst``'s in mesh order. The
    general form of the layout moves, for the pairs whose fast form would
    break the major-to-minor order of a dim split over several axes."""
    for j in reversed(_shard_axes(src.placements, d)):
        x = _gather(x, d, src.mesh, j)
    for j in _shard_axes(dst.placements, d):
        x = _split(x, d, dst.mesh, j)
    return x


class ReshardFunction:
    name = "base"

    def is_suitable(self, src: DistAttrLite, dst: DistAttrLite) -> bool:
        raise NotImplementedError

    def eval(self, val, src: DistAttrLite, dst: DistAttrLite):
        raise NotImplementedError


def _single_transition(src, dst):
    """Index of the one mesh dim whose placement changes, or None."""
    if len(src.placements) != len(dst.placements):
        return None
    diffs = [i for i, (a, b) in enumerate(
        zip(src.placements, dst.placements)) if a != b]
    return diffs[0] if len(diffs) == 1 else None


def _pair_kind(src, dst, i):
    a, b = src.placements[i], dst.placements[i]

    def k(p):
        return "p" if p.is_partial() else ("s" if p.is_shard() else "r")
    return k(a) + k(b)


class SameStatusReshardFunction(ReshardFunction):
    """No placement change (same_status_reshard_function.cc)."""
    name = "same_status"

    def is_suitable(self, src, dst):
        return src.mesh is dst.mesh and \
            list(src.placements) == list(dst.placements)

    def eval(self, val, src, dst):
        return val


class _PairBase(ReshardFunction):
    kind = ""

    def is_suitable(self, src, dst):
        if src.mesh is not dst.mesh:
            return False
        i = _single_transition(src, dst)
        return i is not None and _pair_kind(src, dst, i) == self.kind

    def _dim(self, src, dst):
        return _single_transition(src, dst)


class RToSReshardFunction(_PairBase):
    """Replicate -> Shard: this rank's slice, no communication
    (r_to_s_reshard_function.cc)."""
    name = "r_to_s"
    kind = "rs"

    def eval(self, val, src, dst):
        i = self._dim(src, dst)
        d = dst.placements[i].dim
        if all(j < i for j in _shard_axes(src.placements, d)):
            return _split(val, d, src.mesh, i)
        return _relayout_dim(val, src, dst, d)


class SToRReshardFunction(_PairBase):
    """Shard -> Replicate: the all-gather (s_to_r_reshard_function.cc)."""
    name = "s_to_r"
    kind = "sr"

    def eval(self, val, src, dst):
        i = self._dim(src, dst)
        d = src.placements[i].dim
        if max(_shard_axes(src.placements, d)) == i:
            return _gather(val, d, src.mesh, i)
        return _relayout_dim(val, src, dst, d)


class SToSReshardFunction(_PairBase):
    """Shard(d1) -> Shard(d2): the all-to-all (s_to_s_reshard_function.cc)."""
    name = "s_to_s"
    kind = "ss"

    def eval(self, val, src, dst):
        i = self._dim(src, dst)
        d1, d2 = src.placements[i].dim, dst.placements[i].dim
        if max(_shard_axes(src.placements, d1)) == i and \
                all(j < i for j in _shard_axes(src.placements, d2)):
            g = _group(src.mesh, i)
            return val if g is None else C.resplit(val, d2, d1, g)
        mid = src.with_placement(i, Replicate())
        return _relayout_dim(_relayout_dim(val, src, mid, d1), mid, dst, d2)


class PToRReshardFunction(_PairBase):
    """Partial -> Replicate: the sum of the contributions, an all-reduce
    (p_to_r_reshard_function.cc)."""
    name = "p_to_r"
    kind = "pr"

    def eval(self, val, src, dst):
        g = _group(src.mesh, self._dim(src, dst))
        return val if g is None else C.all_reduce(val, g)


class PToSReshardFunction(_PairBase):
    """Partial -> Shard: sum then shard, a reduce-scatter
    (p_to_s_reshard_function.cc)."""
    name = "p_to_s"
    kind = "ps"

    def eval(self, val, src, dst):
        i = self._dim(src, dst)
        d = dst.placements[i].dim
        g = _group(src.mesh, i)
        if g is None:
            return val
        if all(j < i for j in _shard_axes(src.placements, d)):
            return C.reduce_scatter(val, d, g)
        mid = src.with_placement(i, Replicate())
        return _relayout_dim(C.all_reduce(val, g), mid, dst, d)


class RToPReshardFunction(_PairBase):
    """Replicate -> Partial: coordinate 0 keeps the value, the rest
    contribute zeros (r_to_p_reshard_function.cc semantics)."""
    name = "r_to_p"
    kind = "rp"

    def eval(self, val, src, dst):
        i = self._dim(src, dst)
        if coords(src.mesh)[src.mesh.dim_names[i]] == 0:
            return val
        return torch.zeros_like(val)


class SToPReshardFunction(_PairBase):
    """Shard -> Partial: composes s_to_r then r_to_p, the way the
    reference routes unsupported pairs through an intermediate."""
    name = "s_to_p"
    kind = "sp"

    def eval(self, val, src, dst):
        mid = src.with_placement(self._dim(src, dst), Replicate())
        val = SToRReshardFunction().eval(val, src, mid)
        return RToPReshardFunction().eval(val, mid, dst)


class PToPSameStatusFunction(_PairBase):
    """Partial -> Partial on the same axis: identity."""
    name = "p_to_p"
    kind = "pp"

    def eval(self, val, src, dst):
        return val


class SameNdMeshReshardFunction(ReshardFunction):
    """Multi-axis change on one mesh: decompose into per-mesh-dim
    pairwise steps, resolving partials first (nd_mesh_reshard_function.cc
    SameNdMeshReshardFunction)."""
    name = "same_nd_mesh"

    def is_suitable(self, src, dst):
        if src.mesh is not dst.mesh:
            return False
        if len(src.placements) != len(dst.placements):
            return False
        diffs = [i for i, (a, b) in enumerate(
            zip(src.placements, dst.placements)) if a != b]
        return len(diffs) > 1

    def eval(self, val, src, dst):
        cur = src
        # partial transitions first (cheapest to resolve before moving
        # shards around), then the rest, one mesh dim at a time
        order = sorted(
            [i for i, (a, b) in enumerate(
                zip(cur.placements, dst.placements)) if a != b],
            key=lambda i: 0 if cur.placements[i].is_partial() else 1)
        for i in order:
            step = cur.with_placement(i, dst.placements[i])
            val = choose_reshard_function(cur, step).eval(val, cur, step)
            cur = step
        return val


def _empty_piece(val):
    """The piece of a rank outside the value's mesh (a leaf that requires
    grad where ``val`` does, so ``stop_gradient`` reads the same on every
    rank)."""
    return val.new_empty((0,)).requires_grad_(val.requires_grad)


def _hand_over(val, src: DistAttrLite, dst: DistAttrLite):
    """A value replicated over ``src.mesh`` made present on every rank of
    ``dst.mesh``: each rank of ``dst`` that ``src`` lacks receives it from
    one rank of ``src`` (point to point, over the world's group). Returns
    this rank's copy, or an empty piece outside ``dst``."""
    if not dist.is_initialized():
        return val
    from ..parallel_env import process_id, rank_of
    me = process_id()
    have = src.mesh.process_ids
    need = [r for r in dst.mesh.process_ids if r not in have]
    works = []
    if me in need:
        buf = val.new_empty(src.global_shape).requires_grad_(
            val.requires_grad)
        C.CALLS["p2p"] += 1
        works.append(dist.irecv(
            buf.detach(), rank_of(have[need.index(me) % len(have)])))
        val = buf
    elif me in have:
        for k, r in enumerate(need):
            if have[k % len(have)] == me:
                C.CALLS["p2p"] += 1
                works.append(dist.isend(val.detach().contiguous(),
                                        rank_of(r)))
    for w in works:
        w.wait()
    return val if me in dst.mesh.process_ids else _empty_piece(val)


class CrossMeshReshardFunction(ReshardFunction):
    """Different meshes: gather to replicated on the source mesh, hand the
    value to the destination's ranks, redistribute there (the reference's
    cross-mesh send/recv path). Only the ranks of both meshes keep the
    autograd edge: a value that crosses to another process arrives there
    as a new leaf."""
    name = "cross_mesh"

    def is_suitable(self, src, dst):
        return src.mesh is not dst.mesh

    def eval(self, val, src, dst):
        rep_src = src.replicated()
        if in_mesh(src.mesh) and list(src.placements) != rep_src.placements:
            fn = choose_reshard_function(src, rep_src)
            val = fn.eval(val, src, rep_src)
        val = _hand_over(val, src, dst)
        rep_dst = dst.replicated()
        if in_mesh(dst.mesh) and list(dst.placements) != rep_dst.placements:
            fn = choose_reshard_function(rep_dst, dst)
            val = fn.eval(val, rep_dst, dst)
        return val


# registration order = dispatch priority (specific before general), the
# registry-build order of reshard_function_registry.cc
for _fn in (SameStatusReshardFunction(), RToSReshardFunction(),
            SToRReshardFunction(), SToSReshardFunction(),
            PToRReshardFunction(), PToSReshardFunction(),
            RToPReshardFunction(), SToPReshardFunction(),
            PToPSameStatusFunction(), SameNdMeshReshardFunction(),
            CrossMeshReshardFunction()):
    register_reshard_function(_fn)


def reshard_value(val, src_mesh, src_placements, dst_mesh,
                  dst_placements, global_shape=None):
    """Registry-dispatched reshard of this rank's piece ``val`` (a
    ``torch.Tensor``) of a value of ``global_shape``: returns the new piece
    and the function chosen. Every rank of the world calls it (a mesh makes
    its process groups on first use, collectively over the world); a rank
    outside both meshes keeps an empty piece."""
    src = DistAttrLite(src_mesh, src_placements, global_shape)
    dst = DistAttrLite(dst_mesh, dst_placements, global_shape)
    fn = choose_reshard_function(src, dst)
    if dist.is_initialized():
        src_mesh.groups()
        dst_mesh.groups()
    if isinstance(fn, CrossMeshReshardFunction):
        return fn.eval(val, src, dst), fn
    if not in_mesh(src_mesh):
        return _empty_piece(val), fn
    return fn.eval(val, src, dst), fn
