"""Static auto-parallel Partitioner: rank-local programs from the
completed mini-IR, the counterpart of
``paddle_tpu/distributed/auto_parallel/partitioner.py`` (upstream
``python/paddle/distributed/auto_parallel/static/partitioner.py``).

After the completion pass has assigned a TensorDistAttr to every value,
the Partitioner emits, for each rank coordinate of the mesh, a program
whose tensors carry LOCAL (per-shard) shapes and whose op stream contains
the explicit communication upstream inserts: ``c_allreduce_sum`` where a
producer leaves a Partial pending reduce, and ``send``/``recv`` pairs at
pipeline-stage cuts. dp enters through feed slicing, mp through
parameter-shard slicing.

``run_partitioned`` is the composed runner: it executes every rank's
program lock-step in one process, on the feeds' device (compute ops
through the port's op registry, allreduce by summing across the partial
mesh axis's peer group, P2P through an in-memory mailbox), and stitches
the fetched shards back to the global value, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..mesh import ProcessMesh


def shard_bounds(total: int, n: int) -> List[int]:
    """Uneven-shard boundaries (numpy array_split convention: the
    first `total % n` shards get one extra element), so dims a mesh axis
    does not divide partition too."""
    base, rem = divmod(total, n)
    offs = [0]
    for i in range(n):
        offs.append(offs[-1] + base + (1 if i < rem else 0))
    return offs


class LocalOp:
    """One rank-local instruction."""

    __slots__ = ("kind", "node", "var", "mesh_dim", "peer", "stage")

    def __init__(self, kind, node=None, var=None, mesh_dim=None,
                 peer=None, stage=None):
        self.kind = kind        # compute | allreduce | send | recv
        self.node = node        # compute: the (shared) OpNode
        self.var = var          # comm: the Variable moved/reduced
        self.mesh_dim = mesh_dim
        self.peer = peer        # send/recv: peer stage index
        self.stage = stage

    def __repr__(self):
        if self.kind == "compute":
            return f"LocalOp(compute {self.node.op_name})"
        return f"LocalOp({self.kind} {getattr(self.var, 'name', '?')})"


class RankProgram:
    """The rank-local program for one mesh coordinate."""

    def __init__(self, coord: Dict[str, int], ops: List[LocalOp],
                 local_shapes: Dict[int, Tuple[int, ...]],
                 feed_slices: Dict[str, List[slice]]):
        self.coord = coord
        self.ops = ops
        self.local_shapes = local_shapes   # id(var) -> local shape
        self.feed_slices = feed_slices     # feed name -> per-dim slices

    def __repr__(self):
        return (f"RankProgram(coord={self.coord}, "
                f"ops={[o.kind for o in self.ops]})")


class Partitioner:
    """partitioner.py analog over the mini-IR."""

    def __init__(self, ctx, mesh: ProcessMesh, pp_dim: str = "pp",
                 stage_map: Optional[Sequence[int]] = None):
        self.ctx = ctx
        self.mesh = mesh
        self.pp_dim = pp_dim if pp_dim in mesh.dim_names else None
        # op_index -> stage from the cost-based planner; None = uniform
        self.stage_map = list(stage_map) if stage_map is not None else None

    # ------------------------------------------------------------ helpers
    def _attr(self, var):
        return self.ctx.attrs.get(id(var))

    def _local_shape(self, var, coord) -> Optional[Tuple[int, ...]]:
        shape = list(getattr(var, "var_shape", getattr(var, "shape", [])))
        attr = self._attr(var)
        if attr is None:
            return tuple(shape)
        for d, m in enumerate(attr.dims_mapping):
            if m != -1:
                n = self.mesh.shape[m]
                i = coord[self.mesh.dim_names[m]]
                offs = shard_bounds(shape[d], n)
                shape[d] = offs[i + 1] - offs[i]
        return tuple(shape)

    def _slices_for(self, var, coord) -> List[slice]:
        shape = list(getattr(var, "var_shape", getattr(var, "shape", [])))
        attr = self._attr(var)
        out = [slice(None)] * len(shape)
        if attr is None:
            return out
        for d, m in enumerate(attr.dims_mapping):
            if m != -1:
                axis = self.mesh.dim_names[m]
                n = self.mesh.shape[m]
                i = coord[axis]
                offs = shard_bounds(shape[d], n)
                out[d] = slice(offs[i], offs[i + 1])
        return out

    def _stage_of_op(self, idx: int, n_ops: int) -> int:
        if self.pp_dim is None:
            return 0
        if self.stage_map is not None:
            return self.stage_map[idx]
        stages = self.mesh.shape[self.mesh.dim_names.index(self.pp_dim)]
        per = max(n_ops // stages, 1)
        return min(idx // per, stages - 1)

    # ---------------------------------------------------------- partition
    def partition(self, ws, coord: Dict[str, int]) -> RankProgram:
        """Emit the rank-local program for one mesh coordinate from a
        completed Workspace (ops + ctx dist attrs)."""
        my_stage = coord.get(self.pp_dim, 0) if self.pp_dim else 0
        n_ops = len(ws.ops)
        ops: List[LocalOp] = []
        local_shapes: Dict[int, Tuple[int, ...]] = {}
        produced_stage: Dict[int, int] = {}   # id(var) -> producing stage
        sent: set = set()   # (id(var), dst_stage): one send per consumer
        # stage

        for var in ws.feed_vars:
            produced_stage[id(var)] = 0
            local_shapes[id(var)] = self._local_shape(var, coord)

        for idx, node in enumerate(ws.ops):
            stage = self._stage_of_op(idx, n_ops)
            # cross-stage inputs: the TRUE producer sends to EVERY
            # consuming stage exactly once (a diamond DAG where stages 1
            # and 2 both read a stage-0 var gets two sends from stage 0,
            # not a relay through stage 1)
            for t in node.inputs:
                src = produced_stage.get(id(t))
                if src is None or src == stage:
                    continue
                key = (id(t), stage)
                if key in sent:
                    continue
                sent.add(key)
                if src == my_stage:
                    ops.append(LocalOp("send", var=t, peer=stage,
                                       stage=src))
                if stage == my_stage:
                    ops.append(LocalOp("recv", var=t, peer=src,
                                       stage=stage))
            if stage == my_stage:
                ops.append(LocalOp("compute", node=node, stage=stage))
            for var in node.outputs:
                produced_stage[id(var)] = stage
                local_shapes[id(var)] = self._local_shape(var, coord)
                attr = self._attr(var)
                if attr is not None and attr.partial_status:
                    # the reference inserts c_allreduce_sum right after
                    # the producing op and clears the partial mark
                    for mesh_dim in sorted(attr.partial_status):
                        if stage == my_stage:
                            ops.append(LocalOp("allreduce", var=var,
                                               mesh_dim=mesh_dim,
                                               stage=stage))
                    attr = attr.copy()
                    attr.partial_status = {}
                    self.ctx.attrs[id(var)] = attr

        feed_slices = {v.name: self._slices_for(v, coord)
                       for v in ws.feed_vars}
        return RankProgram(dict(coord), ops, local_shapes, feed_slices)

    def partition_all(self, ws) -> List[RankProgram]:
        """One RankProgram per mesh coordinate, rank-major order."""
        coords = []
        shape = self.mesh.shape
        names = self.mesh.dim_names
        for flat in range(int(np.prod(shape))):
            coord, rem = {}, flat
            for n, s in zip(reversed(names), reversed(shape)):
                coord[n] = rem % s
                rem //= s
            coords.append(coord)
        # partition mutates ctx partial marks; deep-copy attrs per call
        saved = {k: v.copy() for k, v in self.ctx.attrs.items()}
        out = []
        for coord in coords:
            self.ctx.attrs = {k: v.copy() for k, v in saved.items()}
            out.append(self.partition(ws, coord))
        self.ctx.attrs = saved
        return out


# ------------------------------------------------------ composed runner

def run_partitioned(rank_programs: Sequence[RankProgram], ws, mesh,
                    global_feeds: Dict[str, np.ndarray],
                    fetch_var, ctx, pp_dim: str = "pp") -> np.ndarray:
    """Execute every rank's program lock-step and stitch the fetch back
    to its global value (the dryrun composition of the per-rank
    programs; host-driven analog of the reference's multi-rank Plan)."""
    import torch
    from torch.utils import _pytree as pytree

    from ..._core.op_registry import get_op
    from ..._core.tensor import Tensor
    from ...static import Variable

    def as_tensor(v):
        return v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v))

    names = mesh.dim_names

    def flat_rank(coord):
        r = 0
        for n, s in zip(names, mesh.shape):
            r = r * s + coord[n]
        return r

    envs = {flat_rank(rp.coord): {} for rp in rank_programs}
    mailbox: Dict[Tuple, np.ndarray] = {}
    send_seq: Dict[Tuple, int] = {}
    recv_seq: Dict[Tuple, int] = {}

    # feeds: each rank gets its slice
    for rp in rank_programs:
        env = envs[flat_rank(rp.coord)]
        for v in ws.feed_vars:
            g = global_feeds[v.name]
            env[id(v)] = as_tensor(g[tuple(rp.feed_slices[v.name])])

    def value_of(rp, env, t):
        if t is None:
            return None
        if isinstance(t, Variable):
            t = ws.resolve(t)
        if isinstance(t, Variable):
            if id(t) in env:
                return env[id(t)]
            if id(t) in ws.const_env:
                return ws.const_env[id(t)]
            raise KeyError(f"missing value for '{t.name}'")
        # captured parameter/constant: slice this rank's shard
        val = t._t if hasattr(t, "_t") else t
        attr = ctx.attrs.get(id(t))
        if attr is not None and any(m != -1 for m in attr.dims_mapping):
            val = as_tensor(val)
            sl = [slice(None)] * val.ndim
            for d, m in enumerate(attr.dims_mapping):
                if m != -1:
                    n = mesh.shape[m]
                    i = rp.coord[names[m]]
                    offs = shard_bounds(val.shape[d], n)
                    sl[d] = slice(offs[i], offs[i + 1])
            val = val[tuple(sl)]
        return val

    def peers_along(coord, mesh_dim):
        group = []
        for i in range(mesh.shape[mesh_dim]):
            c = dict(coord)
            c[names[mesh_dim]] = i
            group.append(flat_rank(c))
        return group

    # lock-step: round-robin the per-rank instruction pointers; an op
    # blocked on a recv whose mailbox slot is empty is retried after the
    # other ranks advance (sends always precede their recvs in a valid
    # schedule, so this terminates)
    ptrs = {r: 0 for r in envs}
    progress = True
    while progress:
        progress = False
        for rp in rank_programs:
            r = flat_rank(rp.coord)
            while ptrs[r] < len(rp.ops):
                op = rp.ops[ptrs[r]]
                env = envs[r]
                if op.kind == "compute":
                    node = op.node
                    opdef = get_op(node.op_name)
                    vals = [value_of(rp, env, t) for t in node.inputs]
                    out = opdef.fn(*vals, **node.attrs)
                    outs = out if opdef.multi_output else (out,)
                    leaves = pytree.tree_leaves(outs)
                    for var, o in zip(node.outputs, leaves):
                        env[id(var)] = o
                elif op.kind == "allreduce":
                    group = peers_along(rp.coord, op.mesh_dim)
                    # all peers must have produced their contribution
                    if not all(id(op.var) in envs[p] for p in group):
                        break
                    if not env.get(("__reduced__", id(op.var), op.mesh_dim)):
                        total = sum(envs[p][id(op.var)] for p in group)
                        for p in group:
                            envs[p][id(op.var)] = total
                            envs[p][("__reduced__", id(op.var),
                                     op.mesh_dim)] = True
                elif op.kind == "send":
                    chan = (r, op.peer, id(op.var))
                    seq = send_seq.get(chan, 0)
                    send_seq[chan] = seq + 1
                    mailbox[chan + (seq,)] = env[id(op.var)]
                elif op.kind == "recv":
                    # sender = same coord with pp index = op.peer's stage
                    src_coord = dict(rp.coord)
                    if pp_dim in names:
                        src_coord[pp_dim] = op.peer
                    src = flat_rank(src_coord)
                    chan = (src, rp.coord.get(pp_dim, 0), id(op.var))
                    seq = recv_seq.get(chan, 0)
                    if chan + (seq,) not in mailbox:
                        break
                    recv_seq[chan] = seq + 1
                    env[id(op.var)] = mailbox[chan + (seq,)]
                ptrs[r] += 1
                progress = True
    prog_of = {flat_rank(rp.coord): rp for rp in rank_programs}
    stuck = [r for r in ptrs if ptrs[r] < len(prog_of[r].ops)]
    if stuck:
        raise RuntimeError(f"composed run deadlocked at {stuck}")

    # stitch the fetch: concat shard dims, assert replicated agreement
    attr = ctx.attrs.get(id(ws.resolve(fetch_var)))
    fv = ws.resolve(fetch_var)
    shards = {}
    for rp in rank_programs:
        r = flat_rank(rp.coord)
        if id(fv) in envs[r]:
            shards[r] = (rp.coord, Tensor(envs[r][id(fv)]).numpy())
    if not shards:
        raise RuntimeError("fetch var not produced by any rank")
    if attr is None or all(m == -1 for m in attr.dims_mapping):
        vals = list(shards.values())
        for _, v in vals[1:]:
            np.testing.assert_allclose(v, vals[0][1], rtol=1e-5,
                                       atol=1e-5)
        return vals[0][1]
    # reassemble along sharded dims
    out = None
    shard_dims = [(d, m) for d, m in enumerate(attr.dims_mapping)
                  if m != -1]
    # group shards by their shard-axis coordinates; replicas agree
    by_key = {}
    for coord, v in shards.values():
        key = tuple(coord[names[m]] for _, m in shard_dims)
        if key in by_key:
            np.testing.assert_allclose(v, by_key[key], rtol=1e-5,
                                       atol=1e-5)
        else:
            by_key[key] = v
    # nested concatenate, last shard dim first
    def assemble(prefix, depth):
        d, m = shard_dims[depth]
        parts = []
        for i in range(mesh.shape[m]):
            if depth + 1 < len(shard_dims):
                parts.append(assemble(prefix + (i,), depth + 1))
            else:
                parts.append(by_key[prefix + (i,)])
        return np.concatenate(parts, axis=d)

    return assemble((), 0)
