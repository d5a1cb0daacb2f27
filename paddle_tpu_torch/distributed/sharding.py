"""ZeRO sharding in the eager multi-process regime: the counterpart of
``paddle_tpu/distributed/sharding.py`` (upstream
``distributed/sharding/group_sharded.py`` and ``meta_parallel/sharding``).

Each parameter has one owner rank in the sharding group, chosen greedily
by size so the ranks hold about equal shares (``_assign_owners``).

- ``DygraphShardingOptimizer`` (stages 1 and 2) wraps an optimizer. Its
  ``step`` agrees on which parameters have a gradient (one collective of
  the ranks' flags, read once on the host), reduces each such gradient in
  float32 to its owner (one ``reduce`` each) and divides it there by the
  number of ranks that had one, drops it on the other ranks, runs the
  wrapped optimizer (which so updates, and keeps state for, only the
  owned parameters), then broadcasts every parameter from its owner. With
  ``offload=True`` the owned states live in host memory between steps
  (pinned buffers beside a card, made at the first step and kept). A
  ``ClipGradByGlobalNorm`` becomes ``_ShardedGlobalNormClip``: the squares
  of the owned gradients are summed over the group, so every owner clips
  by the one global norm.
- ``DygraphShardingStage3`` (stage 3) wraps a layer: between steps each
  rank keeps only its owned parameters (``release`` leaves the others as
  empty placeholders); ``materialize`` broadcasts them from their owners
  before a forward; ``step_and_release`` steps the sharded optimizer and
  releases.
- ``group_sharded_parallel`` (levels ``os``, ``os_g``, ``p_g_os``) and its
  classes ``GroupShardedOptimizerStage2``, ``GroupShardedStage2`` and
  ``GroupShardedStage3``: over a sharding group (the hybrid group's
  sharding axis, else its dp axis, else every rank) of more than one rank
  with a process group they run the classes above; at one rank, or
  without a process group, they pass through to the model and optimizer,
  as the reference's do outside a mesh. The reference, inside one
  process, would instead annotate the states and parameters for GSPMD
  over its single-controller mesh; the port has no such mesh.

Every collective runs on the tensors' device through ``torch.distributed``
(NCCL on a card, gloo on the CPU), a one-rank group included (a sum over
one rank divided by 1 changes no bit), and counts in
``_collectives.CALLS``.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch
import torch.distributed as dist

from .._core.tensor import Tensor
from ..nn.clip import (ClipGradByGlobalNorm, _payload, _scale, _scaled,
                       _sum_squares)
from ..nn.layer import Layer
from ._collectives import CALLS, all_reduce_, broadcast_, reduce_
from .fleet.topology import get_hybrid_communicate_group
from .process_group import Group, default_group


class ShardingOptimizerStage:
    OS = 1          # optimizer states sharded
    OS_G = 2        # + gradients
    P_G_OS = 3      # + parameters


def _zero_group(group) -> Group:
    """``group``, else the hybrid group's sharding axis (if it has more
    than one rank) or its dp axis, else the default group."""
    if group is not None:
        return group
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        if hcg.get_sharding_parallel_world_size() > 1:
            return hcg.get_sharding_parallel_group()
        return hcg.get_data_parallel_group()
    return default_group()


def _eager(group: Group) -> bool:
    """Whether ``group_sharded_parallel`` runs the eager ZeRO classes over
    ``group``: more than one rank, joined by a process group."""
    return group.pg is not None and group.nranks > 1


def _require_pg(group) -> Group:
    g = group if group is not None else default_group()
    if g.pg is None:
        raise RuntimeError(
            "eager ZeRO sharding needs a process group: call "
            "init_parallel_env() first")
    if g.rank < 0:
        raise RuntimeError(f"this rank is not a member of {g}")
    return g


def _assign_owners(params, nranks) -> Dict[int, int]:
    """Greedy size-balanced owner (index in the group) of each parameter,
    largest first."""
    sizes = [0] * nranks
    owners = {}
    order = sorted(range(len(params)), key=lambda i: -params[i].size)
    for i in order:
        r = sizes.index(min(sizes))
        owners[id(params[i])] = r
        sizes[r] += params[i].size
    return owners


class _ShardedGlobalNormClip:
    """``ClipGradByGlobalNorm`` over a group: the float32 squares of this
    rank's gradients summed over the group, so each owner clips by the
    global norm. A rank with no gradient to clip calls ``join``."""

    def __init__(self, inner_clip, group: Group):
        self._group = group
        self.clip_norm = inner_clip.clip_norm

    def _global_norm(self, local_sq: torch.Tensor) -> torch.Tensor:
        total = local_sq.reshape(1).clone()
        all_reduce_(total, self._group.pg)
        return torch.sqrt(total[0])

    def join(self, device) -> None:
        self._global_norm(torch.zeros((), dtype=torch.float32,
                                      device=device))

    @torch.no_grad()
    def __call__(self, params_grads):
        grads = [_payload(g) for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        return _scaled(params_grads, _scale(
            self.clip_norm, self._global_norm(_sum_squares(grads))))


class DygraphShardingOptimizer:
    """Stages 1 and 2 over ``group`` (default: every rank); see the
    module docstring."""

    def __init__(self, optimizer, group=None, offload=False):
        self._inner = optimizer
        self._group = _require_pg(group)
        self._offload = bool(offload)
        # taking part is decided by stop_gradient only (the same on every
        # rank), so every rank issues the same collectives
        self._params = [p for p in optimizer._all_params()
                        if not p.stop_gradient]
        self._owners = {pid: self._group.ranks[r] for pid, r in
                        _assign_owners(self._params,
                                       self._group.nranks).items()}
        self._devices = {id(p): p._t.device for p in self._params}
        self._host: Dict = {}   # (param id, state key) -> host buffer
        self.last_collectives = 0
        clip = getattr(optimizer, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm):
            optimizer._grad_clip = _ShardedGlobalNormClip(clip, self._group)

    @property
    def inner_opt(self):
        return self._inner

    def owned(self, p) -> bool:
        return self._owners[id(p)] == dist.get_rank()

    @torch.no_grad()
    def step(self):
        pg, me = self._group.pg, dist.get_rank()
        params = self._params
        if not params:
            return
        before = sum(CALLS.values())
        dev = params[0]._t.device
        # 1) which parameters have a gradient on how many ranks: one
        # collective and one read
        has = torch.tensor([p._t.grad is not None for p in params],
                           dtype=torch.float32, device=dev)
        all_reduce_(has, pg)
        counts = has.tolist()
        # 2) each gradient summed in float32 onto its owner, divided there
        # by the ranks that had one; dropped elsewhere
        for p, count in zip(params, counts):
            if not count:
                continue
            owner, grad = self._owners[id(p)], p._t.grad
            if grad is not None and grad.dtype == torch.float32 \
                    and grad.is_contiguous():
                buf = grad
            elif grad is not None:
                buf = grad.float().contiguous()
            else:
                buf = torch.zeros(p._t.shape, dtype=torch.float32,
                                  device=p._t.device)
            reduce_(buf, owner, pg)
            if me != owner:
                p._t.grad = None
                continue
            if count != 1:
                buf.div_(count)
            if grad is None:
                p._t.grad = buf.to(p._t.dtype)
            elif buf is not grad:
                grad.copy_(buf)
        # 3) the wrapped optimizer: the owned parameters only
        clip = getattr(self._inner, "_grad_clip", None)
        if isinstance(clip, _ShardedGlobalNormClip) and not any(
                p._t.grad is not None for p in params if self.owned(p)):
            clip.join(dev)   # the norm's collective, with nothing to add
        if self._offload:
            self._onload()
        self._inner.step()
        if self._offload:
            self._offload_states()
        # 4) every parameter from its owner
        for p in params:
            broadcast_(p._t, self._owners[id(p)], pg)
        self.last_collectives = sum(CALLS.values()) - before

    def _to_host(self, key, v: torch.Tensor) -> torch.Tensor:
        if not v.is_cuda:
            return v
        h = self._host.get(key)
        if h is None:
            h = self._host[key] = torch.empty(v.shape, dtype=v.dtype,
                                              pin_memory=True)
        h.copy_(v, non_blocking=True)
        return h

    def _offload_states(self) -> None:
        """The owned states and master weights into host buffers (pinned,
        made at the first step and kept), freeing their device memory;
        the host waits for the copies."""
        inner = self._inner
        for pid, st in inner._states.items():
            for k, v in st.items():
                st[k] = self._to_host((pid, k), v)
        for pid, m in inner._master.items():
            inner._master[pid] = self._to_host((pid, "master"), m)
        if self._host:
            torch.cuda.current_stream().synchronize()

    def _onload(self) -> None:
        """The offloaded states back on their parameters' devices."""
        inner = self._inner
        for pid, st in inner._states.items():
            dev = self._devices[pid]
            for k, v in st.items():
                st[k] = v.to(dev, non_blocking=True)
        for pid, m in inner._master.items():
            inner._master[pid] = m.to(self._devices[pid], non_blocking=True)

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(v.numel() * v.element_size()
                   for st in self._inner._states.values()
                   for v in st.values())

    def __getattr__(self, item):
        # clear_grad, state_dict (the owned states) and the rest
        return getattr(self.__dict__["_inner"], item)


class DygraphShardingStage3(Layer):
    """Stage 3 over ``group``: parameter storage sharded between steps;
    see the module docstring. Step through ``step_and_release`` (or the
    wrapped ``sharded_optimizer``), never through the raw optimizer: the
    gradients would be applied unsharded and the ranks diverge."""

    def __init__(self, layer, optimizer=None, group=None, offload=False,
                 **kwargs):
        super().__init__()
        self._layers = layer
        self._group = _require_pg(group)
        params = list(layer.parameters())
        self._all_params_list = params
        self._owners = {pid: self._group.ranks[r] for pid, r in
                        _assign_owners(params, self._group.nranks).items()}
        self._shapes = {id(p): (tuple(p._t.shape), p._t.dtype, p._t.device)
                        for p in params}
        self._materialized = True
        if optimizer is not None and not isinstance(
                optimizer, DygraphShardingOptimizer):
            optimizer = DygraphShardingOptimizer(optimizer, self._group,
                                                 offload=offload)
        self._sharded_optim = optimizer

    @property
    def sharded_optimizer(self):
        return self._sharded_optim

    def owned(self, p) -> bool:
        return self._owners[id(p)] == dist.get_rank()

    @torch.no_grad()
    def materialize(self):
        """Every parameter broadcast from its owner (gather at use)."""
        if self._materialized:
            return
        for p in self._all_params_list:
            owner = self._owners[id(p)]
            if self.owned(p):
                buf = p._t
            else:
                shape, dtype, device = self._shapes[id(p)]
                buf = torch.empty(shape, dtype=dtype, device=device)
            broadcast_(buf, owner, self._group.pg)
            if buf is not p._t:
                p._t = buf.requires_grad_(not p.stop_gradient)
        self._materialized = True

    def release(self):
        """The parameters of other owners replaced by empty placeholders
        (about 1/N of the parameter memory kept on each rank). A group of
        one rank owns them all: nothing is released, and the next
        ``materialize`` has nothing to gather."""
        if self._group.nranks == 1:
            return
        for p in self._all_params_list:
            if not self.owned(p):
                _, dtype, device = self._shapes[id(p)]
                p._t = torch.empty(0, dtype=dtype, device=device) \
                    .requires_grad_(not p.stop_gradient)
        self._materialized = False

    def param_bytes(self) -> int:
        """Bytes of parameter storage this rank holds now."""
        return sum(p._t.numel() * p._t.element_size()
                   for p in self._all_params_list)

    def forward(self, *args, **kwargs):
        self.materialize()
        return self._layers(*args, **kwargs)

    def step_and_release(self):
        """The sharded optimizer's step, then ``release``."""
        if self._sharded_optim is None:
            raise RuntimeError(
                "DygraphShardingStage3 was built without an optimizer; "
                "pass one at construction or step the wrapped "
                "DygraphShardingOptimizer yourself")
        self._sharded_optim.step()
        self.release()

    def state_dict(self, *a, **k):
        self.materialize()
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, **k):
        self.materialize()
        out = self._layers.set_state_dict(sd, **k)
        self.release()
        return out


class GroupShardedOptimizerStage2:
    """The stage-1/2 optimizer of ``group_sharded_parallel``: a
    ``DygraphShardingOptimizer`` over a sharding group of more than one
    rank, else the optimizer itself."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", **kwargs):
        self._optim = optim
        self._group = _zero_group(group)
        self._zero = DygraphShardingOptimizer(optim, self._group, offload) \
            if _eager(self._group) else None

    def __getattr__(self, item):
        d = self.__dict__
        return getattr(d["_zero"] if d.get("_zero") is not None
                       else d["_optim"], item)

    def step(self):
        (self._zero or self._optim).step()

    def clear_grad(self, set_to_zero=True):
        self._optim.clear_grad()

    clear_gradients = clear_grad


class GroupShardedStage2(Layer):
    """The stage-1/2 model of ``group_sharded_parallel``: the model
    (the gradients are reduced by the optimizer's step)."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23, **kwargs):
        super().__init__()
        self._layers = layer
        self._sharding_optimizer = sharding_optimizer

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, **k):
        return self._layers.set_state_dict(sd, **k)


class GroupShardedStage3(DygraphShardingStage3):
    """The stage-3 model of ``group_sharded_parallel``: a
    ``DygraphShardingStage3`` over a sharding group of more than one rank;
    at one rank, or without a process group, the model, every parameter
    its own (``materialize``/``release`` do nothing)."""

    def __init__(self, layer, optimizer=None, group=None, sync_comm=False,
                 segment_size=2 ** 20, pertrain_sync_models=True,
                 offload=False, **kwargs):
        group = _zero_group(group)
        if _eager(group):
            super().__init__(layer, optimizer, group, offload)
            return
        Layer.__init__(self)
        self._layers = layer
        self._group = None
        self._all_params_list = list(layer.parameters())
        self._materialized = True
        self._sharded_optim = optimizer

    def owned(self, p) -> bool:
        return self._group is None or super().owned(p)

    def materialize(self):
        if self._group is not None:
            super().materialize()

    def release(self):
        if self._group is not None:
            super().release()


class _Stage3Step:
    """The optimizer ``group_sharded_parallel`` returns at ``p_g_os`` over
    a sharding group: its ``step`` is the model's ``step_and_release``."""

    def __init__(self, model: DygraphShardingStage3):
        self._model = model

    def step(self):
        self._model.step_and_release()

    def __getattr__(self, item):
        return getattr(self.__dict__["_model"].sharded_optimizer, item)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """(model, optimizer, scaler) sharded at ``level``: ``os`` or ``os_g``
    (``GroupShardedStage2`` and ``GroupShardedOptimizerStage2``),
    ``p_g_os`` (``GroupShardedStage3``); eager ZeRO over a sharding group
    of more than one rank, pass-through otherwise."""
    if level in ("os", "os_g"):
        opt = GroupShardedOptimizerStage2(model.parameters(), optimizer,
                                          group=group, offload=offload)
        model = GroupShardedStage2(model, opt, group=group,
                                   sync_buffers=sync_buffers)
        return model, opt, scaler
    if level == "p_g_os":
        model = GroupShardedStage3(model, optimizer=optimizer, group=group,
                                   sync_comm=sync_comm,
                                   segment_size=segment_size,
                                   offload=offload)
        if model._group is not None:
            optimizer = _Stage3Step(model)
        return model, optimizer, scaler
    raise ValueError(f"unknown group_sharded level: {level}")


def save_group_sharded_model(model, output, optimizer=None):
    """Writes ``output/model.pdmodel`` (the whole model's state, gathered
    from the owners under stage 3) and, with ``optimizer``,
    ``output/model.pdopt`` (every rank's owned states together), with
    ``framework.save``, from the sharding group's first rank. Every rank
    of the group calls it."""
    from ..framework import save
    group = getattr(model, "_group", None) or getattr(
        getattr(optimizer, "_zero", None) or optimizer, "_group", None)
    if isinstance(model, DygraphShardingStage3):
        state = model.state_dict()
    else:
        layer = model._layers if hasattr(model, "_layers") else model
        state = layer.state_dict()
    opt_state = None
    if optimizer is not None:
        opt_state = optimizer.state_dict()
        if group is not None and group.pg is not None and group.nranks > 1:
            parts: List = [None] * group.nranks
            mine = {k: v._t.detach().cpu() if isinstance(v, Tensor) else v
                    for k, v in opt_state.items()}
            dist.all_gather_object(parts, mine, group=group.pg)
            opt_state = {}
            for part in parts:
                opt_state.update({k: Tensor(v) if isinstance(
                    v, torch.Tensor) else v for k, v in part.items()})
    if group is not None and group.pg is not None \
            and dist.get_rank() != group.ranks[0]:
        return
    os.makedirs(output, exist_ok=True)
    save(state, os.path.join(output, "model.pdmodel"))
    if opt_state is not None:
        save(opt_state, os.path.join(output, "model.pdopt"))
