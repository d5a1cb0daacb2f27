"""``HybridParallelOptimizer``, its clip and ``HybridParallelGradScaler``:
the counterpart of ``paddle_tpu/distributed/fleet/hybrid_optimizer.py``
(upstream ``meta_optimizers/dygraph_optimizer/
hybrid_parallel_optimizer.py``), for the eager multi-process regime.

- The gradients of the parameters that are not split over mp (not
  ``is_distributed``) are averaged over the mp group, and the sep group,
  before the update: tensor-parallel ranks compute them from different
  blocks, and the replicas would drift. All of one type go in one flat
  buffer and one collective, on their device.
- A ``ClipGradByGlobalNorm`` of the wrapped optimizer becomes
  ``HybridParallelClipGrad`` when mp or pp has more than one rank: the
  squares of the split parameters' gradients are summed over mp (each rank
  holds another block; the replicated ones count once), then the whole
  over pp (the stages hold different parameters), and every rank clips by
  that one norm.
- ``HybridParallelGradScaler`` agrees on ``found_inf`` over mp and pp with
  one collective of a flag on the card per group, so an overflow on any
  rank skips the step on every rank.

A group of one rank takes part in nothing here (as the reference's).
Collectives count in ``_collectives.CALLS``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...amp.grad_scaler import GradScaler
from ...nn.clip import ClipGradByGlobalNorm, _payload, _scale, _scaled
from .._collectives import all_reduce_, average_


def _group_pg(group):
    """The process group of a group of more than one rank, else None."""
    pg = getattr(group, "pg", None)
    return pg if pg is not None and group.nranks > 1 else None


class HybridParallelClipGrad:
    """The global-norm clip over the hybrid groups."""

    def __init__(self, clip_norm: float, hcg):
        self.clip_norm = float(clip_norm)
        self._hcg = hcg

    @torch.no_grad()
    def __call__(self, params_grads):
        grads = [(p, _payload(g)) for p, g in params_grads if g is not None]
        if not grads:
            return params_grads
        dev = grads[0][1].device
        dist_sq = torch.zeros((), dtype=torch.float32, device=dev)
        repl_sq = torch.zeros((), dtype=torch.float32, device=dev)
        for p, g in grads:
            sq = torch.sum(torch.square(g.float()))
            if getattr(p, "is_distributed", False):
                dist_sq = dist_sq + sq
            else:
                repl_sq = repl_sq + sq
        hcg = self._hcg
        mp = _group_pg(hcg.get_model_parallel_group())
        if mp is not None:
            all_reduce_(dist_sq, mp)
        total = dist_sq + repl_sq
        pp = _group_pg(hcg.get_pipe_parallel_group())
        if pp is not None:
            all_reduce_(total, pp)
        return _scaled(params_grads,
                       _scale(self.clip_norm, torch.sqrt(total)))


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        clip = getattr(optimizer, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm) and hcg is not None \
                and (hcg.get_model_parallel_world_size() > 1
                     or hcg.get_pipe_parallel_world_size() > 1):
            optimizer._grad_clip = HybridParallelClipGrad(clip.clip_norm,
                                                          hcg)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _replicated_params(self):
        for p in self._inner_opt._all_params():
            if not p.stop_gradient and p._t.grad is not None \
                    and not p.is_distributed:
                yield p

    @torch.no_grad()
    def _sync_replicated_grads(self):
        """Averages the replicated gradients over mp and sep: one flat
        buffer and one collective per gradient type and group."""
        if self._hcg is None:
            return
        for group in (self._hcg.get_model_parallel_group(),
                      self._hcg.get_sep_parallel_group()):
            pg = _group_pg(group)
            if pg is None:
                continue
            by_dtype = {}
            for p in self._replicated_params():
                g = p._t.grad
                by_dtype.setdefault(g.dtype, []).append(g)
            for grads in by_dtype.values():
                average_(grads, pg, group.nranks)

    def step(self):
        self._sync_replicated_grads()
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward, then this wrapper's step (the mp/sep average runs on
        the fresh gradients)."""
        loss.backward()
        self.step()
        return None, None

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)

    @property
    def _learning_rate(self):
        return self._inner_opt._lr


class HybridParallelGradScaler(GradScaler):
    def __init__(self, scaler=None, hcg=None, **kwargs):
        if isinstance(scaler, GradScaler):
            self.__dict__.update(scaler.__dict__)
        else:
            super().__init__(**kwargs)
        self._hcg = hcg

    def unscale_(self, optimizer):
        """The base unscale, then ``found_inf`` agreed over mp and pp: an
        overflow on any rank skips the step on every rank."""
        super().unscale_(optimizer)
        if self._hcg is None or not self._enable:
            return
        flag = None
        for group in (self._hcg.get_model_parallel_group(),
                      self._hcg.get_pipe_parallel_group()):
            pg = _group_pg(group)
            if pg is None:
                continue
            if flag is None:
                dev = next((p._t.device for p in optimizer._all_params()),
                           torch.device("cpu"))
                flag = torch.tensor([float(self._found_inf)], device=dev)
            all_reduce_(flag, pg, op=dist.ReduceOp.MAX)
        if flag is not None:
            self._found_inf = bool(flag.item() > 0)
