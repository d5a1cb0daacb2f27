"""Optimizers: the counterpart of ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``,
``RMSProp``, ``Adadelta``, ``Adamax``, ``Lamb``).

Plain PyTorch, as the reference's update is plain XLA: one ``step`` runs
``torch._foreach_*`` ops over each (parameter group, type) bucket and
updates the parameters in place. It lands the lazy window first and counts
as one execution (``dispatch.exec_count``); as the reference donates the
old buffers, no step copies a parameter (each ``data_ptr()`` stays) and a
buffer tied into two places is updated once. The arithmetic is the
reference's ``_update_one``: the bias corrections are computed in float32
and cast to the parameter's type, AdamW's decay sits inside the
learning-rate product (``p - lr * (upd + wd * p)``), the others add L2
decay into the gradient first, and the learning rate is a float32 scalar:
a float, or an ``LRScheduler`` read at every step. A ``grad_clip``
(``nn/clip.py``) rewrites the gradients first. With ``multi_precision`` a
bf16 or fp16 parameter is updated through a float32 master copy and
float32 state. ``Lamb``'s per-parameter norms and trust ratios stay on the
device: no step reads anything back.

Two options the reference accepts and ignores are applied here, as Paddle
defines them: AdamW's ``lr_ratio(param)`` multiplies that parameter's
learning rate, and Lamb's ``exclude_from_weight_decay_fn(param)`` exempts
a parameter from the decay (each by splitting the parameter groups).

While a telemetry plane is on, the update runs in an
``optimizer::fused_step`` span (``optimizer.step_us``) and counts
``optimizer.steps`` and ``optimizer.donated_steps`` (the update writes in
place, as the reference's donated update does); with the memory plane on,
a master weight made at the first step enters the census as
``optimizer.master``.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch

from .._core import dispatch, lazy
from .._core.tensor import Tensor
from ..observability import _state as _OBS
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb"]

_LOW = (torch.bfloat16, torch.float16)


def _coeff(wd) -> float:
    if wd is None:
        return 0.0
    return float(getattr(wd, "_coeff", wd))  # an L2Decay or a number


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided in dygraph mode")
        self._grad_clip = grad_clip
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._multi_precision = multi_precision
        self._step_count = 0
        self._states: Dict[int, Dict[str, torch.Tensor]] = {}
        self._master: Dict[int, torch.Tensor] = {}
        default_wd = _coeff(weight_decay)
        params = list(parameters)
        if params and isinstance(params[0], dict):
            self._param_groups = [{
                "params": list(g["params"]),
                "learning_rate": float(g.get("learning_rate", 1.0)),
                "weight_decay": default_wd if g.get("weight_decay") is None
                else _coeff(g["weight_decay"])} for g in params]
        else:
            self._param_groups = [{"params": params, "learning_rate": 1.0,
                                   "weight_decay": default_wd}]

    # -------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._lr = scheduler

    # -------------------------------------------------------------- step
    def _all_params(self) -> List[Tensor]:
        return [p for g in self._param_groups for p in g["params"]]

    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _split_groups(self, key, value_of):
        """Splits every parameter group by ``value_of(param)`` (None: the
        group as it is), setting ``key`` of each new group from it."""
        groups = []
        for grp in self._param_groups:
            parts = collections.OrderedDict()
            for p in grp["params"]:
                parts.setdefault(value_of(grp, p), []).append(p)
            for v, ps in parts.items():
                g = dict(grp, params=ps)
                if v is not None:
                    g[key] = v
                groups.append(g)
        self._param_groups = groups

    def _bias_correction(self, beta) -> float:
        """``1 - beta ** t`` in float32, as the reference (t a float32
        scalar)."""
        t = np.float32(self._step_count)
        return float(np.float32(1) - np.float32(beta) ** t)

    def _update(self, ps, gs, states, lr, wd) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> None:
        # the update writes parameter and state payloads in place: a pending
        # segment that reads them runs first (and in-flight async ones)
        lazy.flush_active("optimizer")
        lazy._drain_async()
        pairs, groups, seen = [], [], set()
        for gi, g in enumerate(self._param_groups):
            for p in g["params"]:
                if p.stop_gradient or p._t.grad is None:
                    continue
                if id(p._t) in seen:  # a tied buffer is written once
                    continue
                seen.add(id(p._t))
                pairs.append((p, p._t.grad))
                groups.append(gi)
        if not pairs:
            return
        if not _OBS.ACTIVE:
            return self._step(pairs, groups)
        if _OBS.METRICS:
            from ..observability import metrics
            metrics.inc("optimizer.steps")
            metrics.inc("optimizer.donated_steps")
        from ..observability.spans import span
        with span("optimizer::fused_step", hist="optimizer.step_us",
                  params=len(pairs), donated=True):
            self._step(pairs, groups)

    def _step(self, pairs, groups) -> None:
        dispatch.bump_exec()  # the whole update is one execution
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        buckets = collections.defaultdict(list)
        for gi, (p, g) in zip(groups, pairs):
            g = g._t if isinstance(g, Tensor) else g
            buckets[(gi, p._t.dtype, p._t.device)].append((p, g))
        self._step_count += 1
        lr32 = np.float32(self.get_lr())
        for (gi, dtype, _), items in buckets.items():
            group = self._param_groups[gi]
            master = self._multi_precision and dtype in _LOW
            params = [p for p, _ in items]
            ps, gs, states = [], [], []
            for p, g in items:
                pid = id(p)
                if pid not in self._states:
                    if master:
                        self._master[pid] = p._t.detach().float()
                    self._states[pid] = self._init_state(
                        self._master.get(pid, p._t))
                    if _OBS.MEM:
                        self._note_state(pid)
                ps.append(self._master.get(pid, p._t))
                gs.append(g if g.dtype == ps[-1].dtype else g.to(ps[-1].dtype))
                states.append(self._states[pid])
            lr = float(lr32 * np.float32(group["learning_rate"]))
            self._update(ps, gs, states, lr, group["weight_decay"])
            if master:
                for p, m in zip(params, ps):
                    p._t.copy_(m)

    def _note_state(self, pid) -> None:
        """The memory plane's census of a parameter's new optimizer state
        (and master weight): raw torch tensors no ``Tensor`` wraps."""
        from ..observability import memory as _memtel
        for v in self._states[pid].values():
            _memtel.note_buffer(v, "optimizer.state")
        if pid in self._master:
            _memtel.note_buffer(self._master[pid], "optimizer.master")

    @torch.no_grad()
    def clear_grad(self, set_to_zero=True) -> None:
        for p in self._all_params():
            p._t.grad = None

    # -------------------------------------------------------------- state
    def _keys(self):
        return [(p.name or f"param_{i}", p)
                for i, p in enumerate(self._all_params())]

    def state_dict(self) -> Dict[str, object]:
        """``{"step": n, "<param name>.<moment>": Tensor, ...}`` and
        ``"<param name>.master"`` for master weights, as the reference."""
        out = {"step": self._step_count}
        for key, p in self._keys():
            for k, v in self._states.get(id(p), {}).items():
                out[f"{key}.{k}"] = Tensor(v)
            if id(p) in self._master:
                out[f"{key}.master"] = Tensor(self._master[id(p)])
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state) -> None:
        from ..nn.layer import _as_torch
        self._step_count = int(state.get("step", 0))
        for key, p in self._keys():
            if f"{key}.master" in state:
                self._master[id(p)] = _as_torch(
                    state[f"{key}.master"], p._t.detach().float())
            st = self._init_state(self._master.get(id(p), p._t))
            found = [k for k in st if f"{key}.{k}" in state]
            for k in found:
                st[k] = _as_torch(state[f"{key}.{k}"], st[k])
            if found:
                self._states[id(p)] = st
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])


class SGD(Optimizer):
    def _update(self, ps, gs, states, lr, wd):
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        torch._foreach_add_(ps, gs, alpha=-lr)


class Momentum(Optimizer):
    """``v = mu v + g`` (L2 decay added into g first) and ``p -= lr v``;
    with ``use_nesterov`` ``p -= lr (g + mu v)``. State ``velocity``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, wd):
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        vs = [s["velocity"] for s in states]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        upd = torch._foreach_add(gs, vs, alpha=self._momentum) \
            if self._nesterov else vs
        torch._foreach_add_(ps, upd, alpha=-lr)


class Adam(Optimizer):
    """Adam; with ``amsgrad`` the second moment's running maximum
    (state ``vmax``) divides the update."""
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        self._b1, self._b2, self._eps = float(beta1), float(beta2), \
            float(epsilon)
        self._amsgrad = bool(amsgrad)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        s = {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}
        if self._amsgrad:
            s["vmax"] = torch.zeros_like(p)
        return s

    def _update(self, ps, gs, states, lr, wd):
        b1, b2, eps = self._b1, self._b2, self._eps
        if wd and not self._decoupled:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        ms = [s["m"] for s in states]
        vs = [s["v"] for s in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        if self._amsgrad:
            vs = [s["vmax"] for s in states]
            torch._foreach_maximum_(vs, [s["v"] for s in states])
        denom = torch._foreach_div(vs, self._bias_correction(b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(ms, self._bias_correction(b1))
        torch._foreach_div_(upd, denom)
        if wd and self._decoupled:
            torch._foreach_add_(upd, ps, alpha=wd)
        torch._foreach_add_(ps, upd, alpha=-lr)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01);
    ``apply_decay_param_fun(name)`` False exempts a parameter from it."""
    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad, name)
        if apply_decay_param_fun is not None:
            for grp in list(self._param_groups):
                keep = [p for p in grp["params"]
                        if apply_decay_param_fun(p.name)]
                drop = [p for p in grp["params"]
                        if not apply_decay_param_fun(p.name)]
                if drop and keep:
                    grp["params"] = keep
                    self._param_groups.append({
                        "params": drop, "weight_decay": 0.0,
                        "learning_rate": grp["learning_rate"]})
                elif drop:
                    grp["weight_decay"] = 0.0
        if lr_ratio is not None:
            self._split_groups("learning_rate", lambda grp, p: float(
                np.float32(grp["learning_rate"])
                * np.float32(lr_ratio(p))))


class Adagrad(Optimizer):
    """``acc += g^2``, ``p -= lr g / (sqrt(acc) + eps)``; state ``acc``
    from ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        self._eps = float(epsilon)
        self._init_acc = float(initial_accumulator_value)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        return {"acc": torch.full_like(p, self._init_acc)}

    def _update(self, ps, gs, states, lr, wd):
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        accs = [s["acc"] for s in states]
        torch._foreach_addcmul_(accs, gs, gs)
        denom = torch._foreach_sqrt(accs)
        torch._foreach_add_(denom, self._eps)
        upd = torch._foreach_mul(gs, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2``; centered: ``mg = rho mg + (1 -
    rho) g`` and the denominator ``sqrt(ms - mg^2 + eps)``, else ``sqrt(ms
    + eps)``; ``mom = momentum mom + lr g / denom``, ``p -= mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        self._rho, self._eps = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        s = {"ms": torch.zeros_like(p), "mom": torch.zeros_like(p)}
        if self._centered:
            s["mg"] = torch.zeros_like(p)
        return s

    def _update(self, ps, gs, states, lr, wd):
        rho = self._rho
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        mss = [s["ms"] for s in states]
        torch._foreach_mul_(mss, rho)
        torch._foreach_add_(mss, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - rho), gs))
        if self._centered:
            mgs = [s["mg"] for s in states]
            torch._foreach_mul_(mgs, rho)
            torch._foreach_add_(mgs, torch._foreach_mul(gs, 1 - rho))
            denom = torch._foreach_sub(mss, torch._foreach_mul(mgs, mgs))
            torch._foreach_add_(denom, self._eps)
        else:
            denom = torch._foreach_add(mss, self._eps)
        torch._foreach_sqrt_(denom)
        moms = [s["mom"] for s in states]
        torch._foreach_mul_(moms, self._momentum)
        upd = torch._foreach_mul(gs, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(moms, upd)
        torch._foreach_sub_(ps, moms)


class Adadelta(Optimizer):
    """``avg_sq = rho avg_sq + (1 - rho) g^2``, ``dx = sqrt((avg_dx + eps)
    / (avg_sq + eps)) g``, ``avg_dx = rho avg_dx + (1 - rho) dx^2``, ``p -=
    lr dx``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        self._rho, self._eps = float(rho), float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        return {"avg_sq": torch.zeros_like(p), "avg_dx": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, wd):
        rho, eps = self._rho, self._eps
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        sqs = [s["avg_sq"] for s in states]
        dxs = [s["avg_dx"] for s in states]
        torch._foreach_mul_(sqs, rho)
        torch._foreach_add_(sqs, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - rho), gs))
        dx = torch._foreach_add(dxs, eps)
        torch._foreach_div_(dx, torch._foreach_add(sqs, eps))
        torch._foreach_sqrt_(dx)
        torch._foreach_mul_(dx, gs)
        torch._foreach_mul_(dxs, rho)
        torch._foreach_add_(dxs, torch._foreach_mul(
            torch._foreach_mul(dx, 1 - rho), dx))
        torch._foreach_mul_(dx, lr)
        torch._foreach_sub_(ps, dx)


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``, ``p -= lr m /
    ((1 - b1^t) (u + eps))``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        self._b1, self._b2, self._eps = float(beta1), float(beta2), \
            float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, wd):
        b1 = self._b1
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        ms = [s["m"] for s in states]
        us = [s["u"] for s in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(us, self._b2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        denom = torch._foreach_add(us, self._eps)
        torch._foreach_mul_(denom, self._bias_correction(b1))
        upd = torch._foreach_div(ms, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(ps, upd)


class Lamb(Optimizer):
    """Adam's direction ``r = m_hat / (sqrt(v_hat) + eps) + wd p``, scaled
    per parameter by the trust ratio ``|p| / |r|`` (1 where either norm is
    0): ``p -= (lr trust) r``. The norms (``torch._foreach_norm``) and the
    ratios stay on the device."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        self._b1, self._b2, self._eps = float(beta1), float(beta2), \
            float(epsilon)
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)
        if exclude_from_weight_decay_fn is not None:
            self._split_groups("weight_decay", lambda grp, p: 0.0 if
                               exclude_from_weight_decay_fn(p) else None)

    def _init_state(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, wd):
        b1, b2 = self._b1, self._b2
        ms = [s["m"] for s in states]
        vs = [s["v"] for s in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        denom = torch._foreach_div(vs, self._bias_correction(b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._eps)
        r = torch._foreach_div(ms, self._bias_correction(b1))
        torch._foreach_div_(r, denom)
        if wd:
            torch._foreach_add_(r, ps, alpha=wd)
        w_norm = torch.stack(torch._foreach_norm(ps))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        torch._foreach_mul_(r, list((trust * lr).to(ps[0].dtype).unbind(0)))
        torch._foreach_sub_(ps, r)
