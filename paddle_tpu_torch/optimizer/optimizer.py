"""Optimizers: the counterpart of ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer``, ``SGD``, ``Adam``, ``AdamW``).

Plain PyTorch, as the reference's update is plain XLA: one ``step`` runs
``torch._foreach_*`` ops over each (parameter group, type) bucket and
updates the parameters in place. The arithmetic is the reference's
``_update_one``: the bias corrections are computed in float32 and cast to
the parameter's type, AdamW's decay sits inside the learning-rate product
(``p - lr * (upd + wd * p)``), and the learning rate is a float32 scalar.
With ``multi_precision`` a bf16 or fp16 parameter is updated through a
float32 master copy and float32 moments.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch

from .._core.tensor import Tensor

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]

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
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("learning-rate schedulers are not "
                                      "ported yet: pass a float")
        self._lr = float(learning_rate)
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
        return self._lr

    def set_lr(self, value) -> None:
        self._lr = float(value)

    # -------------------------------------------------------------- step
    def _all_params(self) -> List[Tensor]:
        return [p for g in self._param_groups for p in g["params"]]

    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, ps, gs, states, lr, wd) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> None:
        buckets = collections.defaultdict(list)
        for gi, g in enumerate(self._param_groups):
            for p in g["params"]:
                if p.stop_gradient or p._t.grad is None:
                    continue
                buckets[(gi, p._t.dtype, p._t.device)].append(p)
        if not buckets:
            return
        self._step_count += 1
        lr32 = np.float32(self._lr)
        for (gi, dtype, _), params in buckets.items():
            group = self._param_groups[gi]
            master = self._multi_precision and dtype in _LOW
            ps, gs, states = [], [], []
            for p in params:
                pid = id(p)
                if pid not in self._states:
                    if master:
                        self._master[pid] = p._t.detach().float()
                    self._states[pid] = self._init_state(
                        self._master.get(pid, p._t))
                ps.append(self._master.get(pid, p._t))
                g = p._t.grad
                gs.append(g if g.dtype == ps[-1].dtype else g.to(ps[-1].dtype))
                states.append(self._states[pid])
            lr = float(lr32 * np.float32(group["learning_rate"]))
            self._update(ps, gs, states, lr, group["weight_decay"])
            if master:
                for p, m in zip(params, ps):
                    p._t.copy_(m)

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


class SGD(Optimizer):
    def _update(self, ps, gs, states, lr, wd):
        if wd:
            gs = torch._foreach_add(gs, ps, alpha=wd)
        torch._foreach_add_(ps, gs, alpha=-lr)


class Adam(Optimizer):
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        if amsgrad:
            raise NotImplementedError("amsgrad is not ported yet")
        self._b1, self._b2, self._eps = float(beta1), float(beta2), \
            float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

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
        # 1 - beta ** t in float32, as the reference (t a float32 scalar)
        t = np.float32(self._step_count)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(ms, bc1)
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
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
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
