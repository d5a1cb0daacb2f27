"""``LBFGS``: the counterpart of ``paddle_tpu/optimizer/lbfgs.py``.

Limited-memory BFGS over all parameters flattened into one vector: the
two-loop recursion over the last ``history_size`` (s, y) pairs, then a
backtracking line search on the closure (halving the step from the
learning rate, at most 10 trials, Armijo constant 1e-4). The history, the
direction and the line search's arithmetic are float32 tensors on the
parameters' device (the reference keeps numpy arrays on the host); the
host reads only the Python bools its stopping and acceptance tests need.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .._core import lazy
from .optimizer import Optimizer


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._prev_flat: Optional[torch.Tensor] = None
        self._prev_grad: Optional[torch.Tensor] = None

    def _gather(self):
        """(the parameters, their gradients) flattened into one vector
        each (a missing gradient counts as zeros)."""
        ps = self._all_params()
        flat = torch.cat([p._t.detach().reshape(-1) for p in ps])
        grad = torch.cat([torch.zeros_like(p._t).reshape(-1)
                          if p._t.grad is None else p._t.grad.reshape(-1)
                          for p in ps])
        return flat, grad

    @torch.no_grad()
    def _scatter(self, flat):
        # written in place: a pending segment that reads them runs first
        lazy.flush_active("optimizer")
        ofs = 0
        for p in self._all_params():
            n = p._t.numel()
            p._t.copy_(flat[ofs:ofs + n].reshape(p._t.shape))
            ofs += n

    def _direction(self, grad):
        """The two-loop recursion over the (s, y) history."""
        q = grad.clone()
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.clamp(y @ s, min=1e-10)
            a = rho * (s @ q)
            alphas.append((a, rho, s, y))
            q -= a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q *= (s @ y) / torch.clamp(y @ y, min=1e-10)
        for a, rho, s, y in reversed(alphas):
            b = rho * (y @ q)
            q += (a - b) * s
        return -q

    def step(self, closure: Optional[Callable] = None):
        """``closure()`` re-evaluates the model and its gradients and
        returns the loss ``Tensor``."""
        if closure is None:
            raise ValueError("LBFGS.step needs a closure returning the "
                             "loss")
        loss = closure()
        for _ in range(self.max_iter):
            flat, grad = self._gather()
            if bool(grad.abs().max() <= self.tolerance_grad):
                break
            if self._prev_flat is not None:
                s = flat - self._prev_flat
                y = grad - self._prev_grad
                if bool(y @ s > 1e-10):
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self.history_size:
                        self._s.pop(0)
                        self._y.pop(0)
            d = self._direction(grad)
            self._prev_flat, self._prev_grad = flat.clone(), grad.clone()
            t = self.get_lr()
            f0 = loss._t.detach().reshape(()).to(torch.float32)
            gtd = grad @ d
            for _ in range(10):
                self._scatter(flat + t * d)
                self.clear_grad()
                loss = closure()
                f = loss._t.detach().reshape(()).to(torch.float32)
                if bool(f <= f0 + 1e-4 * t * gtd):
                    break
                t *= 0.5
            if bool((t * d).abs().max() <= self.tolerance_change):
                break
        self._step_count += 1
        return loss
