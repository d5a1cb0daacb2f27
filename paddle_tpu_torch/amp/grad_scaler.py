"""GradScaler: the counterpart of ``paddle_tpu/amp/grad_scaler.py``.

As in the reference: with ``enable`` the loss is multiplied by the scale
and the gradients divided by it before the step, which is skipped when a
gradient is not finite (and the scale then lowered). For bf16 the scale is
a power of two and the fp32 gradients come out as they would unscaled, so
the scaler changes nothing there; for fp16 it keeps small gradients from
flushing to 0.
"""
from __future__ import annotations

import torch

INIT_LOSS_SCALING = 65536.0      # the reference's FLAGS_amp_init_loss_scaling
INCR_EVERY_N_STEPS = 2000        # FLAGS_amp_incr_every_n_steps
DECR_EVERY_N_NAN_OR_INF = 1      # FLAGS_amp_decr_every_n_nan_or_inf


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=INIT_LOSS_SCALING,
                 incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=INCR_EVERY_N_STEPS,
                 decr_every_n_nan_or_inf=DECR_EVERY_N_NAN_OR_INF,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        return var * self._scale if self._enable else var

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        found_inf = False
        for p in optimizer._all_params():
            g = p._t.grad
            if g is None:
                continue
            g32 = g.float() * inv
            found_inf |= not bool(torch.isfinite(g32).all())
            p._t.grad = g32.to(g.dtype)
        self._found_inf = found_inf

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._dynamic and self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            optimizer.step()
            self._good_steps += 1
            self._bad_steps = 0
            if self._dynamic and self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        pass

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)



AmpScaler = GradScaler
