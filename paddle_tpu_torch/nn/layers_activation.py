"""Activation and loss layers: the counterpart of
``paddle_tpu/nn/layers_activation.py``."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Silu", "Swish",
           "Mish", "LeakyReLU", "ELU", "Hardswish", "Hardsigmoid",
           "Softplus", "LogSoftmax", "Softmax", "CrossEntropyLoss",
           "MSELoss", "L1Loss", "NLLLoss", "BCEWithLogitsLoss"]


def _act_layer(name, fn):
    """A layer that calls ``fn(x, *args, **kwargs)`` with the arguments
    it was made with (``name`` dropped)."""
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._args = args
            self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Silu = _act_layer("Silu", F.silu)
Swish = Silu
Mish = _act_layer("Mish", F.mish)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)
ELU = _act_layer("ELU", F.elu)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Softplus = _act_layer("Softplus", F.softplus)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


# ------------------------------------------------------------------ losses

class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)
