"""Counterpart of ``paddle_tpu/optimizer``: SGD, Momentum, Adam, AdamW,
Adagrad, RMSProp, Adadelta, Adamax, Lamb, LBFGS and the learning-rate
schedulers (``optimizer.lr``)."""
from . import lr  # noqa: F401
from .lbfgs import LBFGS  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, Lamb, Momentum, Optimizer, RMSProp)
