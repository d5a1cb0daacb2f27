"""Counterpart of ``paddle_tpu/optimizer``: SGD, Momentum, Adam, AdamW and
the learning-rate schedulers (``optimizer.lr``)."""
from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
