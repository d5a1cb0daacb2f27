"""Counterpart of ``paddle_tpu/optimizer``: SGD, Adam and AdamW."""
from .optimizer import SGD, Adam, AdamW, Optimizer  # noqa: F401
