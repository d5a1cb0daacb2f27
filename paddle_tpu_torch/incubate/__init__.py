"""Counterpart of ``paddle_tpu/incubate``: so far the fused functionals."""
from . import nn  # noqa: F401

__all__ = ["nn"]
