"""Counterpart of ``paddle_tpu/incubate/nn``: so far the fused
functionals."""
from . import functional  # noqa: F401

__all__ = ["functional"]
