"""Counterpart of ``paddle_tpu/nn``: so far the attention functionals."""
from . import functional  # noqa: F401
