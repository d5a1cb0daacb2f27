"""Counterpart of ``paddle_tpu/incubate/nn``: the fused functionals and
the fused layers."""
from . import functional  # noqa: F401
from .layers import (FusedFeedForward, FusedLinear,  # noqa: F401
                     FusedMultiHeadAttention,
                     FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedLinear", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer"]
