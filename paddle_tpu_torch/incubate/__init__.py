"""Counterpart of ``paddle_tpu/incubate``: the fused layers and
functionals (``incubate.nn``) and the segment reductions
(``ops/segment.py``). ``asp`` and ``incubate.distributed`` are not
ported yet."""
from . import nn  # noqa: F401
from ..ops.segment import (segment_max, segment_mean,  # noqa: F401
                           segment_min, segment_sum)

__all__ = ["nn", "segment_sum", "segment_mean", "segment_max",
           "segment_min"]
