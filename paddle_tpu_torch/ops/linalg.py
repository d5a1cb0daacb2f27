"""Matrix products: the counterpart of ``paddle_tpu/ops/linalg.py``."""
from __future__ import annotations

import torch

from .._core.dispatch import apply


def promote(x: torch.Tensor, y: torch.Tensor):
    """Both operands at ``promote_types`` of their types (the reference's
    products promote; torch's refuse mixed types)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _matmul(x, y, transpose_x, transpose_y):
    x, y = promote(x, y)
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return apply("matmul", _matmul, x, y, transpose_x=bool(transpose_x),
                 transpose_y=bool(transpose_y))
