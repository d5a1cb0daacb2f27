"""``embedding`` and ``one_hot``: the counterpart of
``paddle_tpu/nn/functional/input.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..._core.dispatch import apply
from ..._core.op_registry import register_op


@register_op("embedding")
def _embedding(w, ids, padding_idx):
    out = tF.embedding(ids, w)
    if padding_idx >= 0:  # as the reference: the row reads as 0
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [vocab, dim] at the ids ``x``; a ``padding_idx``
    id gives a row of zeros (and no gradient)."""
    return apply("embedding", _embedding, weight, x,
                 padding_idx=-1 if padding_idx is None else int(padding_idx))


@register_op("one_hot_k")
def _one_hot(x, num_classes):
    """float32 rows; an id outside [0, num_classes) gives a row of zeros,
    as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def one_hot(x, num_classes, name=None):
    return apply("one_hot_k", _one_hot, x, num_classes=int(num_classes))
