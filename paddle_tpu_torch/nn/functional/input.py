"""``embedding``: the counterpart of ``paddle_tpu/nn/functional/input.py``."""
from __future__ import annotations

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
