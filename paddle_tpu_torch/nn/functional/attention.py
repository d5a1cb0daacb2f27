"""Dense attention in plain PyTorch, paddle layout ``[batch, seq, heads,
head_dim]``.

Counterpart of ``paddle_tpu/nn/functional/attention.py`` ``_sdpa_kernel``,
which is plain XLA there and is plain PyTorch here (not a kernel of the
port): logits in the io type, a causal mask bottom-right aligned
(``tril(k = Sk - Sq)``), a bool mask filling with -1e30 and a float mask
added, softmax in fp32, probabilities cast back to the io type before P.V.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.cuda.flash_attention import NEG_INF


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                  dropout_p: float = 0.0,
                                  is_causal: bool = False,
                                  training: bool = True,
                                  scale: Optional[float] = None,
                                  name=None) -> torch.Tensor:
    """Inputs ``[batch, seq, heads, head_dim]``; ``attn_mask`` broadcasts
    to ``[batch, heads, Sq, Sk]``. Dropout is not ported yet and raises."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError("attention dropout is not ported yet")
    qh, kh, vh = (t.transpose(1, 2) for t in (query, key, value))
    if scale is None:
        # the reference's 1 / sqrt(d) cast to the io type first
        scale = 1.0 / torch.tensor(math.sqrt(query.shape[-1]),
                                   dtype=query.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, NEG_INF)
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2)
