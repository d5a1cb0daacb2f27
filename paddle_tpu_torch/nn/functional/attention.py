"""Dense attention in plain PyTorch, paddle layout ``[batch, seq, heads,
head_dim]``.

Counterpart of ``paddle_tpu/nn/functional/attention.py`` ``_sdpa_kernel``,
which is plain XLA there and is plain PyTorch here (not a kernel of the
port): logits in the io type, a causal mask bottom-right aligned
(``tril(k = Sk - Sq)``), a bool mask filling with -1e30 and a float mask
added, softmax in fp32, probabilities cast back to the io type before P.V.
In training with ``dropout_p > 0`` each probability is kept with
probability ``1 - dropout_p`` and scaled by ``1 / (1 - dropout_p)``, the
mask drawn from the device's generator (``_core/random.py``), as the
reference draws it from its global key: the same law, not the same
numbers.

It is the registered op ``sdpa`` (AMP's white list), called through the
dispatch, so that O1 runs it in the low type. Called with torch tensors
(the flash entries' dense oracles do) it returns torch tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..._core import random as rnd
from ..._core.dispatch import apply
from ..._core.op_registry import register_op
from ...ops.cuda.flash_attention import NEG_INF


@register_op("sdpa")
def _sdpa(q, k, v, mask=None, dropout_key=None, *, dropout_p, causal, scale,
          training):
    """``dropout_key``: the generator the dropout mask is drawn from (the
    device's when None), in the place of the reference's key."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if scale is None:
        # the reference's 1 / sqrt(d) cast to the io type first
        scale = 1.0 / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        gen = dropout_key if dropout_key is not None else \
            rnd.generator(probs.device)
        keep = torch.rand(probs.shape, generator=gen,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            probs.new_zeros(()))
    return torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                  dropout_p: float = 0.0,
                                  is_causal: bool = False,
                                  training: bool = True,
                                  scale: Optional[float] = None,
                                  name=None):
    """Inputs ``[batch, seq, heads, head_dim]``; ``attn_mask`` broadcasts
    to ``[batch, heads, Sq, Sk]``."""
    return apply("sdpa", _sdpa, query, key, value, attn_mask, None,
                 dropout_p=float(dropout_p), causal=bool(is_causal),
                 scale=scale, training=bool(training))
