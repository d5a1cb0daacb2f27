"""Flash-attention functionals in paddle's signatures.

Counterpart of ``paddle_tpu/nn/functional/flash_attention.py``:
``flash_attention`` and ``flash_attn_qkvpacked`` go to the fixed-length
kernels (``ops/cuda/flash_attention.py``), ``flash_attn_unpadded`` to the
varlen kernels (``ops/cuda/flash_varlen.py``), and
``flash_attn_unpadded_dense`` is the dense segment-mask oracle.

Unlike the reference, nothing here falls back: the kernels mask ragged
edges themselves, so any sequence length runs on them, and a kernel error
raises instead of switching to the dense path. Dropout and
``return_softmax`` are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ...ops.cuda.flash_attention import mha_forward
from ...ops.cuda.flash_varlen import flash_attn_varlen
from .attention import scaled_dot_product_attention


def _not_ported(dropout: float, return_softmax: bool,
                training: bool) -> None:
    if dropout > 0.0 and training:
        raise NotImplementedError("attention dropout is not ported yet")
    if return_softmax:
        raise NotImplementedError("return_softmax=True is not ported yet")


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """Inputs ``[batch, seq, heads, head_dim]``; returns ``(out, None)``
    like the reference."""
    _not_ported(dropout, return_softmax, training)
    out = mha_forward(query.transpose(1, 2), key.transpose(1, 2),
                      value.transpose(1, 2), causal)
    return out.transpose(1, 2), None


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """``qkv``: ``[batch, seq, 3, heads, head_dim]``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout, causal, return_softmax, training=training)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention on packed ``[total_tokens, heads, head_dim]`` with
    ``cu_seqlens``; ``max_seqlen_q/k`` are taken and ignored, as in the
    reference. Returns ``(out, None)``."""
    _not_ported(dropout, return_softmax, training)
    return flash_attn_varlen(query, key, value, cu_seqlens_q, cu_seqlens_k,
                             scale=scale, causal=causal), None


def _segments(cu: torch.Tensor, t: int) -> torch.Tensor:
    """Segment id per token, as the reference's dense path counts them:
    tokens at or past ``cu[-1]`` join the last segment."""
    starts = cu[1:-1].long()
    marks = torch.zeros(t, dtype=torch.long, device=cu.device)
    marks.index_add_(0, starts[starts < t], torch.ones_like(starts[starts < t]))
    return marks.cumsum(0)


def flash_attn_unpadded_dense(query, key, value, cu_seqlens_q, cu_seqlens_k,
                              max_seqlen_q, max_seqlen_k, scale,
                              dropout=0.0, causal=False, training=True):
    """Dense segment-mask path (O(T^2): a test oracle). A row that sees no
    key gets the mean of v here, where the kernels give 0."""
    tq, tk = query.shape[0], key.shape[0]
    seg_q, seg_k = _segments(cu_seqlens_q, tq), _segments(cu_seqlens_k, tk)
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(tq, device=query.device) - cu_seqlens_q[seg_q]
        pos_k = torch.arange(tk, device=key.device) - cu_seqlens_k[seg_k]
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    out = scaled_dot_product_attention(
        query.unsqueeze(0), key.unsqueeze(0), value.unsqueeze(0),
        mask[None, None], dropout, False, training, scale=scale)
    return out.squeeze(0), None
