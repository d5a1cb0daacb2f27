"""Flash-attention functionals in paddle's signatures.

Counterpart of ``paddle_tpu/nn/functional/flash_attention.py``:

=============================  ==========================================
functional                     goes to
=============================  ==========================================
``flash_attention``,           the fixed-length kernels
``flash_attn_qkvpacked``       (``ops/cuda/flash_attention.py``)
``flash_attn_unpadded``        the varlen kernels
                               (``ops/cuda/flash_varlen.py``)
``flashmask_attention``        the flashmask kernels (same module); with
                               ``startend_row_indices=None``, the
                               fixed-length kernels, causal bottom-right
``flash_attn_unpadded_dense``  dense segment-mask oracle (plain torch)
``flashmask_attention_dense``  dense start/end-mask oracle (plain torch)
=============================  ==========================================

``flash_attention`` and ``flash_attn_qkvpacked`` take the eager API's
``Tensor``s through the registered op ``flash_attention``, called by name
as the reference calls it (on no AMP list: q, k and v keep the type they
come in). Unlike the reference, nothing here
falls back: the kernels mask ragged
edges themselves, so any sequence length runs on them, and a kernel error
raises instead of switching to the dense path. Dropout,
``return_softmax``, and flashmask's ``window_size``,
``return_softmax_lse`` and ``return_seed_offset`` are not ported yet and
raise ``NotImplementedError`` (the reference ignores the last three).
"""
from __future__ import annotations

import torch

from ..._core.op_registry import call
from ...ops.cuda.flash_varlen import (flash_attn_varlen,
                                      flashmask_attention_kernel)
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
    """Inputs ``[batch, seq, heads, head_dim]`` (``Tensor``s or torch
    tensors); returns ``(out, None)`` like the reference. Any sequence
    length goes to the kernels."""
    _not_ported(dropout, return_softmax, training)
    return call("flash_attention", query, key, value, causal=bool(causal),
                scale=None), None


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


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=True, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Sparse-mask attention (paddle's ``flashmask_attention``) on
    ``[batch, seq, heads, head_dim]``; ``startend_row_indices`` ``[batch,
    1 or heads, seq_k, 1 or 2]`` int32/int64 bans, for key column ``j``,
    the query rows ``[start_j, end_j)`` (``end`` = no limit with one
    column). Returns ``out`` alone, as the reference does."""
    _not_ported(dropout, False, training)
    for what, given in (("window_size", window_size is not None),
                        ("return_softmax_lse=True", return_softmax_lse),
                        ("return_seed_offset=True", return_seed_offset)):
        if given:
            raise NotImplementedError(f"flashmask_attention: {what} is not "
                                      f"ported yet")
    if startend_row_indices is None:
        return flash_attention(query, key, value, causal=causal)[0]
    return flashmask_attention_kernel(query, key, value,
                                      startend_row_indices, causal=causal)


def _flashmask_to_dense(startend, causal):
    """[B, 1 or H, S, S] bool ``allow`` mask of the reference's dense path:
    key column j is banned for query rows >= start_j (and < end_j with two
    columns); causal bans k > q. Square: S is ``startend``'s key length."""
    s = startend.shape[2]
    q_idx = torch.arange(s, device=startend.device)[None, None, :, None]
    k_idx = torch.arange(s, device=startend.device)[None, None, None, :]
    ban = q_idx >= startend[..., 0][:, :, None, :]
    if startend.shape[-1] > 1:
        ban = ban & (q_idx < startend[..., 1][:, :, None, :])
    if causal:
        ban = ban | (k_idx > q_idx)
    return ~ban


def flashmask_attention_dense(query, key, value, startend_row_indices=None,
                              dropout=0.0, causal=True, training=True,
                              *unused, **unused_kw):
    """Dense-mask path (O(S^2) memory: a test oracle). A row that sees no
    key gets the mean of v here, where the kernels give 0."""
    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value, None, dropout,
                                            causal, training)
    mask = _flashmask_to_dense(startend_row_indices, causal)
    return scaled_dot_product_attention(query, key, value, mask, dropout,
                                        False, training)
