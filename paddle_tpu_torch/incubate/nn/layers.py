"""The fused layers of ``incubate.nn``: the counterpart of
``paddle_tpu/incubate/nn/layers.py`` (``FusedLinear``,
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``).

The parameters are the reference's, name for name and shape for shape, so
its ``state_dict`` loads with ``set_state_dict``. That layout is the
reference's own, not Paddle's: ``qkv_weight`` is ``[embed, 3 * embed]``
(Paddle's is ``[3, heads, head_dim, embed]``), and each of the attention
and the feed-forward block keeps one ``LayerNorm``, ``ln``, which it
applies before the block when ``normalize_before`` and after the residual
otherwise. Attention is the dense ``sdpa`` op (AMP's white list: bf16
under O1), as in the reference; nothing here is a kernel.

What the reference takes and ignores raises ``NotImplementedError`` here:
``need_weights=True``, a ``cache``, ``nranks > 1``, ``kdim`` / ``vdim``
other than ``embed_dim``, the separate LayerNorm attrs
(``pre_ln_*``, ``ln_*``, ``ln1_*``, ``ln2_*``) and the encoder layer's
``weight_attr`` / ``bias_attr``.
"""
from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer, create_parameter
from ...ops.manipulation import reshape, transpose

__all__ = ["FusedLinear", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]


def _refuse(layer: str, **given) -> None:
    """Raises for the first option that was given (not None)."""
    for what, value in given.items():
        if value is not None:
            raise NotImplementedError(
                f"{layer}: {what} is not ported (the reference takes it "
                f"and ignores it)")


class FusedLinear(Layer):
    """``x @ W + b``; W ``[in, out]``, or ``[out, in]`` with
    ``transpose_weight``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight else \
            [in_features, out_features]
        self.weight = create_parameter(
            shape, attr=weight_attr, default_initializer=I.XavierNormal())
        self.bias = create_parameter([out_features], attr=bias_attr,
                                     is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        w = transpose(self.weight, [1, 0]) if self.transpose_weight \
            else self.weight
        return F.linear(x, w, self.bias)


class FusedMultiHeadAttention(Layer):
    """Self-attention with its residual: (LayerNorm,) the qkv product, the
    dense SDPA, the output product, dropout, the residual (, LayerNorm)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        name_ = "FusedMultiHeadAttention"
        if need_weights:
            raise NotImplementedError(f"{name_}: need_weights=True is not "
                                      f"ported (the reference ignores it)")
        if nranks > 1:
            raise NotImplementedError(f"{name_}: nranks > 1 is not ported "
                                      f"(the reference ignores it)")
        for what, dim in (("kdim", kdim), ("vdim", vdim)):
            if dim is not None and dim != embed_dim:
                raise NotImplementedError(
                    f"{name_}: {what}={dim} other than embed_dim is not "
                    f"ported (the reference ignores it)")
        _refuse(name_, pre_ln_scale_attr=pre_ln_scale_attr,
                pre_ln_bias_attr=pre_ln_bias_attr,
                ln_scale_attr=ln_scale_attr, ln_bias_attr=ln_bias_attr)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.qkv_weight = create_parameter(
            [embed_dim, 3 * embed_dim], attr=qkv_weight_attr,
            default_initializer=I.XavierNormal())
        self.qkv_bias = create_parameter([3 * embed_dim],
                                         attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr,
            default_initializer=I.XavierNormal())
        self.linear_bias = create_parameter([embed_dim],
                                            attr=linear_bias_attr,
                                            is_bias=True)
        self.ln = nn.LayerNorm(embed_dim, epsilon=epsilon)

    def forward(self, x, attn_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("FusedMultiHeadAttention: a cache is "
                                      "not ported (the reference ignores "
                                      "it)")
        residual = x
        if self.normalize_before:
            x = self.ln(x)
        b, s = x.shape[0], x.shape[1]
        qkv = reshape(F.linear(x, self.qkv_weight, self.qkv_bias),
                      [b, s, 3, self.num_heads, self.head_dim])
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask, self.attn_dropout_rate, False,
            self.training)
        out = reshape(out, [b, s, self.embed_dim])
        out = F.linear(out, self.linear_weight, self.linear_bias)
        out = F.dropout(out, self.dropout_rate, training=self.training)
        out = residual + out
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(Layer):
    """The feed-forward block with its residual: (LayerNorm,) linear1,
    the activation, dropout, linear2, dropout, the residual (,
    LayerNorm)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        if nranks > 1:
            raise NotImplementedError("FusedFeedForward: nranks > 1 is not "
                                      "ported (the reference ignores it)")
        _refuse("FusedFeedForward", ln1_scale_attr=ln1_scale_attr,
                ln1_bias_attr=ln1_bias_attr, ln2_scale_attr=ln2_scale_attr,
                ln2_bias_attr=ln2_bias_attr)
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = act_dropout_rate if act_dropout_rate \
            is not None else dropout_rate
        self.activation = activation
        self.linear1 = nn.Linear(d_model, dim_feedforward,
                                 weight_attr=linear1_weight_attr,
                                 bias_attr=linear1_bias_attr)
        self.linear2 = nn.Linear(dim_feedforward, d_model,
                                 weight_attr=linear2_weight_attr,
                                 bias_attr=linear2_bias_attr)
        self.ln = nn.LayerNorm(d_model, epsilon=epsilon)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = self.ln(x)
        h = getattr(F, self.activation)(self.linear1(x))
        h = F.dropout(h, self.act_dropout_rate, training=self.training)
        h = self.linear2(h)
        h = F.dropout(h, self.dropout_rate, training=self.training)
        out = residual + h
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        _refuse("FusedTransformerEncoderLayer", weight_attr=weight_attr,
                bias_attr=bias_attr)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead,
            dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate if attn_dropout_rate
            is not None else dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError("FusedTransformerEncoderLayer: a cache "
                                      "is not ported (the reference ignores "
                                      "it)")
        return self.ffn(self.fused_attn(src, src_mask))
