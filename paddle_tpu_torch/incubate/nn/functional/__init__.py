"""Fused functional ops: the counterpart of
``paddle_tpu/incubate/nn/functional``.

``fused_rms_norm`` runs the port's RMSNorm kernel and ``swiglu`` its SwiGLU
kernel (``ops/cuda/fused.py``, ``csrc/fused.cu``); RoPE, LayerNorm and MoE
are plain PyTorch, as they are plain jnp in the reference. Each takes the
eager API's ``Tensor``s or torch tensors: RMSNorm and SwiGLU are called
as the registered ops ``fused_rms_norm`` and ``fused_swiglu``, RoPE and
MoE through the dispatch under the names ``fused_rope`` and
``fused_moe``, as the reference calls them.
"""
from __future__ import annotations

from ...._core.dispatch import apply
from ...._core.op_registry import call
from ....nn.functional.norm import layer_norm as _layer_norm
from ....ops import moe as _moe
from ....ops.cuda import fused as _fused


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0):
    """Returns ``(out, residual_out)``: ``h = x (+ bias) (+ residual)``,
    added in x's type, ``out = rms_norm(h) (+ norm_bias)`` over the last
    axis, and ``h`` as the second output when a residual is given (else
    None).

    The reference ignores ``begin_norm_axis`` and the ``quant_*``
    arguments; the port raises ``NotImplementedError`` for a
    ``begin_norm_axis`` other than the last axis and for
    ``quant_scale > 0``."""
    if begin_norm_axis not in (-1, len(x.shape) - 1):
        raise NotImplementedError(
            f"fused_rms_norm: begin_norm_axis={begin_norm_axis} is not "
            f"ported (only the last axis; the reference ignores it)")
    if quant_scale > 0:
        raise NotImplementedError("fused_rms_norm: quantized output "
                                  "(quant_scale > 0) is not ported")
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual
    out = call("fused_rms_norm", h, norm_weight, eps=float(epsilon))
    if norm_bias is not None:
        out = out + norm_bias
    return out, (h if residual is not None else None)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None):
    """Returns ``(out, residual_out)`` as ``fused_rms_norm`` does, with
    LayerNorm over the axes from ``begin_norm_axis`` on."""
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual
    shape = h.shape[begin_norm_axis:] if begin_norm_axis != -1 \
        else [h.shape[-1]]
    out = _layer_norm(h, shape, norm_weight, norm_bias, epsilon)
    return out, (h if residual is not None else None)


def swiglu(x, gate=None):
    """``silu(x) * gate``; with ``gate=None`` x's last axis is split in
    half (the op ``fused_swiglu``)."""
    return call("fused_swiglu", x, gate)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """``ops/cuda/fused.py`` ``fused_rotary_position_embedding`` through
    the dispatch: ``(q, k, v)`` rotated (k None stays None)."""
    return apply("fused_rope", _fused.fused_rotary_position_embedding, q, k,
                 v, sin, cos, position_ids,
                 use_neox_rotary_style=use_neox_rotary_style)


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True):
    """Gating, capacity dispatch, grouped expert MLP and combine
    (``ops/moe.py`` ``moe_ffn``, capacity factor 1.25, tanh GELU). x
    ``[.., S, M]``; gate_weight ``[M, E]``; ffn1_weight ``[E, M, H]``;
    ffn2_weight ``[E, H, M]``; biases default to zeros. Returns the output
    alone, in x's shape.

    ``norm_topk_prob`` is ignored, as the reference ignores it (top-2
    gates are always normalised to sum 1). A quantized ``quant_method``
    raises ``NotImplementedError``."""
    if quant_method not in ("None", "none", None):
        raise NotImplementedError("quantized fused_moe not supported yet")
    return apply("fused_moe", _fused_moe, x, gate_weight, ffn1_weight,
                 ffn2_weight, ffn1_bias, ffn2_bias, k=int(moe_topk))


def _fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias,
               ffn2_bias, k):
    m = x.shape[-1]
    x2 = x.reshape(-1, m)
    e = gate_weight.shape[-1]
    h = ffn1_weight.shape[-1]
    if ffn1_bias is None:
        ffn1_bias = x.new_zeros((e, h))
    if ffn2_bias is None:
        ffn2_bias = x.new_zeros((e, m))
    out, _ = _moe.moe_ffn(x2, gate_weight, ffn1_weight,
                          ffn1_bias.reshape(e, h), ffn2_weight,
                          ffn2_bias.reshape(e, m), k=k)
    return out.reshape(x.shape)


__all__ = ["fused_rms_norm", "fused_layer_norm", "swiglu",
           "fused_rotary_position_embedding", "fused_moe"]
