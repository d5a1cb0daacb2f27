"""RMSNorm and SwiGLU: two CUDA kernels for Hopper and their autograd glue,
and the rotary embedding in plain PyTorch.

Counterpart of ``paddle_tpu/ops/pallas/fused.py``. The kernels live in
``paddle_tpu_torch/csrc/fused.cu``:

================  ===================  ==================
wrapper           C entry              replaces
================  ===================  ==================
``rms_norm_fwd``  ``pt_rms_norm_fwd``  ``_rms_kernel``
``swiglu_fwd``    ``pt_swiglu_fwd``    ``_swiglu_kernel``
================  ===================  ==================

Both compute in fp32 and round once to x's type. x is float32, bfloat16 or
float16; the RMSNorm weight is in x's type or float32, the SwiGLU gate in
any of the three. SwiGLU's x and gate may have their own row strides (the
two halves of one ``[N, 2F]`` tensor are read in place).

Each wrapper dispatches on the device of its tensors: a CUDA tensor
launches the kernel (or raises on a type, shape or layout the kernel does
not take), a CPU tensor runs the plain PyTorch version beside it, which
repeats the kernel's arithmetic. There is no fallback from one to the
other. The ops ``paddle_tpu_torch::rms_norm`` and ``::swiglu``
(``library.py``) are the wrappers with their backward, and the public
functions call them. ``LAUNCHES`` counts kernel launches per wrapper; the
plain versions do not count.

As in the reference, only the forward passes are kernels: the backward
passes are the reference's closed forms (``_rms_bwd``, ``_swiglu_bwd``),
which the reference leaves to XLA, written here in plain PyTorch on
whatever device the tensors are on. They are the counterpart of that jnp
code, not a fallback.

The ops ``fused_rms_norm(x, weight, eps)``, ``fused_swiglu(x, gate)`` and
``fused_rope(q, k, cos, sin)`` (two outputs) are registered at import, as
the reference registers them on its entries' first call.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..._core.op_registry import register_op
from ._build import function
from .library import define

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

LAUNCHES: Dict[str, int] = {"rms_norm": 0, "swiglu": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ C interface

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    # x w y | n h eps x_type w_type | stream
    "rms_norm": ("pt_rms_norm_fwd", [_P] * 3 + [_I, _I, _F, _I, _I, _P]),
    # x g y | n f sx sg x_type g_type | stream
    "swiglu": ("pt_swiglu_fwd", [_P] * 3 + [_I, _I, _L, _L, _I, _I, _P]),
}


def _launch(name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = function("fused", *_SIGNATURES[name])(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{torch.cuda.CudaError(err)}")
    LAUNCHES[name] += 1


def _dispatch(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {dev}")


def _type_code(name: str, t: torch.Tensor) -> int:
    code = _TYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {t.dtype} not supported on CUDA "
                        f"(float32, bfloat16 or float16)")
    return code


def _check_int32(name: str, *sizes: int) -> None:
    if any(s >= 2 ** 31 for s in sizes):
        raise ValueError(f"{name}: sizes {sizes} exceed the kernel's int32")


# ------------------------------------------------------- plain versions

def rms_norm_fwd_plain(x2: torch.Tensor, w: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """``_rms_kernel`` in plain PyTorch: fp32 statistics,
    ``(x * rsqrt(mean(x^2) + eps)) * w`` in fp32, rounded once to x's
    type."""
    x = x2.float()
    r = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return ((x * r) * w.float()).to(x2.dtype)


def swiglu_fwd_plain(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """``_swiglu_kernel`` in plain PyTorch: ``silu(x) * g`` in fp32,
    rounded once to x's type. The kernel spells silu ``x / (1 + exp(-x))``,
    this version ``x * sigmoid(x)``: the same fp32 function to an ulp.
    PyTorch's CPU ``exp`` goes through MKL's vector math, whose accuracy
    mode is per thread and was seen at 1.5e-4 relative error on a pool
    thread; its ``sigmoid`` does not."""
    x = x2.float()
    return (x * torch.sigmoid(x) * g2.float()).to(x2.dtype)


def rms_norm_bwd(x2, w, dy, eps: float):
    """The reference's ``_rms_bwd``: dx in x's type, dw (an fp32 column sum
    over all rows) in w's type."""
    x = x2.float()
    gf = dy.float()
    wf = w.float()
    r = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    xhat = x * r
    dw = (gf * xhat).sum(0).to(w.dtype)
    gx = gf * wf
    h = x.shape[-1]
    dx = r * (gx - xhat * (gx * xhat).sum(-1, keepdim=True) / h)
    return dx.to(x2.dtype), dw


def swiglu_bwd(x2, g2, dout):
    """The reference's ``_swiglu_bwd``: dx in x's type, dg in g's type."""
    x = x2.float()
    g = g2.float()
    d = dout.float()
    sig = torch.sigmoid(x)
    silu = x * sig
    dsilu = sig * (1 + x * (1 - sig))
    return (d * g * dsilu).to(x2.dtype), (d * silu).to(g2.dtype)


# ------------------------------------------------------------- wrappers

def rms_norm_fwd(x2: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """RMSNorm forward of the rows of ``x2`` ``[N, H]`` with weight ``w``
    ``[H]``; the output has x's type."""
    if x2.dim() != 2 or w.shape != (x2.shape[1],):
        raise ValueError(f"rms_norm takes x [N, H] and w [H], got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    if not _dispatch("rms_norm", x2, w):
        return rms_norm_fwd_plain(x2, w, eps)
    x_type, w_type = _type_code("rms_norm", x2), _type_code("rms_norm", w)
    if w.dtype not in (x2.dtype, torch.float32):
        raise TypeError(f"rms_norm: weight {w.dtype} with x {x2.dtype} "
                        f"(the weight is in x's type or float32)")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm: the CUDA kernel needs contiguous x and w")
    n, h = x2.shape
    _check_int32("rms_norm", n, h)
    y = torch.empty_like(x2)
    if n and h:
        _launch("rms_norm", x2.device, x2.data_ptr(), w.data_ptr(),
                y.data_ptr(), n, h, float(eps), x_type, w_type)
    return y


def swiglu_fwd(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """``silu(x2) * g2`` of two ``[N, F]`` tensors, each with unit column
    stride and its own row stride; the output is a contiguous ``[N, F]``
    in x's type."""
    if x2.dim() != 2 or g2.shape != x2.shape:
        raise ValueError(f"swiglu takes x and g [N, F] of one shape, got "
                         f"{tuple(x2.shape)} and {tuple(g2.shape)}")
    if not _dispatch("swiglu", x2, g2):
        return swiglu_fwd_plain(x2, g2)
    x_type, g_type = _type_code("swiglu", x2), _type_code("swiglu", g2)
    n, f = x2.shape
    for t in (x2, g2):
        if f > 1 and t.stride(1) != 1:
            raise ValueError("swiglu: the CUDA kernel needs unit column "
                             "stride")
        if n > 1 and t.stride(0) < f:
            raise ValueError(f"swiglu: row stride {t.stride(0)} < {f}")
    _check_int32("swiglu", n, f)
    y = torch.empty((n, f), dtype=x2.dtype, device=x2.device)
    if n and f:
        _launch("swiglu", x2.device, x2.data_ptr(), g2.data_ptr(),
                y.data_ptr(), n, f, x2.stride(0), g2.stride(0), x_type,
                g_type)
    return y


# --------------------------------------------------------------- public

def _save_rms(ctx, inputs, output):
    """The reference's ``_rms`` custom VJP keeps ``(x2, w)``."""
    ctx.save_for_backward(*inputs[:2])
    ctx.eps = inputs[2]


def _rms_backward(ctx, dy):
    x2, w = ctx.saved_tensors
    dx, dw = rms_norm_bwd(x2, w, dy, ctx.eps)
    return dx, dw, None


rms_norm_op = define(
    "rms_norm", "(Tensor x2, Tensor w, float eps) -> Tensor",
    lambda *args: rms_norm_fwd(*args),
    lambda x2, w, eps: torch.empty_like(x2), _rms_backward, _save_rms)


def _save_swiglu(ctx, inputs, output):
    """The reference's ``_swiglu`` custom VJP keeps ``(x, g)``."""
    ctx.save_for_backward(*inputs)


def _swiglu_backward(ctx, dout):
    """With ``g`` None, ``x`` is ``[N, 2F]`` and its halves are x and g:
    the gradient then comes back as one ``[N, 2F]`` tensor."""
    x, g = ctx.saved_tensors
    dx, dg = swiglu_bwd(*_halves(x, g), dout)
    if g is None:
        return torch.cat([dx, dg], -1), None
    return dx, dg


def _swiglu_fake(x, g):
    f = x.shape[1] if g is not None else x.shape[1] // 2
    return x.new_empty((x.shape[0], f))


swiglu_op = define(
    "swiglu", "(Tensor x, Tensor? g) -> Tensor",
    lambda x, g: swiglu_fwd(*_halves(x, g)), _swiglu_fake,
    _swiglu_backward, _save_swiglu)


def _halves(x, g):
    if g is not None:
        return x, g
    f = x.shape[-1] // 2
    return x[:, :f], x[:, f:]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (any shape); differentiable.
    The reference's ``ops.pallas.rms_norm``."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    return rms_norm_op(x2, weight.contiguous(),
                       float(epsilon)).reshape(shape)


def swiglu(x: torch.Tensor, gate: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``silu(x) * gate``; with ``gate=None``, x's last axis is split in
    half (first half x, second half gate) and read in place. Gradients of
    the split form flow into the whole input."""
    if gate is None:
        f2 = x.shape[-1]
        if f2 % 2:
            raise ValueError(f"swiglu: the split form needs an even last "
                             f"axis, got {f2}")
        x2 = x.reshape(-1, f2)
        if f2 > 1 and x2.stride(1) != 1:
            x2 = x2.contiguous()
        return swiglu_op(x2, None).reshape(*x.shape[:-1], f2 // 2)
    if gate.shape != x.shape:
        raise ValueError(f"swiglu: x {tuple(x.shape)} and gate "
                         f"{tuple(gate.shape)} differ in shape")
    f = x.shape[-1]
    return swiglu_op(x.reshape(-1, f), gate.reshape(-1, f)
                         ).reshape(x.shape)


# -------------------------------------------------------------------- rope

def _rope_half(x, cos, sin):
    """Rotate-half on the last axis with fp32 trig; cos/sin broadcast over
    batch and heads."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """The reference's ``fused_rotary_position_embedding``: q and k
    ``[B, S, H, D]`` rotated by the rotate-half convention, v passed
    through. Returns ``(q, k, v)``, or ``(q, None, v)`` without k. Default
    frequencies ``1 / 10000^(arange(0, D, 2) / D)``, concatenated twice.

    Refuses what the reference gets silently wrong: ``position_ids``
    ``[B, S]`` whose rows differ (the reference applies row 0's positions
    to every row) raise ``ValueError``, and ``use_neox_rotary_style=False``
    (which the reference ignores) raises ``NotImplementedError``."""
    if not use_neox_rotary_style:
        raise NotImplementedError(
            "fused_rotary_position_embedding: use_neox_rotary_style=False "
            "is not ported (the reference ignores it and rotates halves)")
    s, d = q.shape[1], q.shape[-1]
    if cos is None:
        inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                               device=q.device) / d))
        t = torch.arange(s, dtype=torch.float32, device=q.device)
        freqs = torch.outer(t, inv)
        emb = torch.cat([freqs, freqs], dim=-1)
        cosv, sinv = torch.cos(emb), torch.sin(emb)
    else:
        cosv = cos.reshape(cos.shape[-2], cos.shape[-1])
        sinv = sin.reshape(sin.shape[-2], sin.shape[-1])
    if position_ids is not None:
        if position_ids.dim() != 2:
            raise ValueError(f"position_ids must be [batch, seq], got "
                             f"{tuple(position_ids.shape)}")
        pid = position_ids.long()
        if not bool((pid == pid[:1]).all()):
            raise ValueError(
                "fused_rotary_position_embedding: position_ids rows differ; "
                "the reference applies batch row 0's positions to every "
                "row, so per-row positions are not ported")
        cosv, sinv = cosv[pid[0]], sinv[pid[0]]
    cosv, sinv = cosv[None, :, None, :], sinv[None, :, None, :]
    qo = _rope_half(q, cosv, sinv)
    ko = _rope_half(k, cosv, sinv) if k is not None else None
    return qo, ko, v


# ---------------------------------------------------------- registered ops

@register_op("fused_rms_norm")
def _rms_body(x, weight, eps):
    """RMSNorm over the last axis (kernel #4)."""
    return rms_norm(x, weight, eps)


register_op("fused_swiglu", swiglu)


@register_op("fused_rope", multi_output=True)
def _rope_body(q, k, cos, sin):
    """q and k ``[B, S, H, D]`` rotated by cos and sin ``[S, D]`` (or
    ``[1, S, 1, D]``); the reference's ``_rope_body`` with its k."""
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return _rope_half(q, cos, sin), _rope_half(k, cos, sin)
