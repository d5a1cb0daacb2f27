"""Flash attention: three CUDA kernels for Hopper and their autograd glue.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``. The kernels live
in ``paddle_tpu_torch/csrc``:

==================  =============================  ===================
wrapper             source                         replaces
==================  =============================  ===================
``flash_fwd``       ``csrc/flash_fwd.cu``          ``_fwd_kernel``
``flash_bwd_dkv``   ``csrc/flash_bwd_dkv.cu``      ``_dkv_kernel``
``flash_bwd_dq``    ``csrc/flash_bwd_dq.cu``       ``_dq_kernel``
==================  =============================  ===================

Inside the kernels the layout is ``[B*H, S, D]``. Logits, softmax statistics
and accumulators are fp32; the io type is float32 or bfloat16; head_dim is
32, 64 or 128. The causal mask is bottom-right aligned (key ``k`` is seen by
query ``q`` when ``k <= q + (Sk - Sq)``) and keys at or past ``kv_len`` are
masked. A query row that sees no key at all gets output 0 and lse -1e30.

Each wrapper dispatches on the device of its tensors: a CUDA tensor launches
the kernel (or raises on a type, head_dim or layout the kernel does not
take), a CPU tensor runs the plain PyTorch version beside it, which repeats
the kernel's arithmetic. There is no fallback from one to the other.
``LAUNCHES`` counts kernel launches per wrapper; the plain versions do not
count.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ._build import library

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ C interface

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q k v o lse | bh sq sk d is_bf16 causal scale kv_len q_offset | stream
    "flash_fwd": ("pt_flash_fwd", [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P]),
    # q k v do lse delta dk dv | ...
    "flash_bwd_dkv": ("pt_flash_bwd_dkv",
                      [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P]),
    # q k v do lse delta dq | ...
    "flash_bwd_dq": ("pt_flash_bwd_dq", [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]),
}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def _cfunc(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def _launch(name: str, tensors, bh, sq, sk, d, is_bf16, causal, scale,
            kv_len, q_offset) -> None:
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    with torch.cuda.device(tensors[0].device):
        err = _cfunc(name)(*[t.data_ptr() for t in tensors], bh, sq, sk, d,
                           int(is_bf16), int(causal), float(scale),
                           int(kv_len), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{torch.cuda.CudaError(err)}")
    LAUNCHES[name] += 1


def _check_cuda(name: str, io, stats=()) -> None:
    """Raise on inputs the CUDA kernel does not take. ``io`` are the
    ``[BH, S, D]`` tensors in the io type (q first), ``stats`` the fp32
    ``[BH, Sq, 1]`` rows (lse, delta)."""
    q = io[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported on CUDA "
                        f"(float32 or bfloat16)")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not supported on CUDA "
                         f"(one of {HEAD_DIMS})")
    for t in tuple(io) + tuple(stats):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors")
    for t in io:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {q.dtype} and {t.dtype}")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: batch*heads {q.shape[0]} > 65535")


def _check_shapes(q, k, v, kv_len) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention kernels take [BH, S, D] tensors")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[1]}]")


def _dispatch(t: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash attention: no kernel for device {t.device}")


# ------------------------------------------------------- plain versions

def _mask(sq: int, sk: int, causal: bool, kv_len: int, q_offset: int,
          device) -> torch.Tensor:
    """[sq, sk] bool: key k seen by query q."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = kp < kv_len
    if causal:
        mask = mask & (kp <= qp + q_offset)
    return mask


def _scores(q, k, scale):
    return torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale


def flash_fwd_plain(q, k, v, causal: bool, scale: float, kv_len: int,
                    q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: fp32 logits, P
    rounded to the io type before P.V, lse in fp32 ``[BH, Sq, 1]``."""
    sq, sk = q.shape[1], k.shape[1]
    mask = _mask(sq, sk, causal, kv_len, q_offset, q.device)
    s = _scores(q, k, scale).masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float())
    return (acc / l_safe).to(q.dtype), m + torch.log(l_safe)


def _p_ds(q, k, v, do, lse, delta, causal, scale, kv_len, q_offset):
    sq, sk = q.shape[1], k.shape[1]
    mask = _mask(sq, sk, causal, kv_len, q_offset, q.device)
    s = _scores(q, k, scale)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta) * scale


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                        kv_len: int, q_offset: int):
    """dK, dV in plain PyTorch, fp32 throughout, written in the io type."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, kv_len, q_offset)
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                       kv_len: int, q_offset: int):
    """dQ in plain PyTorch, fp32 throughout, written in the io type."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, kv_len, q_offset)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in fp32, ``[BH, Sq, 1]``, as the TPU ``_bwd``
    computes it outside its kernels."""
    return (do.float() * out.float()).sum(-1, keepdim=True)


# ------------------------------------------------------------- wrappers

def flash_fwd(q, k, v, causal: bool, scale: float, kv_len: int,
              q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward on ``[BH, S, D]``: returns ``out`` (io type) and
    ``lse`` (fp32, ``[BH, Sq, 1]``)."""
    _check_shapes(q, k, v, kv_len)
    if not _dispatch(q):
        return flash_fwd_plain(q, k, v, causal, scale, kv_len, q_offset)
    _check_cuda("flash_fwd", (q, k, v))
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), device=q.device, dtype=torch.float32)
    _launch("flash_fwd", (q, k, v, out, lse), bh, sq, k.shape[1], d,
            q.dtype == torch.bfloat16, causal, scale, kv_len, q_offset)
    return out, lse


def _check_bwd(name, q, do, lse, delta):
    if do.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for t in (lse, delta):
        if t.shape != (q.shape[0], q.shape[1], 1) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be float32 "
                             f"[BH, Sq, 1], got {t.dtype} {tuple(t.shape)}")


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  kv_len: int, q_offset: int):
    """dK and dV of attention, from the forward's lse and
    ``delta = rowsum(dO * O)``."""
    _check_shapes(q, k, v, kv_len)
    _check_bwd("flash_bwd_dkv", q, do, lse, delta)
    if not _dispatch(q):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                                   kv_len, q_offset)
    _check_cuda("flash_bwd_dkv", (q, k, v, do), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bh, sq, d = q.shape
    _launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), bh, sq,
            k.shape[1], d, q.dtype == torch.bfloat16, causal, scale, kv_len,
            q_offset)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 kv_len: int, q_offset: int):
    """dQ of attention, from the forward's lse and ``delta``."""
    _check_shapes(q, k, v, kv_len)
    _check_bwd("flash_bwd_dq", q, do, lse, delta)
    if not _dispatch(q):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                  kv_len, q_offset)
    _check_cuda("flash_bwd_dq", (q, k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    bh, sq, d = q.shape
    _launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq), bh, sq,
            k.shape[1], d, q.dtype == torch.bfloat16, causal, scale, kv_len,
            q_offset)
    return dq


# --------------------------------------------------------------- public

class _MHA(torch.autograd.Function):
    """The TPU package's ``_mha`` custom VJP: the forward saves
    ``(q, k, v, out, lse)``; the backward launches dK/dV, then dQ."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        sq, sk = q.shape[1], k.shape[1]
        out, lse = flash_fwd(q, k, v, causal, scale, kv_len=sk,
                             q_offset=sk - sq)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        sq, sk = q.shape[1], k.shape[1]
        do = do.contiguous()
        delta = attention_delta(do, out)
        args = (ctx.causal, ctx.scale, sk, sk - sq)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *args)
        return dq, dk, dv, None, None


def mha_forward(q, k, v, causal: bool = False,
                scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention on ``[B, H, S, D]`` or ``[BH, S, D]``;
    returns the rank it was given. Inputs that are not contiguous (the
    transposed heads of a GPT block) are copied to a contiguous layout."""
    four = q.dim() == 4
    if four:
        b, h, sq, d = q.shape
        q = q.reshape(b * h, sq, d)
        k = k.reshape(b * h, k.shape[2], d)
        v = v.reshape(b * h, v.shape[2], d)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out = _MHA.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                     bool(causal), float(scale))
    return out.reshape(b, h, sq, d) if four else out


def flash_attention(query, key, value, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Paddle layout ``[batch, seq, heads, head_dim]``; sequence lengths
    must be multiples of 128, as for the TPU kernel's public entry."""
    sq, sk = query.shape[1], key.shape[1]
    if sq % 128 or sk % 128:
        raise ValueError(f"flash_attention kernel needs seq % 128 == 0 "
                         f"(got q={sq}, k={sk})")
    out = mha_forward(query.transpose(1, 2), key.transpose(1, 2),
                      value.transpose(1, 2), causal, scale)
    return out.transpose(1, 2)
