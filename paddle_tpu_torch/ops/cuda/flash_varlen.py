"""Packed-sequence (varlen) and flashmask attention: CUDA kernels and
autograd glue.

Counterpart of ``paddle_tpu/ops/pallas/flash_varlen.py``. Ragged batches
are packed as ``[total_tokens, heads, head_dim]`` with ``cu_seqlens``
(segment ``i`` owns tokens ``[cu[i], cu[i+1])``); flashmask batches are
``[B*H, S, D]`` with per-key start/end rows. The kernels are the
fixed-length ones of ``csrc/`` instantiated with their segment mask
(varlen) or start/end mask (flashmask):

=====================  =======================================  ==================
wrapper                entry (source)                           replaces
=====================  =======================================  ==================
``varlen_fwd``         ``pt_varlen_fwd`` (``flash_fwd.cu``)     ``_v_fwd_kernel``
``varlen_bwd_dkv``     ``pt_varlen_bwd_dkv``                    ``_v_dkv_kernel``
                       (``flash_bwd_dkv.cu``)
``varlen_bwd_dq``      ``pt_varlen_bwd_dq``                     ``_v_dq_kernel``
                       (``flash_bwd_dq.cu``)
``flashmask_fwd``      ``pt_flashmask_fwd`` (``flash_fwd.cu``)  ``_fm_fwd_kernel``
``flashmask_bwd_dkv``  ``pt_flashmask_bwd_dkv``                 ``_fm_dkv_kernel``
                       (``flash_bwd_dkv.cu``)
``flashmask_bwd_dq``   ``pt_flashmask_bwd_dq``                  ``_fm_dq_kernel``
                       (``flash_bwd_dq.cu``)
=====================  =======================================  ==================

Semantics, as on the TPU: key ``k`` is seen by query ``q`` when both lie in
the same segment and, when causal, ``pos_k <= pos_q`` (top-left aligned
inside the segment). Tokens past ``cu[-1]`` are padding (segment -1 for
queries, -2 for keys: they never meet). A query row that sees no key gets
output 0 and lse 0. Logits, softmax statistics and accumulators are fp32;
P is rounded to the io type before P.V. The kernels read ``[T, H, D]`` in
place through its strides; lse and delta are fp32 ``[H, Tq, 1]``.

Which tiles a tile visits is worked out here, from ``cu_seqlens`` with O(T)
work (:func:`varlen_plan`), so no ``[T, T]`` mask is ever built on the
kernel path. Wrappers dispatch on the device of their tensors as in
``flash_attention.py``: CUDA launches the kernel or raises, CPU runs the
plain version, which builds the dense ``[Tq, Tk]`` mask from the same
segment and position arrays and repeats the kernel's rounding points.
``LAUNCHES`` counts kernel launches per wrapper. Each wrapper is also the
op ``paddle_tpu_torch::<wrapper>`` (``library.py``), taking the plan's
arrays in place of the plan, which the public functions call.

Flashmask semantics, as on the TPU: ``startend`` ``[B, 1 or H, Sk, 1 or
2]`` gives each key column ``j`` the query rows ``[start_j, end_j)`` it is
hidden from (one column: ``end = INT32_MAX``); key ``k`` is seen by query
``q`` when ``q`` is not banned and, when causal, ``k <= q`` (top-left
aligned, unlike the fixed-length kernels' bottom-right). A row that sees no
key gets output 0 and lse 0. :func:`flashmask_plan` turns ``startend`` into
int32 start and end rows and, per 64-column key tile, the largest start and
smallest end, with O(B*H*Sk) work: a kernel skips a key tile that bans its
whole query tile, and no ``[S, S]`` mask is built on the kernel path.

Head dims run as in ``flash_attention.py`` (``kernel_head_dim``), by io
type: bf16 and float16 on the tensor cores at every head_dim (at 256 and,
split over 256-column chunks, above it, two warpgroups a block: the
forward and dQ over 128 query rows, the ring holding every key tile either
64-row tile visits; dK/dV over one 64-row key tile); float32 on the FMA
kernels. A bf16 or float16 launch that fails raises.

Sizes: any number of tiles runs. The tensor-core kernels put the heads on the
grid's x axis and the tiles on y, and past 65535 tiles (4,194,240 rows;
at head_dim 256 and above 65535 blocks, counted with their chunks, of 128
query rows for the forward and dQ and of 64 key rows for dK/dV) the tiles
on x (at most 2^31 - 1) and the heads on y; the C entries
launch the heads in slices of at most 65535 either way. What a launch refuses
(``RuntimeError`` naming the CUDA error) is only what cannot be launched
at all: a tensor map the driver will not encode (a row stride that is not
a multiple of 16 bytes after the wrappers' copies, or a dimension past
2^32), or no memory for the launch.

The ops ``flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, scale,
causal)`` and ``flashmask_attention(q, k, v, startend, scale, causal)``
are registered at import, as the reference registers ``_varlen_body``
and ``_flashmask_body``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..._core.op_registry import register_op
from . import flash_attention as fa
from ._build import function
from .library import define
from .flash_attention import (NEG_INF, _check_cuda, _dispatch, _pad_head_dim,
                              _tma_inputs)

TILE = 64  # rows of a kernel tile (BQ = BK in csrc/flash_common.cuh)

LAUNCHES: Dict[str, int] = {"varlen_fwd": 0, "varlen_bwd_dkv": 0,
                            "varlen_bwd_dq": 0, "flashmask_fwd": 0,
                            "flashmask_bwd_dkv": 0, "flashmask_bwd_dq": 0}
INT32_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------ plan (host side)

def varlen_meta(cu: torch.Tensor, t_pad: int,
                pad_seg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token segment id (``pad_seg`` for tokens at or past ``cu[-1]``)
    and in-segment position, int32 ``[t_pad]``. An empty segment (a repeated
    entry of ``cu``) owns no token."""
    cu = cu.to(torch.int32)
    nseg = cu.numel() - 1
    tok = torch.arange(t_pad, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu, tok, right=True).to(torch.int32) - 1
    seg = seg.clamp(0, nseg - 1)
    pos = tok - cu[seg.long()]
    seg = torch.where(tok < cu[-1], seg, pad_seg).to(torch.int32)
    return seg, pos


def _segment_span(seg, cu, block):
    """Per block of ``block`` tokens: whether it holds a real token, and
    ``cu`` at its first segment and one past its last."""
    nseg = cu.numel() - 1
    s2 = seg.view(-1, block)
    valid = s2 >= 0
    smin = torch.where(valid, s2, nseg).amin(1)
    smax = torch.where(valid, s2, -1).amax(1)
    lo_tok = cu[smin.clamp(0, nseg).long()]
    hi_tok = cu[(smax + 1).clamp(0, nseg).long()]
    return s2, valid, lo_tok, hi_tok


def varlen_qblock_bounds(seg_q, pos_q, cu_k, bq: int, bk: int, tk_pad: int,
                         causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 ``[nqb]`` ``[lo, hi)`` key-block bounds per query block: the
    key blocks of the block's segments, cut at the causal diagonal."""
    cu_k = cu_k.to(torch.int32)
    nseg = cu_k.numel() - 1
    s2, valid, lo_tok, hi_tok = _segment_span(seg_q, cu_k, bq)
    if causal:
        base = cu_k[s2.clamp(0, nseg - 1).long()]
        kmax = torch.where(valid, base + pos_q.view(-1, bq) + 1, 0)
        hi_tok = torch.minimum(hi_tok, kmax.amax(1))
    any_valid = valid.any(1)
    lo = torch.where(any_valid, lo_tok // bk, 0)
    hi = torch.where(any_valid,
                     torch.clamp(_cdiv(hi_tok, bk), max=tk_pad // bk), 0)
    return lo.to(torch.int32), hi.to(torch.int32)


def varlen_kblock_bounds(seg_k, pos_k, cu_q, bk: int, bq: int, tq_pad: int,
                         causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 ``[nkb]`` ``[lo, hi)`` query-block bounds per key block (for
    dK/dV): the query blocks of the block's segments, from the first query
    on or past the causal diagonal."""
    cu_q = cu_q.to(torch.int32)
    nseg = cu_q.numel() - 1
    s2, valid, lo_tok, hi_tok = _segment_span(seg_k, cu_q, bk)
    if causal:
        # a key at (seg, pos) is seen only by queries at pos_q >= pos
        base = cu_q[s2.clamp(0, nseg - 1).long()]
        qmin = torch.where(valid, base + pos_k.view(-1, bk), tq_pad)
        lo_tok = torch.maximum(lo_tok, qmin.amin(1))
    any_valid = valid.any(1)
    lo = torch.where(any_valid, lo_tok // bq, 0)
    hi = torch.where(any_valid,
                     torch.clamp(_cdiv(hi_tok, bq), max=tq_pad // bq), 0)
    return lo.to(torch.int32), hi.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class VarlenPlan:
    """What the kernels need besides q, k and v: per-token segment and
    position (int32, padded to whole ``TILE``-row tiles), per-tile bounds
    (key tiles per query tile ``qlo/qhi``, query tiles per key tile
    ``klo/khi``) and the causal flag they were worked out for."""
    seg_q: torch.Tensor
    pos_q: torch.Tensor
    seg_k: torch.Tensor
    pos_k: torch.Tensor
    qlo: torch.Tensor
    qhi: torch.Tensor
    klo: torch.Tensor
    khi: torch.Tensor
    causal: bool


def varlen_plan(cu_q: torch.Tensor, cu_k: torch.Tensor, tq: int, tk: int,
                causal: bool) -> VarlenPlan:
    """The plan for ``tq`` query and ``tk`` key tokens at the kernels' tile,
    on ``cu_q``'s device."""
    tq_pad, tk_pad = _cdiv(tq, TILE) * TILE, _cdiv(tk, TILE) * TILE
    seg_q, pos_q = varlen_meta(cu_q, tq_pad, pad_seg=-1)
    seg_k, pos_k = varlen_meta(cu_k, tk_pad, pad_seg=-2)
    qlo, qhi = varlen_qblock_bounds(seg_q, pos_q, cu_k, TILE, TILE, tk_pad,
                                    causal)
    klo, khi = varlen_kblock_bounds(seg_k, pos_k, cu_q, TILE, TILE, tq_pad,
                                    causal)
    return VarlenPlan(seg_q, pos_q, seg_k, pos_k, qlo, qhi, klo, khi,
                      bool(causal))


# ------------------------------------------------------------ C interface

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 6 + [_F, _P]  # h tq tk d io causal | scale | stream
# bh h hs sq sk d io causal | scale | stream
_FM_TAIL = [_I] * 8 + [_F, _P]
_SIGNATURES = {
    # q k v o lse | seg_q pos_q seg_k pos_k lo hi | ...
    "varlen_fwd": ("flash_fwd", "pt_varlen_fwd", [_P] * 11 + _TAIL),
    # q k v do lse delta dk dv | seg/pos lo hi | ...
    "varlen_bwd_dkv": ("flash_bwd_dkv", "pt_varlen_bwd_dkv",
                       [_P] * 14 + _TAIL),
    # q k v do lse delta dq | seg/pos lo hi | ...
    "varlen_bwd_dq": ("flash_bwd_dq", "pt_varlen_bwd_dq", [_P] * 13 + _TAIL),
    # q k v o lse | st en st_max en_min | ...
    "flashmask_fwd": ("flash_fwd", "pt_flashmask_fwd", [_P] * 9 + _FM_TAIL),
    # q k v do lse delta dk dv | st en st_max en_min | ...
    "flashmask_bwd_dkv": ("flash_bwd_dkv", "pt_flashmask_bwd_dkv",
                          [_P] * 12 + _FM_TAIL),
    # q k v do lse delta dq | st en st_max en_min | ...
    "flashmask_bwd_dq": ("flash_bwd_dq", "pt_flashmask_bwd_dq",
                         [_P] * 11 + _FM_TAIL),
}


def _check_shapes(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("varlen attention takes packed [T, H, D] tensors")
    if k.shape != v.shape or k.shape[1:] != q.shape[1:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[0] == 0 or k.shape[0] == 0:
        raise ValueError("varlen attention needs at least one token")


def _check_offsets(q, k) -> None:
    """The kernels index a packed tensor with 32-bit row offsets: checked
    at the head_dim they run at."""
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("varlen attention: the kernels index a packed "
                         "tensor with 32-bit row offsets (< 2^31 elements)")


def _check_bwd(name, q, do, lse, delta):
    if do.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q {tuple(q.shape)}")
    want = (q.shape[1], q.shape[0], 1)
    for t in (lse, delta):
        if tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be float32 [H, Tq, 1] "
                             f"{want}, got {t.dtype} {tuple(t.shape)}")


def _varlen_sizes(q, k):
    """h, tq, tk, d of packed [T, H, D] q and k."""
    return q.shape[1], q.shape[0], k.shape[0], q.shape[2]


def _plan_tensors(name, q, k, plan: VarlenPlan, lo, hi, tiles: int):
    """The plan's arrays for one kernel (``lo/hi`` with one entry per grid
    tile), checked against what the kernel indexes."""
    tq_pad = _cdiv(q.shape[0], TILE) * TILE
    tk_pad = _cdiv(k.shape[0], TILE) * TILE
    want = ((plan.seg_q, tq_pad), (plan.pos_q, tq_pad), (plan.seg_k, tk_pad),
            (plan.pos_k, tk_pad), (lo, tiles), (hi, tiles))
    for t, n in want:
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"{name}: the plan does not fit q {tuple(q.shape)}"
                             f" and k {tuple(k.shape)} on {q.device}")
    return (plan.seg_q, plan.pos_q, plan.seg_k, plan.pos_k, lo, hi)


def _launch(name: str, tensors, sizes, q, causal: bool,
            scale: float) -> None:
    """Launches entry ``name`` on ``tensors`` (pointers) and ``sizes``
    (ints), then the io code of ``q``'s type, ``causal``, ``scale`` and the
    current stream."""
    lib, symbol, argtypes = _SIGNATURES[name]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = function(lib, symbol, argtypes)(
            *[x.data_ptr() for x in tensors], *sizes, fa.io_code(q.dtype),
            int(causal), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{torch.cuda.CudaError(err)}")
    LAUNCHES[name] += 1


# ------------------------------------------------------- plain versions

def _mask(plan: VarlenPlan, tq: int, tk: int) -> torch.Tensor:
    """[tq, tk] bool: key k seen by query q."""
    mask = plan.seg_q[:tq, None] == plan.seg_k[None, :tk]
    if plan.causal:
        mask = mask & (plan.pos_k[None, :tk] <= plan.pos_q[:tq, None])
    return mask


def _scores(q, k, scale):
    return torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale


def varlen_fwd_plain(q, k, v, plan: VarlenPlan,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: fp32 logits, P
    rounded to the io type before P.V; out ``[Tq, H, D]`` (0 on rows that
    see no key), lse fp32 ``[H, Tq, 1]`` (0 on those rows)."""
    mask = _mask(plan, q.shape[0], k.shape[0])
    s = _scores(q, k, scale).masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("hqk,khd->qhd", p.to(q.dtype).float(), v.float())
    out = (acc / l_safe.transpose(0, 1)).to(q.dtype)
    return out, torch.where(l == 0.0, 0.0, m + torch.log(l_safe))


def _p_ds(q, k, v, do, lse, delta, plan, scale):
    mask = _mask(plan, q.shape[0], k.shape[0])
    p = torch.where(mask, torch.exp(_scores(q, k, scale) - lse), 0.0)
    dp = torch.einsum("qhd,khd->hqk", do.float(), v.float())
    return p, p * (dp - delta) * scale


def varlen_bwd_dkv_plain(q, k, v, do, lse, delta, plan: VarlenPlan,
                         scale: float):
    """dK, dV in plain PyTorch, fp32 throughout, written in the io type."""
    p, ds = _p_ds(q, k, v, do, lse, delta, plan, scale)
    dv = torch.einsum("hqk,qhd->khd", p, do.float())
    dk = torch.einsum("hqk,qhd->khd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def varlen_bwd_dq_plain(q, k, v, do, lse, delta, plan: VarlenPlan,
                        scale: float):
    """dQ in plain PyTorch, fp32 throughout, written in the io type."""
    _, ds = _p_ds(q, k, v, do, lse, delta, plan, scale)
    return torch.einsum("hqk,khd->qhd", ds, k.float()).to(q.dtype)


def varlen_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in fp32, ``[H, Tq, 1]``, as the TPU
    ``_varlen_bwd`` computes it outside its kernels."""
    return (do.float() * out.float()).sum(-1).t().contiguous().unsqueeze(-1)


# ------------------------------------------------------------- wrappers

def varlen_fwd(q, k, v, plan: VarlenPlan,
               scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Varlen attention forward on packed ``[T, H, D]``: returns ``out``
    (io type, ``[Tq, H, D]``) and ``lse`` (fp32, ``[H, Tq, 1]``)."""
    _check_shapes(q, k, v)
    if not _dispatch(q):
        return varlen_fwd_plain(q, k, v, plan, scale)
    _check_cuda("varlen_fwd", (q, k, v))
    meta = _plan_tensors("varlen_fwd", q, k, plan, plan.qlo, plan.qhi,
                         _cdiv(q.shape[0], TILE))

    def run(q, k, v):
        _check_offsets(q, k)
        q, k, v = _tma_inputs(q, k, v)
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[1], q.shape[0], 1), device=q.device,
                          dtype=torch.float32)
        _launch("varlen_fwd", (q, k, v, out, lse) + meta,
                _varlen_sizes(q, k), q, plan.causal, scale)
        return out, lse

    return _pad_head_dim(run, q, k, v)


def varlen_bwd_dkv(q, k, v, do, lse, delta, plan: VarlenPlan, scale: float):
    """dK and dV of varlen attention, from the forward's lse and
    ``delta = rowsum(dO * O)``."""
    _check_shapes(q, k, v)
    _check_bwd("varlen_bwd_dkv", q, do, lse, delta)
    if not _dispatch(q):
        return varlen_bwd_dkv_plain(q, k, v, do, lse, delta, plan, scale)
    _check_cuda("varlen_bwd_dkv", (q, k, v, do), (lse, delta))
    meta = _plan_tensors("varlen_bwd_dkv", q, k, plan, plan.klo, plan.khi,
                         _cdiv(k.shape[0], TILE))

    def run(q, k, v, do):
        _check_offsets(q, k)
        q, k, v, do = _tma_inputs(q, k, v, do)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _launch("varlen_bwd_dkv", (q, k, v, do, lse, delta, dk, dv) + meta,
                _varlen_sizes(q, k), q, plan.causal, scale)
        return dk, dv

    return _pad_head_dim(run, q, k, v, do)


def varlen_bwd_dq(q, k, v, do, lse, delta, plan: VarlenPlan, scale: float):
    """dQ of varlen attention, from the forward's lse and ``delta``."""
    _check_shapes(q, k, v)
    _check_bwd("varlen_bwd_dq", q, do, lse, delta)
    if not _dispatch(q):
        return varlen_bwd_dq_plain(q, k, v, do, lse, delta, plan, scale)
    _check_cuda("varlen_bwd_dq", (q, k, v, do), (lse, delta))
    meta = _plan_tensors("varlen_bwd_dq", q, k, plan, plan.qlo, plan.qhi,
                         _cdiv(q.shape[0], TILE))

    def run(q, k, v, do):
        _check_offsets(q, k)
        q, k, v, do = _tma_inputs(q, k, v, do)
        dq = torch.empty_like(q)
        _launch("varlen_bwd_dq", (q, k, v, do, lse, delta, dq) + meta,
                _varlen_sizes(q, k), q, plan.causal, scale)
        return dq

    return _pad_head_dim(run, q, k, v, do)


# --------------------------------------------------------------- public

_VARLEN_PLAN = ("Tensor seg_q, Tensor pos_q, Tensor seg_k, Tensor pos_k, "
                "Tensor qlo, Tensor qhi, Tensor klo, Tensor khi, bool causal, "
                "float scale")


def _varlen_op(wrapper_name, n_in):
    """A varlen entry taking the plan's arrays and causal flag in place of
    a ``VarlenPlan``: the wrapper of that name, looked up at each call."""
    def impl(*args):
        *tensors, causal, scale = args
        return globals()[wrapper_name](
            *tensors[:n_in], VarlenPlan(*tensors[n_in:], causal), scale)
    return impl


def _save_packed(ctx, inputs, output):
    """What the TPU package's ``_varlen`` and ``_fmask`` custom VJPs keep:
    ``(q, k, v, out, lse)``, then the plan and the scale."""
    ctx.save_for_backward(*inputs[:3], *output)
    ctx.plan = inputs[3:]


def _packed_backward(delta_of, dkv_op, dq_op):
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = delta_of(do, out)
        dk, dv = dkv_op(q, k, v, do, lse, delta, *ctx.plan)
        dq = dq_op(q, k, v, do, lse, delta, *ctx.plan)
        return (dq, dk, dv) + (None,) * len(ctx.plan)
    return backward


def _lse_packed(q):
    return q.new_empty((q.shape[1], q.shape[0], 1), dtype=torch.float32)


_BWD_IN = "Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, Tensor delta"
varlen_bwd_dkv_op = define(
    "varlen_bwd_dkv", f"({_BWD_IN}, {_VARLEN_PLAN}) -> (Tensor, Tensor)",
    _varlen_op("varlen_bwd_dkv", 6),
    lambda q, k, v, *_: (torch.empty_like(k), torch.empty_like(v)))
varlen_bwd_dq_op = define(
    "varlen_bwd_dq", f"({_BWD_IN}, {_VARLEN_PLAN}) -> Tensor",
    _varlen_op("varlen_bwd_dq", 6),
    lambda q, *_: torch.empty_like(q))
varlen_fwd_op = define(
    "varlen_fwd", f"(Tensor q, Tensor k, Tensor v, {_VARLEN_PLAN}) -> "
    "(Tensor, Tensor)", _varlen_op("varlen_fwd", 3),
    lambda q, *_: (torch.empty_like(q), _lse_packed(q)),
    _packed_backward(varlen_delta, varlen_bwd_dkv_op, varlen_bwd_dq_op),
    _save_packed)


def _plan_args(plan: VarlenPlan):
    return (plan.seg_q, plan.pos_q, plan.seg_k, plan.pos_k, plan.qlo,
            plan.qhi, plan.klo, plan.khi, plan.causal)


def flash_attn_varlen(query, key, value, cu_seqlens_q, cu_seqlens_k,
                      scale: Optional[float] = None,
                      causal: bool = False) -> torch.Tensor:
    """Differentiable varlen attention on packed ``[T, H, D]`` tensors with
    int32 or int64 ``cu_seqlens`` (one more entry than segments, the same
    segment count for queries and keys) on the device of ``query``."""
    _check_shapes(query, key, value)
    for name, cu in (("cu_seqlens_q", cu_seqlens_q),
                     ("cu_seqlens_k", cu_seqlens_k)):
        if cu.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name}: int32 or int64, got {cu.dtype}")
        if cu.dim() != 1 or cu.numel() < 2:
            raise ValueError(f"{name}: a 1-D tensor of at least 2 entries")
        if cu.device != query.device:
            raise ValueError(f"{name} on {cu.device}, query on "
                             f"{query.device}")
    if cu_seqlens_q.numel() != cu_seqlens_k.numel():
        raise ValueError(f"{cu_seqlens_q.numel() - 1} query segments and "
                         f"{cu_seqlens_k.numel() - 1} key segments")
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    plan = varlen_plan(cu_seqlens_q, cu_seqlens_k, query.shape[0],
                       key.shape[0], causal)
    out, _ = varlen_fwd_op(query.contiguous(), key.contiguous(),
                           value.contiguous(), *_plan_args(plan),
                           float(scale))
    return out


# ============================================================== flashmask

@dataclasses.dataclass(frozen=True)
class FlashmaskPlan:
    """What the flashmask kernels need besides q, k and v: int32 start and
    end rows ``st/en`` ``[B * col_heads, Sk]`` (key ``j`` bans query rows
    ``[st[j], en[j])``), their largest start and smallest end over each
    ``TILE``-column key tile's real columns ``st_max/en_min``
    ``[B * col_heads, ceil(Sk / TILE)]``, the batch's head count ``heads``,
    ``col_heads`` (1: one row per batch row, shared by its heads; else
    ``heads``) and the causal flag."""
    st: torch.Tensor
    en: torch.Tensor
    st_max: torch.Tensor
    en_min: torch.Tensor
    heads: int
    col_heads: int
    causal: bool

    def row(self, bh):
        """Index of the start/end row that grid head ``bh`` (an int or an
        int tensor) reads, as the kernels' ``at_head`` works it out."""
        return (bh // self.heads) * self.col_heads + (
            bh % self.heads if self.col_heads > 1 else 0)

    def select(self, bh: int) -> "FlashmaskPlan":
        """The plan of grid head ``bh`` alone, as a batch of one head."""
        r = self.row(bh)
        return FlashmaskPlan(self.st[r:r + 1], self.en[r:r + 1],
                             self.st_max[r:r + 1], self.en_min[r:r + 1], 1, 1,
                             self.causal)


def _check_startend(startend: torch.Tensor, b: int, h: int, sk: int,
                   device) -> None:
    """Raise unless ``startend`` is int32 or int64 ``[b, 1 or h, sk, 1 or
    2]`` on ``device``. Four columns (a bidirectional mask's upper band)
    are refused: the kernels, like the TPU's, read only start and end."""
    if startend.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"startend_row_indices: int32 or int64, got "
                        f"{startend.dtype}")
    shape = tuple(startend.shape)
    if len(shape) != 4 or shape[0] != b or shape[1] not in (1, h) \
            or shape[2] != sk or shape[3] not in (1, 2):
        raise ValueError(f"startend_row_indices: want [B, 1 or H, Sk, 1 or "
                         f"2] = [{b}, 1 or {h}, {sk}, 1 or 2], got "
                         f"{list(shape)} (four columns are not supported)")
    if startend.device != device:
        raise ValueError(f"startend_row_indices on {startend.device}, "
                         f"query on {device}")


def flashmask_plan(startend: torch.Tensor, heads: int,
                   causal: bool) -> FlashmaskPlan:
    """The plan for ``startend`` ``[B, 1 or heads, Sk, 1 or 2]`` (int32 or
    int64, taken as int32 as the TPU kernels take it), on its device, in
    O(B * heads * Sk) work. A one-column ``startend`` bans open-ended:
    ``en = INT32_MAX``, not ``Sk``, so query rows past the keys (Sq > Sk)
    stay banned."""
    b, hs, sk, cols = startend.shape
    idx = startend.to(torch.int32)
    st = idx[..., 0].reshape(b * hs, sk).contiguous()
    if cols > 1:
        en = idx[..., 1].reshape(b * hs, sk).contiguous()
    else:
        en = torch.full_like(st, INT32_MAX)
    nkt = _cdiv(sk, TILE)

    def per_tile(x, fill):
        # the padding columns past Sk take a value that moves neither
        # statistic: the kernels ban those columns themselves
        pad = x.new_full((x.shape[0], nkt * TILE - sk), fill)
        return torch.cat([x, pad], 1).view(x.shape[0], nkt, TILE)

    st_max = per_tile(st, -INT32_MAX - 1).amax(-1).contiguous()
    en_min = per_tile(en, INT32_MAX).amin(-1).contiguous()
    return FlashmaskPlan(st, en, st_max, en_min, int(heads), int(hs),
                         bool(causal))


def flashmask_tiles(plan: FlashmaskPlan, sq: int) -> torch.Tensor:
    """bool ``[B * col_heads, ceil(sq / TILE), ceil(Sk / TILE)]``: the
    (query tile, key tile) pairs every flashmask kernel visits for one
    start/end row: those in the causal range (key tile <= query tile) that
    some column of the key tile leaves open to some row of the query tile.
    The kernels' ``key_tiles``, ``query_tiles`` and ``tile_open`` in plain
    torch, for tests and for counting the work."""
    dev = plan.st_max.device
    q0 = torch.arange(_cdiv(sq, TILE), device=dev) * TILE
    q1 = torch.clamp(q0 + TILE, max=sq)
    banned = (plan.st_max[:, None, :] <= q0[None, :, None]) \
        & (plan.en_min[:, None, :] >= q1[None, :, None])
    tiles = ~banned
    if plan.causal:
        kt = torch.arange(plan.st_max.shape[1], device=dev)
        tiles = tiles & (kt[None, None, :] <= (q0 // TILE)[None, :, None])
    return tiles


def flashmask_mask(plan: FlashmaskPlan, bh: int, sq: int,
                   sk: int) -> torch.Tensor:
    """[bh, sq, sk] bool: key k seen by query q, from the plan's rows."""
    rows = plan.row(torch.arange(bh, device=plan.st.device))
    st, en = plan.st[rows][:, None, :], plan.en[rows][:, None, :]
    qp = torch.arange(sq, device=plan.st.device)[None, :, None]
    mask = ~((qp >= st) & (qp < en))
    if plan.causal:
        kp = torch.arange(sk, device=plan.st.device)[None, None, :]
        mask = mask & (kp <= qp)
    return mask


def _check_fm(name, q, k, v, plan: FlashmaskPlan) -> None:
    fa._check_shapes(q, k, v, k.shape[1])
    bh, sk = q.shape[0], k.shape[1]
    if q.shape[1] == 0 or sk == 0:
        raise ValueError(f"{name}: flashmask needs at least one query and "
                         f"one key")
    rows = bh // plan.heads * plan.col_heads
    want = ((plan.st, (rows, sk)), (plan.en, (rows, sk)),
            (plan.st_max, (rows, _cdiv(sk, TILE))),
            (plan.en_min, (rows, _cdiv(sk, TILE))))
    if bh % plan.heads or any(
            t.dtype != torch.int32 or t.device != q.device
            or not t.is_contiguous() or tuple(t.shape) != shape
            for t, shape in want):
        raise ValueError(f"{name}: the plan ({plan.heads} heads, "
                         f"{plan.col_heads} start/end rows per batch row, "
                         f"{tuple(plan.st.shape)} on {plan.st.device}) does "
                         f"not fit q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"on {q.device}")


def _fm_args(q, k, plan: FlashmaskPlan):
    """The plan's arrays, then bh, h, hs, sq, sk, d."""
    bh, sq, d = q.shape
    return ((plan.st, plan.en, plan.st_max, plan.en_min),
            (bh, plan.heads, plan.col_heads, sq, k.shape[1], d))


def flashmask_fwd_plain(q, k, v, plan: FlashmaskPlan,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch on ``[BH, S, D]``:
    out (0 on rows that see no key) and fp32 lse ``[BH, Sq, 1]`` (0 on
    those rows)."""
    mask = flashmask_mask(plan, q.shape[0], q.shape[1], k.shape[1])
    out, m, l = fa.masked_fwd_plain(q, k, v, mask, scale)
    lse = torch.where(l == 0.0, 0.0,
                      m + torch.log(torch.where(l == 0.0, 1.0, l)))
    return out, lse


def flashmask_bwd_dkv_plain(q, k, v, do, lse, delta, plan: FlashmaskPlan,
                            scale: float):
    """dK, dV in plain PyTorch, fp32 throughout, written in the io type."""
    mask = flashmask_mask(plan, q.shape[0], q.shape[1], k.shape[1])
    return fa.masked_bwd_dkv_plain(q, k, v, do, lse, delta, mask, scale)


def flashmask_bwd_dq_plain(q, k, v, do, lse, delta, plan: FlashmaskPlan,
                           scale: float):
    """dQ in plain PyTorch, fp32 throughout, written in the io type."""
    mask = flashmask_mask(plan, q.shape[0], q.shape[1], k.shape[1])
    return fa.masked_bwd_dq_plain(q, k, v, do, lse, delta, mask, scale)


def flashmask_fwd(q, k, v, plan: FlashmaskPlan,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flashmask attention forward on ``[BH, S, D]``: returns ``out`` (io
    type) and ``lse`` (fp32, ``[BH, Sq, 1]``)."""
    _check_fm("flashmask_fwd", q, k, v, plan)
    if not _dispatch(q):
        return flashmask_fwd_plain(q, k, v, plan, scale)
    _check_cuda("flashmask_fwd", (q, k, v))

    def run(q, k, v):
        q, k, v = _tma_inputs(q, k, v)
        arrays, sizes = _fm_args(q, k, plan)
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[0], q.shape[1], 1), device=q.device,
                          dtype=torch.float32)
        _launch("flashmask_fwd", (q, k, v, out, lse) + arrays,
                sizes, q, plan.causal, scale)
        return out, lse

    return _pad_head_dim(run, q, k, v)


def flashmask_bwd_dkv(q, k, v, do, lse, delta, plan: FlashmaskPlan,
                      scale: float):
    """dK and dV of flashmask attention, from the forward's lse and
    ``delta = rowsum(dO * O)``."""
    _check_fm("flashmask_bwd_dkv", q, k, v, plan)
    fa._check_bwd("flashmask_bwd_dkv", q, do, lse, delta)
    if not _dispatch(q):
        return flashmask_bwd_dkv_plain(q, k, v, do, lse, delta, plan, scale)
    _check_cuda("flashmask_bwd_dkv", (q, k, v, do), (lse, delta))

    def run(q, k, v, do):
        q, k, v, do = _tma_inputs(q, k, v, do)
        arrays, sizes = _fm_args(q, k, plan)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _launch("flashmask_bwd_dkv", (q, k, v, do, lse, delta, dk, dv)
                + arrays, sizes, q, plan.causal, scale)
        return dk, dv

    return _pad_head_dim(run, q, k, v, do)


def flashmask_bwd_dq(q, k, v, do, lse, delta, plan: FlashmaskPlan,
                     scale: float):
    """dQ of flashmask attention, from the forward's lse and ``delta``."""
    _check_fm("flashmask_bwd_dq", q, k, v, plan)
    fa._check_bwd("flashmask_bwd_dq", q, do, lse, delta)
    if not _dispatch(q):
        return flashmask_bwd_dq_plain(q, k, v, do, lse, delta, plan, scale)
    _check_cuda("flashmask_bwd_dq", (q, k, v, do), (lse, delta))

    def run(q, k, v, do):
        q, k, v, do = _tma_inputs(q, k, v, do)
        arrays, sizes = _fm_args(q, k, plan)
        dq = torch.empty_like(q)
        _launch("flashmask_bwd_dq", (q, k, v, do, lse, delta, dq) + arrays,
                sizes, q, plan.causal, scale)
        return dq

    return _pad_head_dim(run, q, k, v, do)


_FM_PLAN = ("Tensor st, Tensor en, Tensor st_max, Tensor en_min, int heads, "
            "int col_heads, bool causal, float scale")


def _flashmask_op(wrapper_name, n_in):
    """A flashmask entry taking the plan's arrays, heads and causal flag in
    place of a ``FlashmaskPlan``: the wrapper of that name, looked up at
    each call."""
    def impl(*args):
        *rest, scale = args
        return globals()[wrapper_name](*rest[:n_in],
                                       FlashmaskPlan(*rest[n_in:]), scale)
    return impl


flashmask_bwd_dkv_op = define(
    "flashmask_bwd_dkv", f"({_BWD_IN}, {_FM_PLAN}) -> (Tensor, Tensor)",
    _flashmask_op("flashmask_bwd_dkv", 6),
    lambda q, k, v, *_: (torch.empty_like(k), torch.empty_like(v)))
flashmask_bwd_dq_op = define(
    "flashmask_bwd_dq", f"({_BWD_IN}, {_FM_PLAN}) -> Tensor",
    _flashmask_op("flashmask_bwd_dq", 6),
    lambda q, *_: torch.empty_like(q))
flashmask_fwd_op = define(
    "flashmask_fwd", f"(Tensor q, Tensor k, Tensor v, {_FM_PLAN}) -> "
    "(Tensor, Tensor)", _flashmask_op("flashmask_fwd", 3),
    lambda q, *_: (torch.empty_like(q), fa._lse_like(q)),
    _packed_backward(fa.attention_delta, flashmask_bwd_dkv_op,
                     flashmask_bwd_dq_op),
    _save_packed)


def flashmask_attention_kernel(query, key, value, startend,
                               scale: Optional[float] = None,
                               causal: bool = True) -> torch.Tensor:
    """Differentiable flashmask attention in paddle's layout: query
    ``[B, Sq, H, D]``, key and value ``[B, Sk, H, D]``, ``startend``
    ``[B, 1 or H, Sk, 1 or 2]`` on the query's device. Like the TPU
    ``_flashmask_body``, moves the heads to ``[B*H, S, D]`` with one copy
    per tensor; returns ``[B, Sq, H, D]``."""
    if query.dim() != 4:
        raise ValueError(f"flashmask attention takes [B, S, H, D] tensors, "
                         f"got query {tuple(query.shape)}")
    b, sq, h, d = query.shape
    sk = key.shape[1]
    if tuple(key.shape) != (b, sk, h, d) or value.shape != key.shape:
        raise ValueError(f"shape mismatch: query {tuple(query.shape)}, key "
                         f"{tuple(key.shape)}, value {tuple(value.shape)}")
    _check_startend(startend, b, h, sk, query.device)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    plan = flashmask_plan(startend, h, causal)
    q, k, v = (x.transpose(1, 2).reshape(b * h, x.shape[1], d).contiguous()
               for x in (query, key, value))
    out, _ = flashmask_fwd_op(q, k, v, plan.st, plan.en, plan.st_max,
                              plan.en_min, plan.heads, plan.col_heads,
                              plan.causal, float(scale))
    return out.view(b, h, sq, d).transpose(1, 2)


register_op("flash_attn_varlen", flash_attn_varlen)
register_op("flashmask_attention", flashmask_attention_kernel)
