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
and accumulators are fp32; the io type is float32, bfloat16 or float16.
The kernels are built for head_dim 32, 64, 128 and 256 (``HEAD_DIMS``); a
smaller head_dim runs at the next of those sizes, its q, k, v (and dO)
padded with zero columns and the results sliced back (:func:`_pad_head_dim`),
which is exact. At 256 every io type runs the FMA kernels (bf16 too: there
is no tensor-core instantiation at 256 yet), whose backward then works on
32-row halves of its 64-row tiles so that the fp32 tiles fit in shared
memory. A head_dim above 256 runs padded to a multiple of 256 on the same
FMA kernels split over it: one block per 256-column chunk of each output,
the scores over the whole head_dim recomputed by each. Any number of heads
(``B*H``) runs: the C entries launch at most 65535 of them at a time. The
causal mask is bottom-right aligned (key ``k`` is seen by query ``q`` when
``k <= q + (Sk - Sq)``) and keys at or past ``kv_len`` are masked. A query
row that sees no key at all gets output 0 and lse -1e30 from the kernel;
:func:`mha_forward` then gives such rows what the reference gives them
(:func:`reference_keyless_rows`).

Each wrapper dispatches on the device of its tensors: a CUDA tensor launches
the kernel (or raises on a type, head_dim or layout the kernel does not
take), a CPU tensor runs the plain PyTorch version beside it, which repeats
the kernel's arithmetic. There is no fallback from one to the other. Each
source holds two kernels: bf16 io up to head_dim 128 runs on the tensor cores and reads q, k,
v and dO through TMA tensor maps, which need 16-byte-aligned base addresses
and strides (:func:`check_tma`; a tensor that fails it is handed to the
kernel as a fresh contiguous copy, :func:`_tma_inputs`); float and float16
io run fp32 FMAs.
``LAUNCHES`` counts kernel launches per wrapper; the plain versions do not
count.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ._build import function

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)  # the head_dims the kernels are built for
# the io code of each dtype in the C entries (csrc/flash_common.cuh `Io`)
_IO_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ C interface

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q k v o lse | bh sq sk d io causal scale kv_len q_offset | stream
    "flash_fwd": ("pt_flash_fwd", [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P]),
    # q k v do lse delta dk dv | ...
    "flash_bwd_dkv": ("pt_flash_bwd_dkv",
                      [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P]),
    # q k v do lse delta dq | ...
    "flash_bwd_dq": ("pt_flash_bwd_dq", [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]),
}

def io_code(dtype: torch.dtype) -> int:
    """The C entries' io argument for tensors of ``dtype``."""
    return _IO_CODES[dtype]


def _launch(name: str, tensors, bh, sq, sk, d, causal, scale, kv_len,
            q_offset) -> None:
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    with torch.cuda.device(tensors[0].device):
        err = function(name, *_SIGNATURES[name])(
            *[t.data_ptr() for t in tensors], bh, sq, sk, d,
            io_code(tensors[0].dtype), int(causal), float(scale),
            int(kv_len), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{torch.cuda.CudaError(err)}")
    LAUNCHES[name] += 1


def _check_cuda(name: str, io, stats=()) -> None:
    """Raise on inputs the CUDA kernel does not take. ``io`` are the
    tensors in the io type (q first), ``stats`` the fp32 rows (lse,
    delta)."""
    q = io[0]
    if q.dtype not in _IO_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported on CUDA "
                        f"(float32, bfloat16 or float16)")
    if q.shape[-1] < 1:
        raise ValueError(f"{name}: head_dim 0")
    for t in tuple(io) + tuple(stats):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             f"tensors")
    for t in io:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {q.dtype} and {t.dtype}")


def check_tma(*tensors: torch.Tensor) -> bool:
    """Whether every tensor can be read through a TMA tensor map, as the
    bf16 kernels read q, k, v and dO: its base address and the byte
    strides of its outer dimensions multiples of 16 bytes. A plain check
    on the tensor's metadata, on any device."""
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        if any(st * t.element_size() % 16 for st in t.stride()[:-1]):
            return False
    return True


def _tma_inputs(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors a kernel reads, each as it is unless it is bf16 and
    :func:`check_tma` refuses it; then a fresh contiguous copy, whose
    storage PyTorch allocates aligned. Inputs reach the kernels contiguous
    with a head_dim of 32, 64, 128 or a multiple of 256, so every stride is
    a multiple of 16 bytes and the base address is the only case left: the
    same kernel runs on the copy."""
    return tuple(t if t.dtype != torch.bfloat16 or check_tma(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in tensors)


def kernel_head_dim(d: int) -> int:
    """The head_dim the kernels run at for a caller's ``d``: the smallest
    of ``HEAD_DIMS`` at or above it, and above 256 the next multiple of
    256 (the FMA kernels split over it in 256-column chunks)."""
    for size in HEAD_DIMS:
        if d <= size:
            return size
    return -(-d // HEAD_DIMS[-1]) * HEAD_DIMS[-1]


def _pad_head_dim(run, *io: torch.Tensor):
    """``run(*io)`` at the kernels' head_dim: each tensor of ``io`` (q-like
    and k-like, head_dim last) padded with zero columns up to
    :func:`kernel_head_dim`, and each result whose last dimension is that
    size sliced back to the caller's head_dim (lse and delta rows pass as
    they are). Exact: zero columns change no product of ``Q K^T`` or
    ``dO V^T`` and leave ``rowsum(dO * O)`` as it is, the scale is the
    caller's, and the padded columns of out, dQ, dK and dV come out 0. A
    plain function: the CPU tests run it around the plain versions."""
    d = io[0].shape[-1]
    size = kernel_head_dim(d)
    if size == d:
        return run(*io)
    out = run(*(torch.nn.functional.pad(t, (0, size - d)) for t in io))
    cut = lambda t: t[..., :d].contiguous() if t.shape[-1] == size else t
    return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)


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


def masked_fwd_plain(q, k, v, mask, scale: float):
    """The forward kernels' arithmetic on ``[BH, S, D]`` under a bool mask
    ``[BH or 1, Sq, Sk]``: fp32 logits, P rounded to the io type before
    P.V. Returns out (io type; 0 on a row that sees no key) and the fp32
    row max m and row sum l, ``[BH, Sq, 1]``."""
    s = _scores(q, k, scale).masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bqk,bkd->bqd", p.to(q.dtype).float(), v.float())
    return (acc / l_safe).to(q.dtype), m, l


def flash_fwd_plain(q, k, v, causal: bool, scale: float, kv_len: int,
                    q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: fp32 logits, P
    rounded to the io type before P.V, lse in fp32 ``[BH, Sq, 1]``."""
    mask = _mask(q.shape[1], k.shape[1], causal, kv_len, q_offset, q.device)
    out, m, l = masked_fwd_plain(q, k, v, mask, scale)
    return out, m + torch.log(torch.where(l == 0.0, 1.0, l))


def _p_ds(q, k, v, do, lse, delta, mask, scale):
    p = torch.where(mask, torch.exp(_scores(q, k, scale) - lse), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta) * scale


def masked_bwd_dkv_plain(q, k, v, do, lse, delta, mask, scale: float):
    """The dK/dV kernels' arithmetic under a bool mask, fp32 throughout,
    written in the io type."""
    p, ds = _p_ds(q, k, v, do, lse, delta, mask, scale)
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def masked_bwd_dq_plain(q, k, v, do, lse, delta, mask, scale: float):
    """The dQ kernels' arithmetic under a bool mask, fp32 throughout,
    written in the io type."""
    _, ds = _p_ds(q, k, v, do, lse, delta, mask, scale)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                        kv_len: int, q_offset: int):
    """dK, dV in plain PyTorch, fp32 throughout, written in the io type."""
    mask = _mask(q.shape[1], k.shape[1], causal, kv_len, q_offset, q.device)
    return masked_bwd_dkv_plain(q, k, v, do, lse, delta, mask, scale)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                       kv_len: int, q_offset: int):
    """dQ in plain PyTorch, fp32 throughout, written in the io type."""
    mask = _mask(q.shape[1], k.shape[1], causal, kv_len, q_offset, q.device)
    return masked_bwd_dq_plain(q, k, v, do, lse, delta, mask, scale)


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

    def run(q, k, v):
        q, k, v = _tma_inputs(q, k, v)
        bh, sq, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((bh, sq, 1), device=q.device, dtype=torch.float32)
        _launch("flash_fwd", (q, k, v, out, lse), bh, sq, k.shape[1], d,
                causal, scale, kv_len, q_offset)
        return out, lse

    return _pad_head_dim(run, q, k, v)


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

    def run(q, k, v, do):
        q, k, v, do = _tma_inputs(q, k, v, do)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        bh, sq, d = q.shape
        _launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), bh, sq,
                k.shape[1], d, causal, scale, kv_len, q_offset)
        return dk, dv

    return _pad_head_dim(run, q, k, v, do)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 kv_len: int, q_offset: int):
    """dQ of attention, from the forward's lse and ``delta``."""
    _check_shapes(q, k, v, kv_len)
    _check_bwd("flash_bwd_dq", q, do, lse, delta)
    if not _dispatch(q):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                  kv_len, q_offset)
    _check_cuda("flash_bwd_dq", (q, k, v, do), (lse, delta))

    def run(q, k, v, do):
        q, k, v, do = _tma_inputs(q, k, v, do)
        dq = torch.empty_like(q)
        bh, sq, d = q.shape
        _launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq), bh, sq,
                k.shape[1], d, causal, scale, kv_len, q_offset)
        return dq

    return _pad_head_dim(run, q, k, v, do)


# ---------------------------------------------- the reference's keyless rows

# the reference's default FLAGS_flash_block_q / FLAGS_flash_block_k
REF_BLOCK_CAP = 512


def reference_block_sizes(sq: int, sk: int, cap: int = REF_BLOCK_CAP):
    """The reference's query and key block sizes (``_block_sizes`` in
    ``paddle_tpu/ops/pallas/flash_attention.py``) at its default caps: a
    function of the shapes alone."""
    bq = min(cap, sq) if sq % cap == 0 else min(128, sq)
    bk = min(cap, sk) if sk % cap == 0 else min(128, sk)
    return (bq if sq % bq == 0 else sq), (bk if sk % bk == 0 else sk)


@torch.no_grad()
def reference_keyless_rows(out: torch.Tensor, v: torch.Tensor) -> None:
    """Gives the rows of a causal ``[BH, Sq, D]`` output with Sq > Sk that
    see no key (the first Sq - Sk) what the reference gives them, in place.

    The kernels write those rows 0. The reference runs its key loop over
    every key block the query block reaches, with the mask fill -1e30
    finite: on a row whose logits are all masked, ``exp(s - m)`` is 1 for
    every key it visits, so the row comes out as the mean of v over the
    visited blocks, ``n = min((qi bq + bq - 1 + Sk - Sq) // bk + 1, Sk //
    bk)`` of them for query block ``qi``, rounded to the io type as its
    ``acc / l`` is; a block where n <= 0 stays 0. The lse is -1e30 on both
    sides, and the reference's backward masks p to 0 on those rows, so
    gradients are the kernels' as they are: this runs outside autograd."""
    sq, sk = out.shape[1], v.shape[1]
    bq, bk = reference_block_sizes(sq, sk)
    for qi in range((sq - sk + bq - 1) // bq):
        n = min((qi * bq + bq - 1 + sk - sq) // bk + 1, sk // bk)
        if n > 0:
            mean = v[:, :n * bk].float().mean(1, keepdim=True)
            out[:, qi * bq:min(qi * bq + bq, sq - sk)] = mean.to(out.dtype)


# --------------------------------------------------------------- public

class _MHA(torch.autograd.Function):
    """The TPU package's ``_mha`` custom VJP: the forward launches the
    forward kernel, gives rows that see no key the reference's output
    (:func:`reference_keyless_rows`) and saves ``(q, k, v, out, lse)``; the
    backward launches dK/dV, then dQ."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        sq, sk = q.shape[1], k.shape[1]
        out, lse = flash_fwd(q, k, v, causal, scale, kv_len=sk,
                             q_offset=sk - sq)
        if causal and sq > sk:
            reference_keyless_rows(out, v)
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
