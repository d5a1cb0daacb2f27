"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printed as it runs:

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. builds the flash-attention kernels (forward, dK/dV and dQ, each
   fixed-length, varlen and flashmask; each a bf16 tensor-core kernel and
   an fp32/fp16 FMA kernel) and the RMSNorm and SwiGLU kernels from the
   four sources of ``paddle_tpu_torch/csrc`` (``nvcc``, ``sm_90a``, one
   process per source, all at once), printing build seconds and ptxas's
   register and shared-memory lines (a spill in a tensor-core kernel at
   head_dim 64 fails the run), and counting the ``HGMMA`` (tensor-core
   product, split by product) and ``UTMALDG`` (TMA load) instructions in
   the SASS of each bf16 forward, dQ and dK/dV instantiation
   (``cuobjdump``);
3. holds each kernel against its plain PyTorch version: the fixed-length
   ones at the training shape (``[8, 16, 1024, 64]`` bf16, causal) and at
   a cross shape (sq 128, sk 256, causal, head_dim 32, fp32); the varlen
   ones at the packed shape (8192 tokens of ten documents, 16 heads,
   head_dim 64, bf16, causal; the plain version one head at a time) and at
   an edge shape (fp32, head_dim 128, cu_q != cu_k, an empty segment on
   each side, padding rows; causal and not); the flashmask ones at their
   path shape (batch 2 x seq 4096, 16 heads x 64, bf16, causal, a
   share-question and a document mask shared by the heads; the plain
   version one batch row and head at a time) and at an edge shape (fp32,
   head_dim 128, per-head two-column start/end rows, sq 200 != sk 136;
   causal and not). At the edge shapes the rows that see no key must give
   out, lse and dq of exactly 0. The bf16 tensor-core kernels, forward and
   backward, at edge shapes, head_dim 32, 64 and 128: query tiles visiting
   more key tiles than the ring has stages, sq != sk both ways, kv_len
   cutting a tile, a varlen plan with an empty segment and one-token
   segments, a flashmask row that leaves one key tile open (keys no query
   sees must give dk and dv of exactly 0). fp16 io (the FMA kernels) and a
   head_dim of 80 (run at 128 with zero columns) for the three masks,
   forward and backward, and bf16 inputs on a misaligned base (the same
   kernels on aligned copies, bit for bit). RMSNorm and SwiGLU at the
   fused-op path's tensors (Llama-2-7B widths, 8192 tokens, bf16) and at
   edge shapes (fp32 and fp16, 37 rows, rows of 1000 and 1003, a float32
   weight or gate beside bf16 x, the split form with unaligned halves).
   head_dim 256 and 160 (run at 256) for the three masks in fp32, bf16 and
   fp16, forward and backward (the FMA kernels at 256); head_dim 288 (run
   at 512) and 512 the same way (the FMA kernels split over 256-column
   chunks); 65600 fixed-length heads (more than the grid's 65535 on its y
   axis) in bf16 and fp32; and rows that see no key under ``mha_forward``
   (causal, sq > sk) against the CPU path.
   Phases 3 and 4 each run under a watchdog that exits non-zero if a
   kernel hangs;
4. times each kernel, its plain version and, as a yardstick only,
   ``scaled_dot_product_attention`` (which the port never calls; for the
   varlen and flashmask kernels with the dense bool mask) and
   ``torch.nn.functional.rms_norm``, beside the least time the card could
   take for the same work; then the three masks' kernels again at
   head_dim 256 and at 512 (16 heads, bf16, the same tokens), with the
   FMA kernels' shared memory per block;
5. checks the training step on a small GPT against the port's CPU path
   (the path the CPU tests hold against the JAX package), then drives the
   main path: gpt2-medium at full width (24 layers, hidden 1024), batch 8,
   seq 1024, bf16 params, fp32 master, remat per block, AdamW, 1 warm-up
   and 5 timed steps, and checks that every step launched 48 forward, 24
   dK/dV and 24 dQ kernels;
   one more step under ``torch.profiler`` splits the device time by
   phase (forward, backward, optimizer) and by kernel group;
6. drives the varlen path: ``nn.functional.flash_attn_unpadded`` forward
   and backward at the packed shape, checks that it launched each varlen
   kernel exactly once and gave the checked kernels' results bit for bit,
   and times it;
7. drives the flashmask path: ``nn.functional.flashmask_attention``
   forward and backward at its path shape, checks that it launched each
   flashmask kernel exactly once and gave the checked kernels' results bit
   for bit, holds its document-mask batch row against
   ``flash_attn_unpadded`` over the same documents, and times it;
8. drives the fused-op path: the MLP half of a Llama-2-7B decoder layer
   over 8192 tokens through ``incubate.nn.functional`` (``fused_rms_norm``
   with a residual, the gate/up product, the split ``swiglu``, the down
   product), forward and backward; checks one launch of each kernel, the
   kernels' phase-3 results bit for bit, the output and gradients against
   the same composition through the plain versions, and times it;
9. drives the LLaMA path: a small fp32 LLaMA step against the port's CPU
   path, then Llama-2-7B's widths with the depth cut to 8 layers, batch 4,
   seq 2048, bf16, fp32 master, remat, AdamW, 1 warm-up and 5 timed steps;
   checks that no port kernel launched (the reference's LLaMA calls
   none), and profiles one step;
10. drives the eager API: a small fp32 eager GPT step on the card against
   the port's CPU eager path, then ``GPTForPretraining`` at gpt2-medium's
   full width and depth through ``paddle_tpu_torch`` as a user writes it
   (fp32 parameters, ``amp.auto_cast`` bf16 O1, ``optimizer.AdamW`` lr
   1e-4, no recompute, batch 8 x seq 1024), 1 warm-up and 5 timed steps;
   checks 24 launches each of the forward, dK/dV and dQ kernels a step,
   all bf16 at head_dim 64, and no other port kernel; compares its median
   with phase 5's and profiles one step;
11. drives the eager vision path: ``resnet18(num_classes=10)`` on 4 x 3 x
   64 x 64, three Momentum steps on the card against the port's CPU path
   in float64 and in fp32; then ``bench_suite.py``'s ResNet-50 workload
   eagerly (``resnet50()``, fp32 parameters, batch 64 x 3 x 224 x 224,
   O1 bf16, ``optimizer.Momentum(0.1)``), 1 warm-up and 5 timed steps;
   checks finite losses that fall below the first, every BN buffer moved
   and finite, and no port kernel launched (the path has no TPU kernel);
   prints ms/step, images/s, MFU from the model's own conv and linear
   shapes, peak memory, and one profiled step's idle share and split by
   phase and by kernel group (convolution, layout transposes, BN
   statistics, pooling, elementwise and casts, optimizer);
12. prints the head_dim 256 and 512 timings, the ``kernels`` JSON line,
   the card line, and last ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. It never falls back
to the CPU or to a plain version: with no CUDA device it exits 1 before
doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
DEVICE_BYTES = 80e9        # H100 SXM device memory
BATCH, SEQ, HEADS, HEAD_DIM = 8, 1024, 16, 64
TIMED_STEPS = 5
PHASES = ("forward", "optimizer")  # the trainer's profiler ranges
# the varlen path: one step's 8 x 1024 tokens packed as ten documents of
# lengths that mostly straddle the kernels' 64-row tiles
DOCS = [1024, 37, 611, 2048, 129, 1500, 700, 64, 300, 1779]
# the varlen edge shape: query and key segment lengths (segment 1 has keys
# and no query, segment 4 queries and no key), padding query and key rows
EDGE = ([70, 0, 45, 130, 20], [90, 33, 60, 2, 0], 15, 5)
# the flashmask path: batch 2 x seq 4096 (one step's 8192 tokens), a
# startend [2, 1, 4096, 1] shared by the heads, as PaddleNLP builds it.
# Batch row 0: a share-question mask of three DPO-style groups (prompt,
# answers); batch row 1: a causal document mask.
FM_SEQ = 4096
FM_GROUPS = [(512, [300, 180, 420]), (260, [700, 90]), (1000, [333, 301])]
FM_DOCS = [1024, 37, 611, 2048, 129, 247]
# the fused-op path: widths of this LLaMA config over one step's tokens
FUSED_CFG, FUSED_TOKENS = "llama2-7b", (4, 2048)
# the LLaMA path: this config with its depth cut to LLAMA_LAYERS (all 32
# layers' weights, fp32 master and moments, 108 GB, exceed one card)
LLAMA_CFG, LLAMA_LAYERS, LLAMA_BATCH, LLAMA_SEQ = "llama2-7b", 8, 4, 2048
# per kernel: (module source, TPU kernel it replaces)
KERNELS = {
    "flash_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                  "paddle_tpu/ops/pallas/flash_attention.py:68"),
    "flash_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd_dkv.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:156"),
    "flash_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd_dq.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:205"),
    "rms_norm": ("paddle_tpu_torch/csrc/fused.cu",
                 "paddle_tpu/ops/pallas/fused.py:33"),
    "swiglu": ("paddle_tpu_torch/csrc/fused.cu",
               "paddle_tpu/ops/pallas/fused.py:108"),
    "varlen_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                   "paddle_tpu/ops/pallas/flash_varlen.py:117"),
    "varlen_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd_dkv.cu",
                       "paddle_tpu/ops/pallas/flash_varlen.py:161"),
    "varlen_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd_dq.cu",
                      "paddle_tpu/ops/pallas/flash_varlen.py:207"),
    "flashmask_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                      "paddle_tpu/ops/pallas/flash_varlen.py:385"),
    "flashmask_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd_dkv.cu",
                          "paddle_tpu/ops/pallas/flash_varlen.py:446"),
    "flashmask_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd_dq.cu",
                         "paddle_tpu/ops/pallas/flash_varlen.py:506"),
}
VARLEN = ("varlen_fwd", "varlen_bwd_dkv", "varlen_bwd_dq")
FLASHMASK = ("flashmask_fwd", "flashmask_bwd_dkv", "flashmask_bwd_dq")
FUSED = ("rms_norm", "swiglu")


def share_question_starts(groups) -> np.ndarray:
    """Start row per key of a share-question mask (one column, the ban is
    open-ended): a prompt key is hidden from its group's end on, an answer
    key from its answer's end on, so each answer sees its prompt and
    itself, causally."""
    starts = []
    for prompt, answers in groups:
        starts += [len(starts) + prompt + sum(answers)] * prompt
        for n in answers:
            starts += [len(starts) + n] * n
    return np.array(starts, np.int32)


def document_starts(lens) -> np.ndarray:
    """Start row per key of a causal document mask: a key is hidden from
    its document's end on."""
    starts = []
    for n in lens:
        starts += [len(starts) + n] * n
    return np.array(starts, np.int32)


def flashmask_startend() -> np.ndarray:
    """The flashmask path's startend, int32 [2, 1, FM_SEQ, 1]."""
    rows = [share_question_starts(FM_GROUPS), document_starts(FM_DOCS)]
    assert all(len(r) == FM_SEQ for r in rows)
    return np.stack(rows)[:, None, :, None]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


@contextlib.contextmanager
def watchdog(what: str, seconds: float):
    """Ends the process with code 3 if the block runs past ``seconds``: a
    kernel whose producer and consumer disagree on the tiles would wait on
    the card forever, and the synchronize after it with it."""
    def expire():
        print(f"watchdog: {what} still running after {seconds:.0f} s; "
              f"exiting", flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases

def card():
    phase("1 card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device {name} count {count} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    # the plain versions are fp32 references: no TF32 in their products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, count, smi


def build():
    from paddle_tpu_torch.ops.cuda import _build
    phase("2 build")
    t0 = time.perf_counter()
    infos = _build.build()
    wall = time.perf_counter() - t0
    for name, info in infos.items():
        print(f"built {name} in {info.seconds:.1f} s -> "
              f"{info.path.name}")
        for line in info.ptxas:
            print(f"  {line}")
    print(f"build wall {wall:.1f} s (nvcc processes run in parallel; each "
          f"flash library holds a bf16 tensor-core kernel and an fp32/fp16 "
          f"FMA kernel, each in a fixed-length, a varlen and a flashmask "
          f"instantiation, the fused one RMSNorm and SwiGLU)")
    check(set(infos) == set(_build.SOURCES), f"built {sorted(infos)}")
    for name in HOPPER_KERNELS:
        for entry, stores, loads in hopper_spills(infos[name].ptxas):
            check(stores == 0 and loads == 0, f"ptxas spills {stores} / "
                  f"{loads} bytes in {entry} (head_dim 64)")
    sass_counts(infos)


def hopper_spills(ptxas):
    """(entry, spill store bytes, spill load bytes) of each bf16
    tensor-core instantiation at head_dim 64 (the main path's) in
    ptxas's ``-v`` lines: each entry's "Compiling entry" line comes
    before its spill line."""
    out, entry = [], None
    for line in ptxas:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry and "_hopperILi64E" in entry:
            out.append((entry, int(m.group(1)), int(m.group(2))))
            entry = None
    return out


# per library: the bf16 tensor-core kernel's name, and what its HGMMA
# products from descriptors alone and with the transpose bit (.tnspB: the
# A operand from registers, B MN-major) compute
HOPPER_KERNELS = {
    "flash_fwd": ("flash_fwd_hopper", "S = QK^T", "O += PV"),
    "flash_bwd_dq": ("flash_bwd_dq_hopper", "S = QK^T and dP = dO V^T",
                     "dQ += dS K, hi and lo"),
    "flash_bwd_dkv": ("flash_bwd_dkv_hopper", "S^T = K Q^T and dP^T = V dO^T",
                      "dV += P^T dO and dK += dS^T Q, hi and lo"),
}


def sass_counts(infos):
    """Counts the tensor-core products (``HGMMA``, split by product) and
    TMA tile loads (``UTMALDG``) in the SASS of each bf16 instantiation
    (forward, dQ, dK/dV) of the built libraries; each must have both. The
    toolkit's ``cuobjdump`` reads the SASS; without it the count is
    skipped and said so."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("cuobjdump not found: SASS counts skipped")
        return
    for lib, (kernel, from_desc, from_regs) in HOPPER_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(infos[lib].path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        hopper = [f for f in funcs if kernel in f.split("\n", 1)[0]]
        check(len(hopper) == 9, f"{len(hopper)} {kernel} instantiations in "
              f"the SASS, want 9 (3 masks x 3 head_dims)")
        for f in hopper:
            name = f.split("\n", 1)[0].strip()
            mma = re.findall(r"HGMMA\.(\d+x\d+x\d+)\S* ([^;]*);", f)
            n_regs = sum("tnspB" in ops for _, ops in mma)
            n_desc, n_tma = len(mma) - n_regs, f.count("UTMALDG")
            shapes = sorted(set(shape for shape, _ in mma))
            print(f"  SASS {name}: HGMMA {len(mma)} ({n_desc} for "
                  f"{from_desc}, {n_regs} for {from_regs}; "
                  f"{', '.join(shapes)}), UTMALDG {n_tma}")
            check(n_desc > 0 and n_regs > 0 and n_tma > 0, f"{name}: HGMMA "
                  f"{n_desc} + {n_regs}, UTMALDG {n_tma}")


def _inputs(bh, sq, sk, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(s):
        return torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)

    return rnd(sq), rnd(sk), rnd(sk), rnd(sq)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def limit(dtype, key, want, abs_v_out=None, d=64):
    """Per-element bound on |kernel - plain| for output ``key``.

    fp32 io: the two differ only in summation order, 1e-5 absolute on
    unit-scale inputs up to head_dim 256; above it the logits sum over
    ``kernel_head_dim(d)`` columns (512 for 288 and 512), in chunks, and
    the bound grows with the sum: 1e-5 per 256 columns. lse is fp32 at
    either io type (1e-4 in bf16, whose
    logits come from bf16 q and k). bf16 outputs: both sides compute in
    fp32 and round once, so an element may sit one bf16 ulp of itself
    apart (2^-7 |x|), plus fp32 summation noise, held at 1e-4 of the
    largest element. The forward also rounds P to bf16 against a running
    rather than the final max, which moves each term of P.V by at most
    2^-8 p|v| and l by 2^-8 of itself: ``abs_v_out`` is the plain output
    with |V| (sum_j p_j |v_j| / l). fp16 outputs: the same at fp16's ulp
    (2^-10 |x|, P's rounding 2^-11)."""
    if key == "lse" or dtype == torch.float32:
        if key == "lse" and dtype == torch.bfloat16:
            return 1e-4
        from paddle_tpu_torch.ops.cuda import flash_attention as fa
        return 1e-5 * max(1, fa.kernel_head_dim(d) // 256)
    ulp, p_round = (2 ** -7, 2 ** -8) if dtype == torch.bfloat16 \
        else (2 ** -10, 2 ** -11)
    want = want.float().abs()
    lim = ulp * want + 1e-4 * want.max()
    if key == "out":
        lim = lim + p_round * (want + abs_v_out.float())
    return lim


def within(got, want, lim):
    """(max abs error, max error / limit) over all elements."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), (err / lim).max().item()


def hold_against_plain(bh, sq, sk, d, dtype, causal, seed):
    """Runs each kernel and its plain version on the same inputs; returns
    the max abs error per kernel (over all its outputs)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do = _inputs(bh, sq, sk, d, dtype, seed)
    args = (causal, 1.0 / math.sqrt(d), sk, sk - sq)
    out, lse = fa.flash_fwd(q, k, v, *args)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    abs_v_out = fa.flash_fwd_plain(q, k, v.abs(), *args)[0]
    delta = fa.attention_delta(do, out)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    p_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    pairs = {"out": (out, p_out), "lse": (lse, p_lse), "dq": (dq, p_dq),
             "dk": (dk, p_dk), "dv": (dv, p_dv)}
    errs, ratios = {}, {}
    for key, (got, want) in pairs.items():
        errs[key], ratios[key] = within(
            got, want, limit(dtype, key, want, abs_v_out, d))
    shape = f"bh {bh} sq {sq} sk {sk} d {d} {dtype} causal {causal}"
    print(f"{shape}: max abs err " + " ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + "; of the limit " +
        " ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
    for key, ratio in ratios.items():
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"{key} at {ratio:.3g} of its limit at {shape}")
    for t in (out, lse, dq, dk, dv):
        check(bool(torch.isfinite(t.float()).all()), f"non-finite at {shape}")
    return {"flash_fwd": max(errs["out"], errs["lse"]),
            "flash_bwd_dkv": max(errs["dk"], errs["dv"]),
            "flash_bwd_dq": errs["dq"]}


def _varlen_inputs(lens_q, lens_k, pad_q, pad_k, h, d, dtype, causal,
                   seed):
    """Packed q, k, v, dO from a seed, cu_seqlens and the kernels' plan."""
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    tq, tk = sum(lens_q) + pad_q, sum(lens_k) + pad_k
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(t):
        return torch.randn(t, h, d, generator=gen, device="cuda").to(dtype)

    cu_q = torch.tensor([0] + lens_q, device="cuda").cumsum(0).int()
    cu_k = torch.tensor([0] + lens_k, device="cuda").cumsum(0).int()
    plan = fv.varlen_plan(cu_q, cu_k, tq, tk, causal)
    return rnd(tq), rnd(tk), rnd(tk), rnd(tq), cu_q, cu_k, plan


def _per_head(fn, *tensors):
    """Runs a plain varlen version over all heads in one call or, where
    its dense [H, Tq, Tk] fp32 scores would pass 1 GiB (4.3 GB each at the
    packed shape), one head at a time, joining the heads again.
    ``tensors`` are [T, H, D] or [H, T, 1]. The FMA kernels sum in the
    order of the one call; a head at a time, cuBLAS sums in another, which
    at fp32 can move an element of a sum over a hundred rows by several
    ulps."""
    h = tensors[0].shape[1]
    if h * tensors[0].shape[0] * tensors[1].shape[0] * 4 <= 2 ** 30:
        return fn(*tensors)
    outs = []
    for i in range(h):
        outs.append(fn(*(t[:, i:i + 1] if t.shape[-1] != 1 else t[i:i + 1]
                         for t in tensors)))
    if isinstance(outs[0], tuple):
        return tuple(_join(list(o)) for o in zip(*outs))
    return _join(outs)


def _join(parts):
    return torch.cat(parts, dim=0 if parts[0].shape[-1] == 1 else 1)


def hold_varlen_against_plain(lens_q, lens_k, pad_q, pad_k, h, d, dtype,
                              causal, seed):
    """Runs each varlen kernel and its plain version on the same inputs.
    Returns the max abs error per kernel and the kernels' results (out, dq,
    dk, dv). Rows that see no key (padding rows, the queries of a segment
    without keys) must give out, lse and dq of exactly 0."""
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    q, k, v, do, cu_q, cu_k, plan = _varlen_inputs(
        lens_q, lens_k, pad_q, pad_k, h, d, dtype, causal, seed)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.varlen_fwd(q, k, v, plan, scale)
    delta = fv.varlen_delta(do, out)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    dq = fv.varlen_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    torch.cuda.synchronize()

    def plain(fn):
        return lambda *t: fn(*t, plan, scale)

    p_out, p_lse = _per_head(plain(fv.varlen_fwd_plain), q, k, v)
    abs_v_out = _per_head(plain(fv.varlen_fwd_plain), q, k, v.abs())[0]
    p_dk, p_dv = _per_head(plain(fv.varlen_bwd_dkv_plain), q, k, v, do,
                           lse, delta)
    p_dq = _per_head(plain(fv.varlen_bwd_dq_plain), q, k, v, do, lse, delta)
    pairs = {"out": (out, p_out), "lse": (lse, p_lse), "dq": (dq, p_dq),
             "dk": (dk, p_dk), "dv": (dv, p_dv)}
    errs, ratios = {}, {}
    for key, (got, want) in pairs.items():
        errs[key], ratios[key] = within(
            got, want, limit(dtype, key, want, abs_v_out, d))
    shape = (f"varlen tq {q.shape[0]} tk {k.shape[0]} h {h} d {d} {dtype} "
             f"causal {causal} segments {len(lens_q)}")
    print(f"{shape}: max abs err " + " ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + "; of the limit " +
        " ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
    for key, ratio in ratios.items():
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"{key} at {ratio:.3g} of its limit at {shape}")
    for t in (out, lse, dq, dk, dv):
        check(bool(torch.isfinite(t.float()).all()), f"non-finite at {shape}")
    cu = cu_q.tolist()
    blind = [i for s in range(len(lens_q)) if lens_k[s] == 0
             for i in range(cu[s], cu[s + 1])]
    blind += list(range(cu[-1], q.shape[0]))
    if blind:
        rows = torch.tensor(blind, device="cuda")
        check(not out[rows].any() and not dq[rows].any()
              and not lse[:, rows].any(),
              f"rows that see no key are not 0 at {shape}")
        print(f"  {len(blind)} rows that see no key: out, lse, dq exactly 0")
    return ({"varlen_fwd": max(errs["out"], errs["lse"]),
             "varlen_bwd_dkv": max(errs["dk"], errs["dv"]),
             "varlen_bwd_dq": errs["dq"]},
            (out, dq, dk, dv))


def _flashmask_inputs(b, sq, sk, h, d, dtype, seed):
    """q, k, v, dO in paddle's layout [B, S, H, D] from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(s):
        return torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)

    return rnd(sq), rnd(sk), rnd(sk), rnd(sq)


def _heads(x):
    """[B, S, H, D] -> contiguous [B*H, S, D], the copy the flashmask
    entry makes before its kernels."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _fm_edge_startend(b, h, sq, sk, seed):
    """int32 [b, h, sk, 2] for the edge shape: even heads ban rows
    [start, end) with start <= 120 and end >= 140 for every key (rows
    120..139 see no key); odd heads are a document mask over keys
    [50, 40, 46] (key j hidden from its document's end to sq + 1), so whole
    tiles are skipped and the rows past sk see no key."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    start = torch.randint(0, 121, (b, h, sk), generator=gen, device="cuda")
    end = torch.randint(140, sq + 31, (b, h, sk), generator=gen,
                        device="cuda")
    docs = torch.from_numpy(document_starts([50, 40, 46])).cuda()
    start[:, 1::2] = docs
    end[:, 1::2] = sq + 1
    return torch.stack([start, end], -1).int()


def hold_flashmask_against_plain(b, sq, sk, h, d, dtype, causal, startend,
                                 seed):
    """Runs each flashmask kernel and its plain version (one grid head at a
    time) on the same inputs. Returns the max abs error per kernel, the
    kernels' results (out, dq, dk, dv as [B*H, S, D]) and the plain output
    with |V|. Rows that see no key must give out, lse and dq of exactly
    0."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    q, k, v, do = (_heads(x) for x in _flashmask_inputs(
        b, sq, sk, h, d, dtype, seed))
    plan = fv.flashmask_plan(startend, h, causal)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.flashmask_fwd(q, k, v, plan, scale)
    delta = fa.attention_delta(do, out)
    dk, dv = fv.flashmask_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    dq = fv.flashmask_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    torch.cuda.synchronize()

    def per_head(fn, *tensors):
        outs = [fn(*(t[i:i + 1] for t in tensors), plan.select(i), scale)
                for i in range(b * h)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    p_out, p_lse = per_head(fv.flashmask_fwd_plain, q, k, v)
    abs_v_out = per_head(fv.flashmask_fwd_plain, q, k, v.abs())[0]
    p_dk, p_dv = per_head(fv.flashmask_bwd_dkv_plain, q, k, v, do, lse,
                          delta)
    p_dq = per_head(fv.flashmask_bwd_dq_plain, q, k, v, do, lse, delta)
    pairs = {"out": (out, p_out), "lse": (lse, p_lse), "dq": (dq, p_dq),
             "dk": (dk, p_dk), "dv": (dv, p_dv)}
    errs, ratios = {}, {}
    for key, (got, want) in pairs.items():
        errs[key], ratios[key] = within(
            got, want, limit(dtype, key, want, abs_v_out, d))
    shape = (f"flashmask b {b} h {h} sq {sq} sk {sk} d {d} {dtype} causal "
             f"{causal} startend {list(startend.shape)}")
    print(f"{shape}: max abs err " + " ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + "; of the limit " +
        " ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
    for key, ratio in ratios.items():
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"{key} at {ratio:.3g} of its limit at {shape}")
    for t in (out, lse, dq, dk, dv):
        check(bool(torch.isfinite(t.float()).all()), f"non-finite at {shape}")
    blind = torch.cat([~fv.flashmask_mask(plan.select(i), 1, sq, sk).any(-1)
                       for i in range(b * h)])
    if blind.any():
        check(not out[blind].any() and not dq[blind].any()
              and not lse[blind].any(),
              f"rows that see no key are not 0 at {shape}")
        print(f"  {int(blind.sum())} rows that see no key: out, lse, dq "
              f"exactly 0")
    tiles = int(fv.flashmask_tiles(plan, sq).sum())
    print(f"  64x64 tiles visited, summed over the {plan.st.shape[0]} "
          f"start/end rows: {tiles} of "
          f"{plan.st.shape[0] * -(-sq // 64) * -(-sk // 64)}")
    return ({"flashmask_fwd": max(errs["out"], errs["lse"]),
             "flashmask_bwd_dkv": max(errs["dk"], errs["dv"]),
             "flashmask_bwd_dq": errs["dq"]},
            (out, dq, dk, dv), abs_v_out)


def fused_widths():
    """(hidden, intermediate, eps) of the fused-op path's LLaMA config."""
    from paddle_tpu_torch.models.llama import LLAMA_CONFIGS
    cfg = LLAMA_CONFIGS[FUSED_CFG]
    return cfg.hidden_size, cfg.intermediate_size, cfg.rms_norm_eps


def fused_path_inputs(seed=10):
    """The fused-op path's tensors from a seed, bf16: x and the residual r
    ``[B, S, H]``, the norm weight w ``[H]`` (about 1), the gate/up weight
    ``[H, 2F]`` and the down weight ``[F, H]`` (std 0.02, the config's
    init), and the output's gradient dy ``[B, S, H]``."""
    h, f, _ = fused_widths()
    b, s = FUSED_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(torch.bfloat16)

    return (rnd((b, s, h)), rnd((b, s, h)), rnd((h,), 0.1, 1.0),
            rnd((h, 2 * f), 0.02), rnd((f, h), 0.02), rnd((b, s, h)))


_MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def fused_limit(want):
    """Per-element bound on |kernel - plain| for RMSNorm and SwiGLU: both
    compute in fp32 and round once, so in bf16 and fp16 an element may
    land one ulp of itself away (plus 1e-6 of the largest element for the
    fp32 sums); in fp32, 4e-6 relative (the order of the sums, ``expf``
    against ``sigmoid``)."""
    w = want.float().abs()
    if want.dtype == torch.float32:
        return 4e-6 * w + 1e-6 * w.max()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), torch.clamp(
        e - 1 - _MANTISSA[want.dtype], min=-14 - _MANTISSA[want.dtype]))
    return ulp + 1e-6 * w.max()


def hold_fused(name, got, want, shape):
    """Checks one fused kernel's result against its plain version; returns
    the max abs error."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{name} gave {got.dtype} {tuple(got.shape)} at {shape}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} non-finite at "
          f"{shape}")
    err, ratio = within(got, want, fused_limit(want))
    print(f"{name} {shape}: max abs err {err:.3g}; {ratio:.3g} of the "
          f"limit{' (bit-equal)' if torch.equal(got, want) else ''}")
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name} at {ratio:.3g} of its limit at {shape}")
    return err


# the fused kernels' edge shapes: (rows, H, x type, w type) and (rows, F,
# x type, g type, split form). 1000 = 8 * 125 takes the 16-byte path with
# part of each block idle, 1003 and 1001 the scalar path; the split form at
# F = 1001 reads unaligned halves in place
RMS_EDGE = [(37, 1000, torch.float32, torch.float32),
            (37, 1000, torch.float16, torch.float16),
            (37, 1000, torch.bfloat16, torch.float32),
            (37, 1003, torch.bfloat16, torch.bfloat16),
            (37, 1003, torch.float16, torch.float32)]
SWIGLU_EDGE = [(37, 1001, torch.bfloat16, torch.bfloat16, True),
               (37, 1000, torch.bfloat16, torch.float32, False),
               (37, 1001, torch.float32, torch.float32, False),
               (37, 2000, torch.float16, torch.float16, True)]


def fused_checks():
    """RMSNorm and SwiGLU against their plain versions on the fused-op
    path's tensors (the norm of ``x + r``, then the split SwiGLU of its
    gate/up product, as phase 8 computes them), then at the edge shapes.
    Returns the path-shape errors and the kernels' path results (on the
    host, for phase 8's bit-for-bit check)."""
    from paddle_tpu_torch.ops.cuda import fused as fu
    h, f, eps = fused_widths()
    x, r, w, w_gu, _, _ = fused_path_inputs()
    hsum = (x + r).reshape(-1, h)
    hn = fu.rms_norm_fwd(hsum, w, eps)
    errs = {"rms_norm": hold_fused("rms_norm", hn, fu.rms_norm_fwd_plain(
        hsum, w, eps), f"{list(hsum.shape)} bf16 w bf16")}
    gu = (hn.reshape(x.shape) @ w_gu).reshape(-1, 2 * f)
    a = fu.swiglu_fwd(gu[:, :f], gu[:, f:])
    errs["swiglu"] = hold_fused("swiglu", a, fu.swiglu_fwd_plain(
        gu[:, :f], gu[:, f:]), f"split {list(gu.shape)} bf16")
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rnd(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)

    for n, hh, xt, wt in RMS_EDGE:
        xe, we = rnd((n, hh), xt, 2.0, 0.3), rnd((hh,), wt, 0.2, 1.0)
        hold_fused("rms_norm", fu.rms_norm_fwd(xe, we, eps),
                   fu.rms_norm_fwd_plain(xe, we, eps),
                   f"[{n}, {hh}] {xt} w {wt}")
    for n, ff, xt, gt, split in SWIGLU_EDGE:
        if split:
            xg = rnd((n, 2 * ff), xt, 3.0)
            xe, ge = xg[:, :ff], xg[:, ff:]
        else:
            xe, ge = rnd((n, ff), xt, 3.0), rnd((n, ff), gt)
        hold_fused("swiglu", fu.swiglu_fwd(xe, ge),
                   fu.swiglu_fwd_plain(xe, ge),
                   f"{'split ' if split else ''}[{n}, {ff}] {xt} g {gt}")
    torch.cuda.synchronize()
    return errs, (hn.cpu(), a.cpu())


def hold_forward(label, got, want, abs_v_out, blind=None):
    """Holds a bf16 forward's (out, lse) against its plain version's with
    ``limit``; ``blind`` (a bool row mask over out's leading dimensions)
    marks rows that see no key, whose out must be exactly 0."""
    errs, ratios = {}, {}
    for key, g, w in zip(("out", "lse"), got, want):
        errs[key], ratios[key] = within(
            g, w, limit(torch.bfloat16, key, w, abs_v_out))
        check(bool(torch.isfinite(g.float()).all()), f"{key} non-finite at "
              f"{label}")
    print(f"{label}: max abs err " + " ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + "; of the limit " +
        " ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
    for key, ratio in ratios.items():
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"{key} at {ratio:.3g} of its limit at {label}")
    if blind is not None and blind.any():
        check(not got[0][blind].any(), f"rows that see no key are not 0 at "
              f"{label}")


# the bf16 forward's edge shapes: (bh, sq, sk, kv_len, causal): query tiles
# that visit more key tiles than the K/V ring has stages, sq != sk both ways
# under the bottom-right causal offset, kv_len cutting a key tile
BF16_FWD_EDGE = [(2, 1000, 1000, 1000, True), (2, 1024, 1024, 1024, True),
                 (2, 100, 300, 300, True), (2, 300, 100, 100, True),
                 (2, 128, 256, 150, True), (2, 128, 256, 150, False)]
# varlen: an empty segment and segments of one token
BF16_VARLEN_EDGE = [1, 0, 130, 64, 1, 1]


def hold_backward(label, got, want, unseen=None, blind=None):
    """Holds a bf16 backward's (dq, dk, dv) against the plain versions'
    with ``limit``; ``unseen`` (a bool mask over dk's leading dimensions)
    marks keys that no query sees, whose dk and dv must be exactly 0, and
    ``blind`` rows that see no key, whose dq must be 0."""
    errs, ratios = {}, {}
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[key], ratios[key] = within(g, w, limit(torch.bfloat16, key, w))
        check(bool(torch.isfinite(g.float()).all()), f"{key} non-finite at "
              f"{label}")
    print(f"{label} backward: max abs err " + " ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + "; of the limit " +
        " ".join(f"{k} {v:.3g}" for k, v in ratios.items()))
    for key, ratio in ratios.items():
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"{key} at {ratio:.3g} of its limit at {label}")
    if unseen is not None and unseen.any():
        check(not got[1][unseen].any() and not got[2][unseen].any(),
              f"keys that no query sees have dk or dv not 0 at {label}")
    if blind is not None and blind.any():
        check(not got[0][blind].any(), f"rows that see no key have dq not 0 "
              f"at {label}")


def bf16_edges():
    """The bf16 tensor-core kernels (forward, dK/dV, dQ; fixed-length,
    varlen, flashmask) at their edge shapes, at head_dim 32, 64 and 128,
    against the plain versions."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    for d in (32, 64, 128):
        scale = 1.0 / math.sqrt(d)
        for bh, sq, sk, kv_len, causal in BF16_FWD_EDGE:
            q, k, v, do = _inputs(bh, sq, sk, d, torch.bfloat16, seed=20)
            args = (causal, scale, kv_len, sk - sq)
            got = fa.flash_fwd(q, k, v, *args)
            want = fa.flash_fwd_plain(q, k, v, *args)
            abs_v = fa.flash_fwd_plain(q, k, v.abs(), *args)[0]
            blind = torch.zeros(bh, sq, dtype=torch.bool, device="cuda")
            if causal and sq > sk:
                blind[:, :sq - sk] = True
            label = (f"edge bh {bh} sq {sq} sk {sk} kv_len {kv_len} d {d} "
                     f"bf16 causal {causal}")
            hold_forward(label, got, want, abs_v, blind)
            lse, delta = got[1], fa.attention_delta(do, got[0])
            bwd = (q, k, v, do, lse, delta, *args)
            unseen = torch.zeros(bh, sk, dtype=torch.bool, device="cuda")
            unseen[:, kv_len:] = True
            hold_backward(label, (fa.flash_bwd_dq(*bwd),
                                  *fa.flash_bwd_dkv(*bwd)),
                          (fa.flash_bwd_dq_plain(*bwd),
                           *fa.flash_bwd_dkv_plain(*bwd)), unseen, blind)
        lens = BF16_VARLEN_EDGE
        for causal in (True, False):
            q, k, v, do, _, _, plan = _varlen_inputs(
                lens, lens, 0, 0, 3, d, torch.bfloat16, causal, seed=21)
            got = fv.varlen_fwd(q, k, v, plan, scale)
            want = fv.varlen_fwd_plain(q, k, v, plan, scale)
            abs_v = fv.varlen_fwd_plain(q, k, v.abs(), plan, scale)[0]
            label = f"edge varlen segments {lens} d {d} bf16 causal {causal}"
            hold_forward(label, got, want, abs_v)
            check(torch.equal(got[0][0], v[0]), "a one-token segment's "
                  "output is not its own v")
            bwd = (q, k, v, do, got[1], fv.varlen_delta(do, got[0]), plan,
                   scale)
            dq, dk, dv = fv.varlen_bwd_dq(*bwd), *fv.varlen_bwd_dkv(*bwd)
            hold_backward(label, (dq, dk, dv), (fv.varlen_bwd_dq_plain(*bwd),
                                                *fv.varlen_bwd_dkv_plain(*bwd)))
            check(torch.equal(dv[0], do[0]), "a one-token segment's dv is not "
                  "its own query's dO")
        # flashmask: every key tile but tile 3 bans every query row
        s = 512
        st = torch.zeros(s, dtype=torch.int32, device="cuda")
        st[192:256] = s
        en = torch.full((s,), s, dtype=torch.int32, device="cuda")
        startend = torch.stack([st, en], -1).view(1, 1, s, 2)
        for causal in (True, False):
            plan = fv.flashmask_plan(startend, 2, causal)
            check(int(fv.flashmask_tiles(plan, s)[0].sum(1).max()) == 1,
                  "the one-open-tile mask visits more than one tile")
            q, k, v, do = _inputs(2, s, s, d, torch.bfloat16, seed=22)
            got = fv.flashmask_fwd(q, k, v, plan, scale)
            want = fv.flashmask_fwd_plain(q, k, v, plan, scale)
            abs_v = fv.flashmask_fwd_plain(q, k, v.abs(), plan, scale)[0]
            mask = fv.flashmask_mask(plan, 2, s, s)
            label = (f"edge flashmask one open key tile s {s} d {d} bf16 "
                     f"causal {causal}")
            hold_forward(label, got, want, abs_v, ~mask.any(-1))
            bwd = (q, k, v, do, got[1], fa.attention_delta(do, got[0]), plan,
                   scale)
            hold_backward(label, (fv.flashmask_bwd_dq(*bwd),
                                  *fv.flashmask_bwd_dkv(*bwd)),
                          (fv.flashmask_bwd_dq_plain(*bwd),
                           *fv.flashmask_bwd_dkv_plain(*bwd)),
                          ~mask.any(1), ~mask.any(-1))
    torch.cuda.synchronize()


def _misaligned(t):
    """A contiguous copy of ``t`` whose base sits one element past a
    16-byte boundary (a view at an odd offset of a flat buffer)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def misaligned_checks():
    """bf16 inputs whose base is not 16-byte aligned (TMA refuses it) reach
    the same kernels as fresh aligned copies: forward, dK/dV and dQ of the
    three masks give, bit for bit, what they give on aligned inputs."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    q, k, v, do = _inputs(2, 256, 256, 64, torch.bfloat16, seed=40)
    args = (True, 0.125, 256, 0)
    cu = torch.tensor([0, 100, 300, 512], device="cuda").int()
    vplan = fv.varlen_plan(cu, cu, 512, 512, True)
    fplan = fv.flashmask_plan(torch.full((2, 1, 256, 1), 200,
                                         dtype=torch.int32, device="cuda"),
                              1, True)
    paths = {
        "fixed-length": (lambda *t: fa.flash_fwd(*t, *args),
                         lambda *t: fa.flash_bwd_dkv(*t, *args),
                         lambda *t: fa.flash_bwd_dq(*t, *args),
                         fa.attention_delta, lambda t: t),
        "varlen": (lambda *t: fv.varlen_fwd(*t, vplan, 0.125),
                   lambda *t: fv.varlen_bwd_dkv(*t, vplan, 0.125),
                   lambda *t: fv.varlen_bwd_dq(*t, vplan, 0.125),
                   fv.varlen_delta, lambda t: t.reshape(512, 1, 64)),
        "flashmask": (lambda *t: fv.flashmask_fwd(*t, fplan, 0.125),
                      lambda *t: fv.flashmask_bwd_dkv(*t, fplan, 0.125),
                      lambda *t: fv.flashmask_bwd_dq(*t, fplan, 0.125),
                      fa.attention_delta, lambda t: t),
    }
    for name, (fwd, dkv, dq, delta_of, shape) in paths.items():
        x = [shape(t) for t in (q, k, v, do)]
        results = []
        for ins in (x, [_misaligned(t) for t in x]):
            out, lse = fwd(*ins[:3])
            delta = delta_of(x[3], out)
            results.append((out, lse, dq(*ins, lse, delta),
                            *dkv(*ins, lse, delta)))
        torch.cuda.synchronize()
        for key, a, b in zip(("out", "lse", "dq", "dk", "dv"), *results):
            check(torch.equal(a, b), f"{name} {key} on a misaligned base "
                  f"differs from the aligned run (max {_err(a, b):.3g})")
        print(f"misaligned bf16 base, {name}: out, lse, dq, dk, dv equal to "
              f"the aligned run, bit for bit")


def repairs():
    """fp16 io (the FMA kernels) for the three masks, forward and
    backward; a head_dim of 80, run at 128 with zero columns, in bf16 and
    fp16; a misaligned bf16 base."""
    hold_against_plain(4, 200, 200, 64, torch.float16, True, seed=30)
    hold_against_plain(4, 128, 256, 80, torch.float16, False, seed=31)
    hold_against_plain(4, 200, 200, 80, torch.bfloat16, True, seed=32)
    for dtype, d, causal in ((torch.float16, 64, True),
                             (torch.float16, 80, False),
                             (torch.bfloat16, 80, True)):
        hold_varlen_against_plain(*EDGE, 4, d, dtype, causal, seed=33)
        hold_flashmask_against_plain(
            2, 200, 136, 4, d, dtype, causal,
            _fm_edge_startend(2, 4, 200, 136, seed=7), seed=34)
    misaligned_checks()


def head_dim_256_checks():
    """head_dim 256 and 160 (run at 256 with zero columns), fp32, bf16 and
    fp16 (all on the FMA kernels at 256, whose backward works on 32-row
    halves of its 64-row tiles), the three masks, forward and backward,
    against the plain versions with ``limit``; the fixed-length mask at
    sq > sk causal (rows that see no key) and sq < sk."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d, causal, (sq, sk) in ((256, True, (200, 136)),
                                    (160, False, (136, 200))):
            hold_against_plain(4, sq, sk, d, dtype, causal, seed=50)
            hold_varlen_against_plain(*EDGE, 2, d, dtype, causal, seed=51)
            hold_flashmask_against_plain(
                2, 200, 136, 2, d, dtype, causal,
                _fm_edge_startend(2, 2, 200, 136, seed=7), seed=52)


def head_dims_above_256_checks():
    """head_dim 288 (run at 512 with zero columns) and 512, fp32, bf16 and
    fp16 (the FMA kernels split over two 256-column chunks), the three
    masks, forward and backward, against the plain versions with
    ``limit``; the fixed-length mask at sq > sk causal and sq < sk."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d, causal, (sq, sk) in ((288, True, (200, 136)),
                                    (512, False, (136, 200))):
            hold_against_plain(4, sq, sk, d, dtype, causal, seed=54)
            hold_varlen_against_plain(*EDGE, 2, d, dtype, causal, seed=55)
            hold_flashmask_against_plain(
                2, 200, 136, 2, d, dtype, causal,
                _fm_edge_startend(2, 2, 200, 136, seed=7), seed=56)


# more than 65535 batch*heads: the fixed-length kernels put the heads on
# the grid's y axis, whose limit is 65535; the C entries launch slices
MANY_HEADS = 65535 + 65


def many_heads_checks():
    """``MANY_HEADS`` fixed-length heads of 70 x 70 at head_dim 32, bf16
    (the tensor-core kernels) and fp32 (the FMA kernels), causal, against
    the plain versions with ``limit`` (the plain scores: 1.3 GB)."""
    for dtype in (torch.bfloat16, torch.float32):
        hold_against_plain(MANY_HEADS, 70, 70, 32, dtype, True, seed=57)


def keyless_rows_check():
    """Causal sq > sk through ``mha_forward``: the rows that see no key
    get the reference's output (the mean of v over the key blocks the
    reference visits), on the card as on the CPU path the CPU tests hold
    against the reference; fp32, 1e-5."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    for sq, sk in ((576, 512), (1536, 1280)):
        q, k, v, _ = _inputs(2, sq, sk, 32, torch.float32, seed=53)
        got = fa.mha_forward(q, k, v, causal=True)
        want = fa.mha_forward(q.cpu(), k.cpu(), v.cpu(), causal=True)
        err = _err(got.cpu(), want)
        keyless = got[:, :sq - sk]
        print(f"keyless rows sq {sq} sk {sk}: max abs err against the CPU "
              f"path {err:.3g}; {int((keyless != 0).any(-1).sum())} of "
              f"{keyless.shape[0] * keyless.shape[1]} keyless rows take "
              f"the reference's mean of v")
        check(err <= 1e-5, f"keyless rows: err {err} at sq {sq} sk {sk}")
        check(bool(keyless.any()), "keyless rows all 0")


def kernel_checks():
    phase("3 kernels against their plain versions")
    errs = hold_against_plain(BATCH * HEADS, SEQ, SEQ, HEAD_DIM,
                              torch.bfloat16, True, seed=0)
    hold_against_plain(4, 128, 256, 32, torch.float32, True, seed=1)
    varlen_errs, varlen_results = hold_varlen_against_plain(
        DOCS, DOCS, 0, 0, HEADS, HEAD_DIM, torch.bfloat16, True, seed=3)
    errs.update(varlen_errs)
    for causal in (False, True):
        hold_varlen_against_plain(*EDGE, 4, 128, torch.float32, causal,
                                  seed=4)
    fm_errs, fm_results, fm_abs_v = hold_flashmask_against_plain(
        2, FM_SEQ, FM_SEQ, HEADS, HEAD_DIM, torch.bfloat16, True,
        torch.from_numpy(flashmask_startend()).cuda(), seed=6)
    errs.update(fm_errs)
    edge_startend = _fm_edge_startend(2, 4, 200, 136, seed=7)
    for causal in (False, True):
        hold_flashmask_against_plain(2, 200, 136, 4, 128, torch.float32,
                                     causal, edge_startend, seed=8)
    bf16_edges()
    repairs()
    head_dim_256_checks()
    head_dims_above_256_checks()
    many_heads_checks()
    keyless_rows_check()
    fused_errs, fused_results = fused_checks()
    errs.update(fused_errs)
    return errs, varlen_results, (fm_results, fm_abs_v), fused_results


def bounds(bh, s, d, io_bytes):
    """Least time (ms) for each kernel's work at a causal [bh, s, d] shape:
    the larger of its operations at the bf16 tensor-core peak and its
    bytes (each input read once, each output written once) at the memory
    rate. Operations count the (query, key) pairs the causal mask keeps."""
    pairs = bh * s * (s + 1) // 2
    tile = bh * s * d * io_bytes   # one [bh, s, d] tensor
    row = bh * s * 4               # one fp32 [bh, s] row (lse or delta)
    work = {
        # QK^T and PV; q, k, v in, o and lse out
        "flash_fwd": (2 * 2 * d * pairs, 4 * tile + row),
        # QK^T, dO V^T, P^T dO, dS^T Q; q k v dO lse delta in, dk dv out
        "flash_bwd_dkv": (4 * 2 * d * pairs, 6 * tile + 2 * row),
        # QK^T, dO V^T, dS K; q k v dO lse delta in, dq out
        "flash_bwd_dq": (3 * 2 * d * pairs, 5 * tile + 2 * row),
    }
    return {name: _bound(*fb) for name, fb in work.items()}


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(least ms, what bounds it, flops, bytes) for work of ``flops``
    operations at ``peak`` (default the bf16 tensor-core peak) and
    ``nbytes`` at the memory rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def kept_pairs(lens_q, lens_k, causal):
    """(query, key) pairs a varlen mask keeps, per head: a query at
    in-segment position p sees min(p + 1, Lk) keys when causal."""
    if not causal:
        return sum(a * b for a, b in zip(lens_q, lens_k))
    return sum(min(p + 1, b) for a, b in zip(lens_q, lens_k)
               for p in range(a))


def varlen_bounds(h, lens_q, lens_k, tq, tk, d, io_bytes, causal):
    """Least time (ms) for each varlen kernel's work, as ``bounds`` counts
    it, over the pairs this run's segments keep. Bytes add the int32
    segment and position arrays (padded to whole 64-row tiles) and the
    per-tile bounds each kernel reads."""
    pairs = h * kept_pairs(lens_q, lens_k, causal)
    tq_pad, tk_pad = -(-tq // 64) * 64, -(-tk // 64) * 64
    qt, kt = h * tq * d * io_bytes, h * tk * d * io_bytes
    row = h * tq * 4
    meta = 2 * 4 * (tq_pad + tk_pad)
    work = {
        "varlen_fwd": (2 * 2 * d * pairs,
                       2 * qt + 2 * kt + row + meta + 2 * 4 * tq_pad // 64),
        "varlen_bwd_dkv": (4 * 2 * d * pairs, 2 * qt + 4 * kt + 2 * row
                           + meta + 2 * 4 * tk_pad // 64),
        "varlen_bwd_dq": (3 * 2 * d * pairs, 3 * qt + 2 * kt + 2 * row
                          + meta + 2 * 4 * tq_pad // 64),
    }
    return {name: _bound(*fb) for name, fb in work.items()}


def flashmask_bounds(pairs, bh, sq, sk, d, io_bytes, plan_bytes):
    """Least time (ms) for each flashmask kernel's work, as ``bounds``
    counts it, over ``pairs`` kept (query, key) pairs in all heads. Bytes
    add the plan's int32 start/end rows and per-tile statistics."""
    qt, kt = bh * sq * d * io_bytes, bh * sk * d * io_bytes
    row = bh * sq * 4
    work = {
        "flashmask_fwd": (2 * 2 * d * pairs, 2 * qt + 2 * kt + row
                          + plan_bytes),
        "flashmask_bwd_dkv": (4 * 2 * d * pairs, 2 * qt + 4 * kt + 2 * row
                              + plan_bytes),
        "flashmask_bwd_dq": (3 * 2 * d * pairs, 3 * qt + 2 * kt + 2 * row
                             + plan_bytes),
    }
    return {name: _bound(*fb) for name, fb in work.items()}


def varlen_timings(h, d, seed):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    t = sum(DOCS)
    q, k, v, do, cu, _, plan = _varlen_inputs(
        DOCS, DOCS, 0, 0, h, d, torch.bfloat16, True, seed=seed)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.varlen_fwd(q, k, v, plan, scale)
    delta = fv.varlen_delta(do, out)
    ms = {
        "varlen_fwd": cuda_ms(lambda: fv.varlen_fwd(q, k, v, plan, scale),
                              20),
        "varlen_bwd_dkv": cuda_ms(lambda: fv.varlen_bwd_dkv(
            q, k, v, do, lse, delta, plan, scale), 20),
        "varlen_bwd_dq": cuda_ms(lambda: fv.varlen_bwd_dq(
            q, k, v, do, lse, delta, plan, scale), 20),
    }

    def plain(fn, *tensors):
        return lambda: _per_head(lambda *x: fn(*x, plan, scale), *tensors)

    plain_ms = {
        "varlen_fwd": cuda_ms(plain(fv.varlen_fwd_plain, q, k, v), 3, 1),
        "varlen_bwd_dkv": cuda_ms(plain(fv.varlen_bwd_dkv_plain, q, k, v,
                                        do, lse, delta), 3, 1),
        "varlen_bwd_dq": cuda_ms(plain(fv.varlen_bwd_dq_plain, q, k, v, do,
                                       lse, delta), 3, 1),
    }
    plan_ms = cuda_ms(lambda: fv.varlen_plan(cu, cu, t, t, True), 20)
    delta_ms = cuda_ms(lambda: fv.varlen_delta(do, out), 20)

    # yardstick only: the library's attention over the dense block-diagonal
    # causal mask, which does all T^2 pairs the kernels skip
    seg = plan.seg_q[:t]
    pos = plan.pos_q[:t]
    mask = (seg[:, None] == seg[None, :]) & (pos[None, :] <= pos[:, None])
    q4, k4, v4, do4 = (x.transpose(0, 1)[None] for x in (q, k, v, do))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, scale=scale), 10)
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                             scale=scale)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do4, retain_graph=True), 10)
    library_ms = {"varlen_fwd": lib_fwd, "varlen_bwd_dkv": None,
                  "varlen_bwd_dq": None}
    bnd = varlen_bounds(h, DOCS, DOCS, t, t, d, 2, True)
    print(f"varlen: T {t}, {len(DOCS)} documents, {h} heads, d "
          f"{d}, bf16, causal; {kept_pairs(DOCS, DOCS, True)} kept "
          f"pairs per head ({kept_pairs(DOCS, DOCS, True) / (t * (t + 1) / 2):.1%}"
          f" of a dense causal mask)")
    for name in library_ms:
        b_ms, b_by, flops, nbytes = bnd[name]
        print(f"{name}: {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms "
              f"(one head at a time), bound {b_ms:.4f} ms ({b_by}; "
              f"{flops:.3e} FLOP, {nbytes / 1e6:.1f} MB), "
              f"{b_ms / ms[name]:.1%} of bound")
    print(f"varlen_plan (plain torch, before the forward): {plan_ms:.4f} ms; "
          f"varlen_delta (in the backward): {delta_ms:.4f} ms")
    print(f"library sdpa, dense block-diagonal causal mask [{t}, {t}]: fwd "
          f"{lib_fwd:.4f} ms, bwd (dq+dk+dv) {lib_bwd:.4f} ms; port bwd "
          f"dkv+dq+delta {ms['varlen_bwd_dkv'] + ms['varlen_bwd_dq'] + delta_ms:.4f} ms")
    return ms, plain_ms, library_ms, bnd


def flashmask_timings(h, d, seed):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    b, s = 2, FM_SEQ
    q4, k4, v4, do4 = _flashmask_inputs(b, s, s, h, d, torch.bfloat16,
                                        seed=seed)
    q, k, v, do = (_heads(x) for x in (q4, k4, v4, do4))
    startend = torch.from_numpy(flashmask_startend()).cuda()
    plan = fv.flashmask_plan(startend, h, True)
    scale = 1.0 / math.sqrt(d)
    out, lse = fv.flashmask_fwd(q, k, v, plan, scale)
    delta = fa.attention_delta(do, out)
    ms = {
        "flashmask_fwd": cuda_ms(lambda: fv.flashmask_fwd(q, k, v, plan,
                                                          scale), 20),
        "flashmask_bwd_dkv": cuda_ms(lambda: fv.flashmask_bwd_dkv(
            q, k, v, do, lse, delta, plan, scale), 20),
        "flashmask_bwd_dq": cuda_ms(lambda: fv.flashmask_bwd_dq(
            q, k, v, do, lse, delta, plan, scale), 20),
    }

    def plain(fn, *tensors):
        return lambda: [fn(*(t[i:i + 1] for t in tensors), plan.select(i),
                           scale) for i in range(b * h)]

    plain_ms = {
        "flashmask_fwd": cuda_ms(plain(fv.flashmask_fwd_plain, q, k, v), 3,
                                 1),
        "flashmask_bwd_dkv": cuda_ms(plain(fv.flashmask_bwd_dkv_plain, q, k,
                                           v, do, lse, delta), 3, 1),
        "flashmask_bwd_dq": cuda_ms(plain(fv.flashmask_bwd_dq_plain, q, k, v,
                                          do, lse, delta), 3, 1),
    }
    plan_ms = cuda_ms(lambda: fv.flashmask_plan(startend, h, True), 20)

    # yardstick only: the library's attention over the dense bool mask
    # [b, 1, s, s], which does all s^2 pairs the kernels skip
    mask = torch.cat([fv.flashmask_mask(plan.select(i * h), 1, s, s)
                      for i in range(b)])[:, None]
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q4, k4, v4, do4))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale), 10)
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                             scale=scale)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), doh, retain_graph=True), 10)
    library_ms = {"flashmask_fwd": lib_fwd, "flashmask_bwd_dkv": None,
                  "flashmask_bwd_dq": None}
    pairs_per_head = int(mask.sum())
    plan_bytes = 4 * sum(t.numel() for t in (plan.st, plan.en, plan.st_max,
                                             plan.en_min))
    bnd = flashmask_bounds(h * pairs_per_head, b * h, s, s, d, 2, plan_bytes)
    tiles = int(fv.flashmask_tiles(plan, s).sum())
    print(f"flashmask: batch {b} x seq {s}, {h} heads, d {d}, bf16, causal, "
          f"startend {list(startend.shape)}; {pairs_per_head} kept pairs per "
          f"head ({pairs_per_head / (b * s * (s + 1) / 2):.1%} of a dense "
          f"causal mask); {tiles} of {b * (s // 64) * (s // 64 + 1) // 2} "
          f"causal 64x64 tiles visited per head")
    for name in library_ms:
        b_ms, b_by, flops, nbytes = bnd[name]
        print(f"{name}: {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms "
              f"(one head at a time), bound {b_ms:.4f} ms ({b_by}; "
              f"{flops:.3e} FLOP, {nbytes / 1e6:.1f} MB), "
              f"{b_ms / ms[name]:.1%} of bound")
    print(f"flashmask_plan (plain torch, before the forward): "
          f"{plan_ms:.4f} ms")
    print(f"library sdpa, dense bool mask {list(mask.shape)}: fwd "
          f"{lib_fwd:.4f} ms, bwd (dq+dk+dv) {lib_bwd:.4f} ms; port bwd "
          f"dkv+dq {ms['flashmask_bwd_dkv'] + ms['flashmask_bwd_dq']:.4f} ms")
    return ms, plain_ms, library_ms, bnd


def fused_timings():
    """RMSNorm and SwiGLU at the fused-op path's shapes, each beside its
    plain version, the library's ``rms_norm`` (a yardstick only; the port
    never calls it; SwiGLU has no single library call) and its bound:
    each input read once, each output written once, at the memory rate;
    the fp32 operations (RMSNorm x*x, +, *r, *w; SwiGLU -x, exp, +, /, *g,
    exp counted as one) at the fp32 peak outside the tensor cores."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import fused as fu
    h, f, eps = fused_widths()
    x, r, w, w_gu, _, _ = fused_path_inputs(seed=12)
    hsum = (x + r).reshape(-1, h)
    gu = (fu.rms_norm_fwd(hsum, w, eps).reshape(x.shape) @ w_gu).reshape(
        -1, 2 * f)
    xa, ga = gu[:, :f], gu[:, f:]
    n = hsum.shape[0]
    ms = {"rms_norm": cuda_ms(lambda: fu.rms_norm_fwd(hsum, w, eps), 20),
          "swiglu": cuda_ms(lambda: fu.swiglu_fwd(xa, ga), 20)}
    plain_ms = {
        "rms_norm": cuda_ms(lambda: fu.rms_norm_fwd_plain(hsum, w, eps), 5),
        "swiglu": cuda_ms(lambda: fu.swiglu_fwd_plain(xa, ga), 5)}
    library_ms = {"rms_norm": cuda_ms(lambda: F.rms_norm(hsum, (h,), w, eps),
                                      20),
                  "swiglu": None}
    bnd = {"rms_norm": _bound(4 * n * h, 2 * 2 * n * h + 2 * h,
                              PEAK_FP32_FLOPS),
           "swiglu": _bound(5 * n * f, 3 * 2 * n * f, PEAK_FP32_FLOPS)}
    for name, shape in (("rms_norm", f"[{n}, {h}]"),
                        ("swiglu", f"split [{n}, {2 * f}] -> [{n}, {f}]")):
        b_ms, b_by, flops, nbytes = bnd[name]
        lib = library_ms[name]
        print(f"{name} {shape} bf16: {ms[name]:.4f} ms, plain "
              f"{plain_ms[name]:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, "
              f"{nbytes / 1e6:.1f} MB), {b_ms / ms[name]:.1%} of bound, "
              f"{nbytes / (ms[name] / 1e3) / 1e12:.3f} TB/s")
    return ms, plain_ms, library_ms, bnd


def fixed_timings(b, h, s, d, seed):
    """The fixed-length kernels at a causal [b * h, s, d] bf16 shape: each
    kernel's and its plain version's ms, the library's (SDPA forward; its
    backward computes dq, dk and dv in one call, so it stands beside no
    single backward kernel) and the bounds."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    bh = b * h
    q, k, v, do = _inputs(bh, s, s, d, torch.bfloat16, seed=seed)
    args = (True, 1.0 / math.sqrt(d), s, 0)
    out, lse = fa.flash_fwd(q, k, v, *args)
    delta = fa.attention_delta(do, out)
    ms = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, *args), 20),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, do, lse, delta, *args), 20),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, *args), 20),
    }
    plain_ms = {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, *args), 5),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, *args), 5),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, *args), 5),
    }
    delta_ms = cuda_ms(lambda: fa.attention_delta(do, out), 20)
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 20)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do4, retain_graph=True), 20)
    library_ms = {"flash_fwd": lib_fwd, "flash_bwd_dkv": None,
                  "flash_bwd_dq": None}
    bnd = bounds(bh, s, d, 2)
    print(f"fixed-length: batch {b} x {h} heads, seq {s}, d {d}, bf16, "
          f"causal")
    for name in library_ms:
        b_ms, b_by, flops, nbytes = bnd[name]
        print(f"{name}: {ms[name]:.4f} ms, plain {plain_ms[name]:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, "
              f"{nbytes / 1e6:.1f} MB), {b_ms / ms[name]:.1%} of bound")
    print(f"attention_delta (plain torch, in the backward): "
          f"{delta_ms:.4f} ms")
    print(f"library sdpa causal: fwd {lib_fwd:.4f} ms, bwd (dq+dk+dv) "
          f"{lib_bwd:.4f} ms; port bwd dkv+dq+delta "
          f"{ms['flash_bwd_dkv'] + ms['flash_bwd_dq'] + delta_ms:.4f} ms")
    return ms, plain_ms, library_ms, bnd


# the head_dim 256 timings: a Gemma-7B-like attention (16 heads of 256) in
# place of gpt2-medium's 16 x 64, over the same tokens per mask
D256_HEADS = 16
# the FMA kernels' shared memory at head_dim 256, as their launchers size
# it (flash_common.cuh: 64-row tiles of D + 1 floats, score tiles of 65;
# the backward in 32-row passes): Q, K, V tiles and P; dQ: 32 rows of Q and
# dO, 64 of K and V, 32 x 65 dS, 32 lse and delta; dK/dV: 32 rows of K and
# V, 64 of Q and dO, 64 x 33 P and dS, 64 lse and delta
D256_SMEM = {"flash_fwd": 4 * (3 * 64 * 257 + 64 * 65),
             "flash_bwd_dq": 4 * (2 * 32 * 257 + 2 * 64 * 257 + 32 * 65
                                  + 2 * 32),
             "flash_bwd_dkv": 4 * (2 * 32 * 257 + 2 * 64 * 257 + 2 * 64 * 33
                                   + 2 * 64)}


def d256_timings():
    """The three masks' kernels at head_dim 256, bf16 (the FMA kernels),
    beside their bounds, plain versions and the library's forward."""
    print(f"head_dim 256 (the FMA kernels at every io type), shared memory "
          f"per block: " + ", ".join(f"{k} {v} B" for k, v in
                                     D256_SMEM.items()) + " of 232448")
    results = [fixed_timings(BATCH, D256_HEADS, SEQ, 256, seed=60),
               varlen_timings(D256_HEADS, 256, seed=61),
               flashmask_timings(D256_HEADS, 256, seed=62)]
    return tuple({k: v for r in results for k, v in r[i].items()}
                 for i in range(4))


def d512_timings():
    """The three masks' kernels at head_dim 512, bf16 (the FMA kernels at
    256 split over two chunks: the same shared memory a block as at 256),
    beside their bounds, plain versions and the library's forward."""
    print("head_dim 512 (the FMA kernels split over two 256-column "
          "chunks, one block per chunk; shared memory per block as at 256)")
    results = [fixed_timings(BATCH, D256_HEADS, SEQ, 512, seed=63),
               varlen_timings(D256_HEADS, 512, seed=64),
               flashmask_timings(D256_HEADS, 512, seed=65)]
    return tuple({k: v for r in results for k, v in r[i].items()}
                 for i in range(4))


def timings():
    phase("4 timings at the path shapes")
    ms, plain_ms, library_ms, bnd = fixed_timings(BATCH, HEADS, SEQ,
                                                  HEAD_DIM, seed=2)
    v_ms, v_plain, v_lib, v_bnd = varlen_timings(HEADS, HEAD_DIM, seed=5)
    f_ms, f_plain, f_lib, f_bnd = flashmask_timings(HEADS, HEAD_DIM, seed=9)
    u_ms, u_plain, u_lib, u_bnd = fused_timings()
    return ({**ms, **v_ms, **f_ms, **u_ms},
            {**plain_ms, **v_plain, **f_plain, **u_plain},
            {**library_ms, **v_lib, **f_lib, **u_lib},
            {**bnd, **v_bnd, **f_bnd, **u_bnd})


def small_step_check():
    """The CUDA train step against the port's CPU path on a small GPT
    (fp32, seq 256 so the kernels run): two steps from the same state."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.trainer import tree_leaves, tree_map
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=256,
                        dtype="float32")
    init_fn, cuda_step = gpt.build_train_step(cfg, device="cuda")
    _, cpu_step = gpt.build_train_step(cfg, device="cpu")
    state = init_fn(0)
    cpu_state = tree_map(lambda t: t.cpu(), state)
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, 512, (2, 256)))
    labels = torch.from_numpy(rng.randint(0, 512, (2, 256)))
    for i in range(2):
        state, loss = cuda_step(state, tokens.cuda(), labels.cuda())
        cpu_state, cpu_loss = cpu_step(cpu_state, tokens, labels)
        print(f"small step {i}: cuda loss {loss.item():.6f} "
              f"cpu loss {cpu_loss.item():.6f}")
        # fp32 on both, summation orders differ: 1e-5 relative
        check(abs(loss.item() - cpu_loss.item())
              <= 1e-5 * abs(cpu_loss.item()), "small-step loss")
    # an Adam step moves a weight by about lr = 3e-4; where the two steps'
    # gradients cancel in m, rounding differences are amplified, so the
    # masters are held to a third of one step
    err = max(_err(a.cpu(), b) for a, b in zip(
        tree_leaves(state["master"]), tree_leaves(cpu_state["master"])))
    print(f"small step master max abs err {err:.3g}")
    check(err <= 1e-4, f"small-step master err {err}")


def main_path():
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    phase("5 main path")
    small_step_check()
    torch.cuda.empty_cache()

    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    init_fn, step = gpt.build_train_step(cfg, lr=1e-4, remat=True,
                                         device="cuda")
    state = init_fn(0)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (BATCH, SEQ))).cuda()
    labels = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (BATCH, SEQ))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, tokens, labels)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss.item())
        if i:
            step_ms.append(dt)
        print(f"step {i}{' (warm-up)' if not i else ''}: loss "
              f"{losses[-1]:.5f} {dt:.1f} ms")
    launches = dict(fa.LAUNCHES)
    n_steps = 1 + TIMED_STEPS
    per_step = {"flash_fwd": 2 * cfg.num_layers,
                "flash_bwd_dkv": cfg.num_layers,
                "flash_bwd_dq": cfg.num_layers}
    print(f"launches over {n_steps} steps: {launches}")
    for name, n in per_step.items():
        check(launches[name] == n * n_steps,
              f"{name} launched {launches[name]} times, want "
              f"{n * n_steps}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    med_ms = float(np.median(step_ms))
    tok_s = BATCH * SEQ / (med_ms / 1e3)
    mfu = gpt_flops_per_token(cfg) * tok_s / PEAK_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    print(f"gpt2-medium b{BATCH} s{SEQ} bf16 remat adamw: "
          f"median {med_ms:.2f} ms/step of {TIMED_STEPS} "
          f"(steps {[round(x, 2) for x in step_ms]}), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, "
          f"peak memory {peak / 2**30:.2f} GiB")
    profile_step(step, state, tokens, labels, med_ms)
    return launches, med_ms


def gpt_flops_per_token(cfg) -> float:
    """6 N + 12 L s h, as ``bench.py`` counts a GPT step (no recompute)."""
    h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    n_params = 12 * L * h * h + v * h + cfg.max_position_embeddings * h
    return 6 * n_params + 12 * L * SEQ * h


def _eager_step(paddle, model, crit, opt, x, y):
    """One eager training step under bf16 O1, in the trainer's profiler
    ranges (forward, backward, optimizer)."""
    from torch.profiler import record_function
    with record_function("forward"):
        with paddle.amp.auto_cast(dtype="bfloat16"):
            loss = crit(model(x), y)
    loss.backward()
    with record_function("optimizer"):
        opt.step()
        opt.clear_grad()
    return loss


def small_eager_check():
    """One fp32 eager step of a small GPT on the card against the same
    step on the port's CPU eager path (the path the CPU tests hold against
    the JAX package), from the same weights: loss 1e-5 relative, parameters
    after one AdamW step 1e-4 (an Adam step moves each by about lr)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, max_position_embeddings=256,
                        dtype="float32")
    rng = np.random.RandomState(1)
    x_np, y_np = (rng.randint(0, 512, (2, 256)) for _ in range(2))
    results = []
    for dev in ("gpu", "cpu"):
        paddle.set_device(dev)
        paddle.seed(0)
        model = gpt.GPTForPretraining(cfg)
        if results:
            model.set_state_dict(results[0][2])
        opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
        crit = gpt.GPTPretrainingCriterion()
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        loss = crit(model(paddle.to_tensor(x_np)), paddle.to_tensor(y_np))
        loss.backward()
        opt.step()
        results.append((float(loss), [p.numpy() for p in model.parameters()],
                        state))
    paddle.set_device("gpu")
    (g_loss, g_params, _), (c_loss, c_params, _) = results
    err = max(float(np.abs(a - b).max()) for a, b in zip(g_params, c_params))
    print(f"small eager step: cuda loss {g_loss:.6f} cpu loss {c_loss:.6f}; "
          f"parameters after one AdamW step max abs err {err:.3g}")
    check(abs(g_loss - c_loss) <= 1e-5 * abs(c_loss), "small eager loss")
    check(err <= 1e-4, f"small eager parameters err {err}")


def eager_path(smi, compiled_ms):
    """The eager API's training loop on gpt2-medium at full width and
    depth: fp32 parameters, bf16 O1 ``auto_cast``, AdamW lr 1e-4, no
    recompute, batch ``BATCH`` x seq ``SEQ``, 1 warm-up and 5 timed
    steps. Each step must launch 24 bf16 forward, dK/dV and dQ kernels at
    head_dim 64 and no other port kernel."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    phase("10 eager path")
    small_eager_check()
    torch.cuda.empty_cache()

    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    paddle.set_device("gpu")
    paddle.seed(0)
    model = gpt.GPTForPretraining(cfg)
    crit = gpt.GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    n_params = sum(p.size for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    seen = set()  # (kernel, io type, head_dim) of each launch
    launch = fa._launch

    def spy(name, tensors, *args):
        seen.add((name, tensors[0].dtype, tensors[0].shape[-1]))
        return launch(name, tensors, *args)

    _reset_all_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        fa._launch = spy if i == 0 else launch
        t0 = time.perf_counter()
        loss = _eager_step(paddle, model, crit, opt, x, y)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        if i:
            step_ms.append(dt)
        print(f"eager step {i}{' (warm-up)' if not i else ''}: loss "
              f"{losses[-1]:.5f} {dt:.1f} ms")
    fa._launch = launch
    launches = _all_launches()
    n_steps = 1 + TIMED_STEPS
    print(f"port kernel launches over {n_steps} steps: {launches}; launched "
          f"in the warm-up step: {sorted((n, str(t), d) for n, t, d in seen)}")
    for name, n in launches.items():
        want = cfg.num_layers * n_steps if name in fa.LAUNCHES else 0
        check(n == want, f"{name} launched {n} times, want {want}")
    check(seen == {(n, torch.bfloat16, cfg.head_dim) for n in fa.LAUNCHES},
          f"launches not all bf16 at head_dim {cfg.head_dim}: {seen}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    med_ms = float(np.median(step_ms))
    tok_s = BATCH * SEQ / (med_ms / 1e3)
    mfu = gpt_flops_per_token(cfg) * tok_s / PEAK_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    print(f"eager gpt2-medium ({n_params} parameters, fp32) b{BATCH} "
          f"s{SEQ} bf16 O1 adamw, no recompute: median {med_ms:.2f} ms/step "
          f"of {TIMED_STEPS} (steps {[round(v, 2) for v in step_ms]}), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, peak memory "
          f"{peak / 2**30:.2f} GiB on {smi}; the compiled functional step "
          f"(phase 5, bf16 params, remat) {compiled_ms:.2f} ms, "
          f"{med_ms / compiled_ms:.3f}x")
    check(peak < DEVICE_BYTES, f"peak memory {peak} >= {DEVICE_BYTES}")
    profile_step(lambda *_: _eager_step(paddle, model, crit, opt, x, y),
                 None, None, None, med_ms)


def _vision_group(name: str) -> str:
    """The ResNet step's kernels by what they do. The batch norm's
    statistics are its reductions (``var_mean``'s Welford kernels and
    their backward sums); its normalisation, the ReLUs, the residual adds
    and the casts are elementwise kernels, by name indistinguishable."""
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout transposes (NCHW <-> NHWC)"
    if any(k in low for k in ("conv", "cudnn", "implicit", "xmma", "wgrad",
                              "dgrad", "fprop", "gemm", "nvjet", "cutlass",
                              "sm90_")):
        return "convolution and matmul (cuDNN / cuBLAS)"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer (foreach)"
    if "pool" in low:
        return "pooling"
    if "welford" in low or "reduce" in low or "norm" in low:
        return "batch norm statistics (reductions)"
    if any(k in low for k in ("softmax", "nll", "gather", "cross")):
        return "softmax / loss"
    return "elementwise and casts"


def _kernel_group(name: str) -> str:
    if "pt_flash" in name:
        return "flash attention (port)"
    if "pt_fused" in name:
        return "RMSNorm / SwiGLU (port)"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "index" in name or "embedding" in name or "scatter" in name:
        return "embedding / index"
    if any(k in name for k in ("softmax", "log_softmax", "nll", "gather")):
        return "softmax / loss"
    if "reduce" in name:
        return "reductions"
    return "elementwise / other"


def profile_step(step, state, tokens, labels, step_ms, group=None):
    """One more step under ``torch.profiler``: device time by phase and by
    kernel group, and the device's idle share of ``step_ms`` (the median
    step without the profiler, whose own cost inflates the traced step's
    wall time). A breakdown, not a check: the launches it makes come after
    the counts were read."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, tokens, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda_type = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    # the trainer's record_function ranges also appear on the device side,
    # spanning the kernels they launched: keep them out of the kernel sums
    kernels = [e for e in events if e.device_type == cuda_type
               and e.key not in PHASES]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms <= 0:
        print("profile: the profiler saw no device time")
        return
    print(f"profile of one step: device busy {total_ms:.1f} ms; idle share "
          f"{max(0.0, 1 - total_ms / step_ms):.3f} of the {step_ms:.1f} ms "
          f"median step (traced step wall {wall_ms:.1f} ms, profiler on)")
    phase_ms = {}
    for name in PHASES:
        host = [e for e in events if e.key == name
                and e.device_type != cuda_type]
        phase_ms[name] = host[0].device_time_total / 1e3 if host else 0.0
    phase_ms["backward (the rest)"] = total_ms - sum(phase_ms.values())
    for name, t in phase_ms.items():
        print(f"  phase {name}: {t:.2f} ms ({t / total_ms:.1%})")
    groups = {}
    for e in kernels:
        g = (group or _kernel_group)(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {t:.2f} ms ({t / total_ms:.1%})")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print(f"  top: {e.self_device_time_total / 1e3:8.2f} ms "
              f"x{e.count:<5d} {e.key[:110]}")


def _all_launches():
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    from paddle_tpu_torch.ops.cuda import fused as fu
    return {**fa.LAUNCHES, **fv.LAUNCHES, **fu.LAUNCHES}


def _reset_all_launches():
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    from paddle_tpu_torch.ops.cuda import fused as fu
    for mod in (fa, fv, fu):
        mod.reset_launches()


def varlen_path(expected, smi):
    """Forward and backward through ``nn.functional.flash_attn_unpadded``
    at the packed shape, on the inputs of the full-width kernel check:
    each varlen kernel launched once, and the results those kernels gave
    there, bit for bit (the kernels write every element once, in a fixed
    order)."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    phase("6 varlen path")
    q, k, v, do, cu, _, _ = _varlen_inputs(
        DOCS, DOCS, 0, 0, HEADS, HEAD_DIM, torch.bfloat16, True, seed=3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    scale = 1.0 / math.sqrt(HEAD_DIM)

    def fwd_bwd():
        for t in (q, k, v):
            t.grad = None
        out, _ = F.flash_attn_unpadded(q, k, v, cu, cu, max(DOCS),
                                       max(DOCS), scale, causal=True)
        out.backward(do)
        return out

    torch.cuda.synchronize()
    fv.reset_launches()
    t0 = time.perf_counter()
    out = fwd_bwd()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fv.LAUNCHES)
    print(f"launches in one forward and backward: {launches}")
    for kname in launches:
        want = 1 if kname in VARLEN else 0
        check(launches[kname] == want, f"{kname} launched "
              f"{launches[kname]} times, want {want}")
    launches = {kname: launches[kname] for kname in VARLEN}
    got = (out, q.grad, k.grad, v.grad)
    for key, g, want in zip(("out", "dq", "dk", "dv"), got, expected):
        check(bool(torch.isfinite(g.float()).all()), f"path {key} non-finite")
        check(torch.equal(g, want), f"path {key} differs from the checked "
              f"kernels' result (max {_err(g, want):.3g})")
    print("out, dq, dk, dv finite and equal to the checked kernels' results")
    ms = cuda_ms(fwd_bwd, 10)
    t = sum(DOCS)
    print(f"flash_attn_unpadded fwd+bwd, T {t} ({len(DOCS)} documents), "
          f"{HEADS} heads, d {HEAD_DIM}, bf16, causal: {ms:.4f} ms "
          f"({t / (ms / 1e3):.1f} tokens/s; first call {first_ms:.2f} ms "
          f"host clock) on {smi}")
    return launches, ms


def flashmask_path(expected, smi):
    """Forward and backward through ``nn.functional.flashmask_attention``
    at its path shape, on the inputs of the full-width kernel check: each
    flashmask kernel launched once and nothing else, and the results those
    kernels gave there, bit for bit. Then batch row 1 (the document mask)
    against ``flash_attn_unpadded`` over the same documents: the same
    pairs in the same 64-row tiles, held to phase 3's per-element limit."""
    import paddle_tpu_torch.nn.functional as F
    phase("7 flashmask path")
    (e_out, e_dq, e_dk, e_dv), abs_v_out = expected
    b, s, h, d = 2, FM_SEQ, HEADS, HEAD_DIM
    q, k, v, do = _flashmask_inputs(b, s, s, h, d, torch.bfloat16, seed=6)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    startend = torch.from_numpy(flashmask_startend()).cuda()

    def fwd_bwd():
        for t in (q, k, v):
            t.grad = None
        out = F.flashmask_attention(q, k, v, startend, causal=True)
        out.backward(do)
        return out

    torch.cuda.synchronize()
    _reset_all_launches()
    t0 = time.perf_counter()
    out = fwd_bwd()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = _all_launches()
    print(f"launches in one forward and backward: {launches}")
    for kname, n in launches.items():
        want = 1 if kname in FLASHMASK else 0
        check(n == want, f"{kname} launched {n} times, want {want}")
    launches = {kname: launches[kname] for kname in FLASHMASK}
    got = (out, q.grad, k.grad, v.grad)
    for key, g, want in zip(("out", "dq", "dk", "dv"), got,
                            (e_out, e_dq, e_dk, e_dv)):
        check(bool(torch.isfinite(g.float()).all()), f"path {key} non-finite")
        check(torch.equal(_heads(g), want), f"path {key} differs from the "
              f"checked kernels' result (max {_err(_heads(g), want):.3g})")
    print("out, dq, dk, dv finite and equal to the checked kernels' results")

    # batch row 1 through the varlen path, over its documents
    qv, kv, vv = (t[1].detach().clone().requires_grad_() for t in (q, k, v))
    cu = torch.tensor([0] + FM_DOCS, device="cuda").cumsum(0).int()
    v_out, _ = F.flash_attn_unpadded(qv, kv, vv, cu, cu, max(FM_DOCS),
                                     max(FM_DOCS), 1.0 / math.sqrt(d),
                                     causal=True)
    v_out.backward(do[1])
    row1 = slice(h, 2 * h)  # grid heads of batch row 1
    abs_v_row1 = abs_v_out[row1].transpose(0, 1)
    parts = []
    for key, fm, var in zip(("out", "dq", "dk", "dv"), got,
                            (v_out, qv.grad, kv.grad, vv.grad)):
        want = fm[1]
        err, ratio = within(var, want, limit(torch.bfloat16, key, want,
                                             abs_v_row1))
        check(math.isfinite(ratio) and ratio <= 1.0, f"varlen cross-check "
              f"{key} at {ratio:.3g} of its limit")
        same = "bit-equal" if torch.equal(var, want) \
            else f"{ratio:.3g} of the limit"
        parts.append(f"{key} {err:.3g} ({same})")
    print("batch row 1 against flash_attn_unpadded over its documents: "
          + ", ".join(parts))

    ms = cuda_ms(fwd_bwd, 10)
    print(f"flashmask_attention fwd+bwd, batch {b} x seq {s} ({b * s} "
          f"tokens), {h} heads, d {d}, bf16, causal, startend "
          f"{list(startend.shape)}: {ms:.4f} ms ({b * s / (ms / 1e3):.1f} "
          f"tokens/s; first call {first_ms:.2f} ms host clock) on {smi}")
    return launches, ms


def path_limit(want):
    """Per-element bound on |fused path - plain composition| for bf16
    results that come out of products over thousands of terms whose
    inputs may sit one bf16 ulp apart: one ulp of the element (2^-7 of
    it) plus half an ulp of the largest element."""
    w = want.float().abs()
    return 2 ** -7 * w + 2 ** -8 * w.max()


def fused_path(expected, smi):
    """The MLP half of a decoder layer at the fused-op path's widths,
    through ``incubate.nn.functional``, forward and backward:

        h, res = fused_rms_norm(x, w, residual=r)
        a = swiglu(h @ W_gu)        # the split form
        y = a @ W_down

    One RMSNorm and one SwiGLU launch in the forward and none in the
    backward (its closed forms are plain torch); h and a equal bit for bit
    the kernels' phase-3 results on the same tensors; y and the gradients
    of x, r, w, W_gu and W_down within ``path_limit`` of the same
    composition through the plain versions."""
    import paddle_tpu_torch.incubate.nn.functional as IF
    from paddle_tpu_torch.ops.cuda import fused as fu
    phase("8 fused-op path")
    e_h, e_a = expected
    hid, f, eps = fused_widths()
    x, r, w, w_gu, w_down, dy = fused_path_inputs()
    leaves = (x, r, w, w_gu, w_down)
    for t in leaves:
        t.requires_grad_()

    def forward():
        h, res = IF.fused_rms_norm(x, w, epsilon=eps, residual=r)
        a = IF.swiglu(h @ w_gu)
        return h, res, a, a @ w_down

    def fwd_bwd():
        for t in leaves:
            t.grad = None
        y = forward()[3]
        y.backward(dy)
        return y

    torch.cuda.synchronize()
    _reset_all_launches()
    t0 = time.perf_counter()
    h, res, a, y = forward()
    torch.cuda.synchronize()
    fwd_launches = _all_launches()
    y.backward(dy)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = _all_launches()
    print(f"launches in the forward: {fwd_launches}; after the backward: "
          f"{launches}")
    for kname, n in launches.items():
        want = 1 if kname in FUSED else 0
        check(n == want and fwd_launches[kname] == want,
              f"{kname} launched {n} times, want {want}, all in the forward")
    check(torch.equal(res, (x + r).detach()), "residual output is not x + r")
    for key, got, want in (("h", h.reshape(-1, hid), e_h),
                           ("a", a.reshape(-1, f), e_a)):
        check(torch.equal(got.detach().cpu(), want), f"path {key} differs "
              f"from the checked kernel's result (max "
              f"{_err(got.detach().cpu(), want):.3g})")
    print("h and a equal to the checked kernels' results, bit for bit")

    # the same composition through the plain versions, under autograd
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    px, pr, pw, pgu, pdown = plain
    ph = fu.rms_norm_fwd_plain(px + pr, pw, eps)
    pg = ph @ pgu
    py = fu.swiglu_fwd_plain(pg[..., :f], pg[..., f:]) @ pdown
    py.backward(dy)
    parts = []
    for key, got, want in [("y", y, py)] + [
            (f"d{k}", t.grad, p.grad) for k, t, p in zip(
                ("x", "r", "w", "W_gu", "W_down"), leaves, plain)]:
        check(bool(torch.isfinite(got.float()).all()), f"path {key} "
              f"non-finite")
        err, ratio = within(got.detach(), want.detach(), path_limit(want))
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"path {key} at {ratio:.3g} of its limit")
        parts.append(f"{key} {err:.3g} ({ratio:.3g} of the limit)")
    print("against the plain composition: " + ", ".join(parts))
    del plain, px, pr, pw, pgu, pdown, ph, pg, py

    ms = cuda_ms(fwd_bwd, 10)
    tokens = x.shape[0] * x.shape[1]
    print(f"fused-op path ({FUSED_CFG} widths: hidden {hid}, intermediate "
          f"{f}; {tokens} tokens, bf16) fwd+bwd: {ms:.4f} ms "
          f"({tokens / (ms / 1e3):.1f} tokens/s; first call {first_ms:.2f} "
          f"ms host clock) on {smi}")
    return {kname: launches[kname] for kname in FUSED}, ms


def small_llama_check():
    """The CUDA LLaMA train step against the port's CPU path on a small
    fp32 GQA config: two steps from the same state, held as
    ``small_step_check`` holds the GPT."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.trainer import tree_leaves, tree_map
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=128,
                            intermediate_size=352, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_position_embeddings=256,
                            dtype="float32")
    init_fn, cuda_step = llama.build_train_step(cfg, device="cuda")
    _, cpu_step = llama.build_train_step(cfg, device="cpu")
    state = init_fn(0)
    cpu_state = tree_map(lambda t: t.cpu(), state)
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, 512, (2, 128)))
    labels = torch.from_numpy(rng.randint(0, 512, (2, 128)))
    for i in range(2):
        state, loss = cuda_step(state, tokens.cuda(), labels.cuda())
        cpu_state, cpu_loss = cpu_step(cpu_state, tokens, labels)
        print(f"small llama step {i}: cuda loss {loss.item():.6f} "
              f"cpu loss {cpu_loss.item():.6f}")
        check(abs(loss.item() - cpu_loss.item())
              <= 1e-5 * abs(cpu_loss.item()), "small llama step loss")
    err = max(_err(a.cpu(), b) for a, b in zip(
        tree_leaves(state["master"]), tree_leaves(cpu_state["master"])))
    print(f"small llama step master max abs err {err:.3g}")
    check(err <= 1e-4, f"small llama step master err {err}")


def llama_path(smi):
    """The LLaMA trainer at ``LLAMA_CFG``'s widths with the depth cut to
    ``LLAMA_LAYERS``: bf16 params, fp32 master, remat per block, AdamW,
    batch ``LLAMA_BATCH`` x seq ``LLAMA_SEQ``, 1 warm-up and 5 timed
    steps. No port kernel may launch: the reference's LLaMA calls none."""
    from paddle_tpu_torch.models import llama
    phase("9 llama path")
    small_llama_check()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(llama.LLAMA_CONFIGS[LLAMA_CFG],
                              num_layers=LLAMA_LAYERS)
    b, s = LLAMA_BATCH, LLAMA_SEQ
    init_fn, step = llama.build_train_step(cfg, lr=1e-4, remat=True,
                                           device="cuda")
    state = init_fn(0)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, tokens, labels)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss.item())
        if i:
            step_ms.append(dt)
        print(f"step {i}{' (warm-up)' if not i else ''}: loss "
              f"{losses[-1]:.5f} {dt:.1f} ms")
    launches = _all_launches()
    print(f"port kernel launches over {1 + TIMED_STEPS} steps: {launches}")
    check(not any(launches.values()), "the LLaMA path launched a port "
          "kernel; its reference calls none")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    print(f"losses fell at {sum(b_ < a_ for a_, b_ in zip(losses, losses[1:]))}"
          f" of {len(losses) - 1} steps")
    med_ms = float(np.median(step_ms))
    tok_s = b * s / (med_ms / 1e3)
    n_params = llama.num_params(cfg)
    flops_per_token = 6 * n_params + 12 * cfg.num_layers * s \
        * cfg.hidden_size
    mfu = flops_per_token * tok_s / PEAK_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    print(f"{LLAMA_CFG} widths, {cfg.num_layers} layers ({n_params} "
          f"parameters, {flops_per_token / 1e9:.3f} GFLOP per token) b{b} "
          f"s{s} bf16 remat adamw: median {med_ms:.2f} ms/step of "
          f"{TIMED_STEPS} (steps {[round(x, 2) for x in step_ms]}), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, peak memory "
          f"{peak / 2**30:.2f} GiB on {smi}")
    check(peak < DEVICE_BYTES, f"peak memory {peak} >= {DEVICE_BYTES}")
    profile_step(step, state, tokens, labels, med_ms)


# the ResNet path: bench_suite.py's ResNet-50 workload (resnet.py as
# built, 1000 classes, batch 64 x 3 x 224 x 224, O1 bf16, Momentum 0.1),
# trained eagerly
RESNET_BATCH, RESNET_SIZE = 64, 224


def conv_linear_macs(model, x) -> int:
    """Multiply-adds of one forward of ``model`` on ``x``, counted from the
    shapes its ``Conv2D`` and ``Linear`` layers see: each output element
    of a convolution takes in / groups x kh x kw of them, of a linear
    layer its input width."""
    import paddle_tpu_torch as paddle
    total = [0]

    def hook(layer, args, out):
        w = layer.weight.shape
        per = w[1] * w[2] * w[3] if isinstance(layer, paddle.nn.Conv2D) \
            else w[0]
        total[0] += out.size * per

    handles = [m.register_forward_post_hook(hook)
               for m in model.sublayers(include_self=True)
               if isinstance(m, (paddle.nn.Conv2D, paddle.nn.Linear))]
    model.eval()  # leaves the BN buffers as they are
    with paddle.no_grad():
        model(x)
    model.train()
    for h in handles:
        h.remove()
    return total[0]


def _resnet_steps(paddle, model, opt, x, y, steps, dev):
    """``steps`` Momentum steps in fp32 on ``dev``; the losses and the
    final state as numpy."""
    import paddle_tpu_torch.nn.functional as F
    xs = paddle.to_tensor(x, dtype=x.dtype.name, place=dev)
    ys = paddle.to_tensor(y, place=dev)
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(model(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.numpy().astype(np.float64))
    return losses, {k: v.numpy().astype(np.float64)
                    for k, v in model.state_dict().items()}


def small_resnet_check():
    """``resnet18(num_classes=10)`` on 4 x 3 x 64 x 64, three Momentum
    steps (lr 0.1) on the card against the port's CPU path from the same
    weights: in float64 the losses, parameters and BN buffers agree to
    1e-9 of each tensor's largest element (cuDNN's and the CPU's
    convolutions, the same batch norm, pooling and update); in fp32 (TF32
    off) to 1e-4 of it, train-mode batch norm over 16 values per channel
    in layer4 amplifying summation-order rounding through 18 layers and
    three updates (7.9e-6 of it measured on an H100)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, (4,)).astype(np.int64)
    paddle.set_device("cpu")
    paddle.seed(0)
    init = {k: v.numpy() for k, v in resnet18(num_classes=10)
            .state_dict().items()}
    runs = {}
    for dtype, tol in (("float64", 1e-9), ("float32", 1e-4)):
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            model = resnet18(num_classes=10)
            model.set_state_dict(init)
            model.astype(dtype)
            opt = paddle.optimizer.Momentum(0.1,
                                            parameters=model.parameters())
            runs[dev] = _resnet_steps(paddle, model, opt,
                                      x.astype(dtype), y, 3, dev)
        (g_loss, g_state), (c_loss, c_state) = runs["gpu"], runs["cpu"]
        worst = 0.0
        for k in c_state:
            scale = max(1.0, float(np.abs(c_state[k]).max()))
            worst = max(worst, float(np.abs(g_state[k] - c_state[k]).max())
                        / scale)
        loss_err = max(abs(float(a - b)) / max(1.0, abs(float(b)))
                       for a, b in zip(g_loss, c_loss))
        print(f"small resnet18 {dtype}: losses cuda "
              f"{[round(float(v), 6) for v in g_loss]} cpu "
              f"{[round(float(v), 6) for v in c_loss]}; parameters and BN "
              f"buffers after 3 Momentum steps, max abs err over the "
              f"tensor's scale {worst:.3g}, losses {loss_err:.3g} (limit "
              f"{tol:g})")
        check(worst <= tol and loss_err <= tol,
              f"small resnet18 {dtype}: state {worst}, loss {loss_err}")
    paddle.set_device("gpu")


def _resnet_step(paddle, F, model, opt, x, y):
    """One eager ResNet step under bf16 O1, in the profiler ranges
    (forward, backward, optimizer)."""
    from torch.profiler import record_function
    with record_function("forward"):
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
    loss.backward()
    with record_function("optimizer"):
        opt.step()
        opt.clear_grad()
    return loss


def resnet_path(smi):
    """``bench_suite.py``'s ResNet-50 workload trained eagerly through the
    port: ``resnet50()`` (fp32 parameters, 1000 classes), batch
    ``RESNET_BATCH`` x 3 x ``RESNET_SIZE``^2, ``amp.auto_cast`` O1 bf16,
    ``optimizer.Momentum(0.1)``, ``F.cross_entropy``; 1 warm-up and 5
    timed steps on the host clock, each ending in a synchronize. The
    losses must be finite and fall below the first; every BN running
    buffer must move and stay finite. The path has no TPU kernel: no port
    kernel may launch. ``cudnn.benchmark`` is left off (its default)."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision.models import resnet50
    phase("11 resnet path")
    small_resnet_check()
    torch.cuda.empty_cache()
    paddle.set_device("gpu")
    paddle.seed(0)
    model = resnet50()
    opt = paddle.optimizer.Momentum(0.1, parameters=model.parameters())
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randn(RESNET_BATCH, 3, RESNET_SIZE,
                                   RESNET_SIZE).astype("float32"))
    y = paddle.to_tensor(rng.randint(0, 1000, (RESNET_BATCH,))
                         .astype("int64"))
    macs = conv_linear_macs(model, x[:1])
    flops_step = 3 * 2 * macs * RESNET_BATCH
    n_params = sum(p.size for p in model.parameters())
    bn = [(n, b) for n, b in model.named_buffers()]
    before = {n: b.numpy().copy() for n, b in bn}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        loss = _resnet_step(paddle, F, model, opt, x, y)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        if i:
            step_ms.append(dt)
        print(f"resnet step {i}{' (warm-up)' if not i else ''}: loss "
              f"{losses[-1]:.5f} {dt:.1f} ms")
    launches = _all_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"port kernel launches over {1 + TIMED_STEPS} steps: {launches}")
    check(not any(launches.values()), f"a port kernel launched on the "
          f"ResNet path (it runs no TPU kernel): {launches}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    # Momentum 0.1 from scratch, no warm-up, one fixed batch of random
    # labels: the first update lowers the loss and later ones may
    # overshoot (the reference's arithmetic, which the CPU tests hold
    # equal to the port's in float64)
    check(min(losses[1:]) < losses[0], f"loss never fell below the first "
          f"step's: {losses}")
    moved = 0
    for n, b in bn:
        after = b.numpy()
        check(bool(np.isfinite(after).all()), f"BN buffer {n} not finite")
        moved += int(not np.array_equal(after, before[n]))
    print(f"BN running buffers: {moved} of {len(bn)} moved, all finite")
    check(moved == len(bn), f"only {moved} of {len(bn)} BN buffers moved")
    med_ms = float(np.median(step_ms))
    img_s = RESNET_BATCH / (med_ms / 1e3)
    mfu = flops_step / (med_ms / 1e3) / PEAK_BF16_FLOPS
    print(f"resnet50 forward: {macs / 1e9:.4f} GMAC per {RESNET_SIZE}^2 "
          f"image (its Conv2D and Linear shapes); training "
          f"{flops_step:.4e} FLOP a step (3 x 2 x MACs x batch)")
    print(f"eager resnet50 ({n_params} parameters, fp32) b{RESNET_BATCH} "
          f"{RESNET_SIZE}^2 bf16 O1 momentum: median {med_ms:.2f} ms/step "
          f"of {TIMED_STEPS} (steps {[round(v, 2) for v in step_ms]}), "
          f"{img_s:.1f} images/s, MFU {mfu:.4f} of 989 TFLOP/s, peak "
          f"memory {peak / 2**30:.2f} GiB on {smi}")
    check(peak < DEVICE_BYTES, f"peak memory {peak} >= {DEVICE_BYTES}")
    profile_step(lambda *_: _resnet_step(paddle, F, model, opt, x, y),
                 None, None, None, med_ms, group=_vision_group)
    return med_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, count, smi = card()
    build()
    with watchdog("phase 3 (kernel checks)", 300):
        errs, varlen_results, flashmask_expected, fused_expected = \
            kernel_checks()
    with watchdog("phase 4 (timings)", 300):
        ms, plain_ms, library_ms, bnd = timings()
    with watchdog("phase 4 (head_dim 256 timings)", 300):
        d256 = d256_timings()
    with watchdog("phase 4 (head_dim 512 timings)", 300):
        d512 = d512_timings()
    torch.cuda.empty_cache()
    launches, compiled_ms = main_path()
    torch.cuda.empty_cache()
    varlen_launches, _ = varlen_path(varlen_results, smi)
    launches.update(varlen_launches)
    torch.cuda.empty_cache()
    flashmask_launches, _ = flashmask_path(flashmask_expected, smi)
    launches.update(flashmask_launches)
    torch.cuda.empty_cache()
    fused_launches, _ = fused_path(fused_expected, smi)
    launches.update(fused_launches)
    torch.cuda.empty_cache()
    llama_path(smi)
    torch.cuda.empty_cache()
    eager_path(smi, compiled_ms)
    torch.cuda.empty_cache()
    with watchdog("phase 11 (resnet path)", 400):
        resnet_path(smi)
    phase("12 results")
    for hd, (d_ms, d_plain, d_lib, d_bnd) in ((256, d256), (512, d512)):
        for kname in d_ms:
            lib = d_lib[kname]
            print(f"head_dim {hd} {kname}: {d_ms[kname]:.4f} ms, plain "
                  f"{d_plain[kname]:.4f} ms, bound {d_bnd[kname][0]:.4f} ms "
                  f"({d_bnd[kname][1]}), library "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}")
    rows = []
    for kname, (source, replaces) in KERNELS.items():
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": ms[kname],
            "plain_ms": plain_ms[kname], "bound_ms": bnd[kname][0],
            "bound_by": bnd[kname][1], "library_ms": library_ms[kname],
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
