"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printed as it runs:

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. builds the flash-attention kernels (forward, dK/dV and dQ, each
   fixed-length, varlen and flashmask; each a tensor-core kernel, bf16 and
   fp16, and an FMA kernel, fp32) and the RMSNorm and SwiGLU kernels from
   the four sources of ``paddle_tpu_torch/csrc`` (``nvcc``, ``sm_90a``,
   one process per source, all at once), printing build seconds and
   ptxas's register and shared-memory lines (a spill in any tensor-core
   forward instantiation, head_dim 256 and its SPLIT form included, or in
   a tensor-core backward one at head_dim 64, 256 or SPLIT, bf16 or fp16,
   fails the run), and counting the ``HGMMA`` (tensor-core product, split
   by product, its operand type read from the suffix) and ``UTMALDG``
   (TMA load) instructions in the SASS of each tensor-core forward, dQ and
   dK/dV instantiation (``cuobjdump``; ``HOPPER_INSTANTIATIONS`` of each,
   15 per io type);
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
   sees must give dk and dv of exactly 0), the same at head_dim 256 and
   512 (the two-warpgroup forms and their SPLIT forms), in bf16 and again
   in fp16. fp16 io (all three on the tensor cores) and a head_dim of 80
   (run at 128 with zero columns) for the three masks, forward and
   backward, and bf16 and fp16 inputs on a misaligned base (the same
   kernels on aligned copies, bit for bit); fp16 at the path
   shapes of the three masks, the fixed-length one with dO at unit scale,
   2^-12 and 2^8 (and at head_dim 256 the last two); fp16 dQ alone for
   the three masks at head_dim 32-512 with dO at unit scale, 2^-12 and
   2^8, rows that see no key giving dq of exactly 0, and rows whose |dS|
   grows by more than 2^20 from their first key tile to their last (v's
   rows growing along the keys; the per-row power of two falls mid-row). RMSNorm and SwiGLU at the
   fused-op path's tensors (Llama-2-7B widths, 8192 tokens, bf16) and at
   edge shapes (fp32 and fp16, 37 rows, rows of 1000 and 1003, a float32
   weight or gate beside bf16 x, the split form with unaligned halves).
   head_dim 256 and 160 (run at 256) for the three masks in fp32, bf16 and
   fp16, forward and backward (bf16 on the tensor cores, two warpgroups a
   block, fp16 the same; fp32 on the FMA kernels at 256); head_dim 288
   (run at 512) and 512 the same way (each 256 form split over 256-column
   chunks); a misaligned bf16 base at 256; 65600 fixed-length heads (more
   than the grid's 65535 on its y axis) in bf16 and fp32; a bf16 varlen
   pack and a bf16 flashmask row of 65,537 query tiles (more than the
   grid's 65535 on its y axis: the tiles then go on x), forward and
   backward at head_dim 64 and the varlen forward and backward and the
   flashmask forward at 256, held document by document; and rows that see
   no key under ``mha_forward`` (causal, sq > sk) against the CPU path,
   20 times on the card, each repeat bit-equal to the first.
   Phases 3 and 4 each run under a watchdog that exits non-zero if a
   kernel hangs;
4. times each kernel, its plain version and, as a yardstick only,
   ``scaled_dot_product_attention`` (which the port never calls; for the
   varlen and flashmask kernels with the dense bool mask) and
   ``torch.nn.functional.rms_norm``, beside the least time the card could
   take for the same work; then the three masks' kernels again at
   head_dim 256 and at 512 (16 heads, bf16, the same tokens, on the
   tensor cores), with each kernel's shared memory per block and SDPA's
   forward and whole backward; then the kernels with fp16 io (#1-#3 at
   the path shape and at head_dim 256 and 512, #6-#11 at their path
   shapes) beside SDPA's fp16 forward and whole backward, and fp16 dQ
   (#3, #8, #11) beside bf16's;
4b. drives ``nn.functional.flash_attention`` at ``[8, 1024, 16, 256]``
   bf16 and fp16 and at ``[8, 1024, 16, 64]`` fp16, causal (Gemma-7B's
   heads and gpt2-medium's at gpt2-medium's tokens), forward and
   backward: one launch of each fixed-length kernel, out and gradients
   against the plain versions with ``limit``, ``torch.profiler`` passes
   that find ``flash_fwd_hopper``, ``flash_bwd_dkv_hopper`` and
   ``flash_bwd_dq_hopper`` of the io type and no FMA kernel, and its times
   beside the FMA backward's;
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
   with phase 5's and profiles one step; then the same model from the
   same seed under ``amp.auto_cast(level="O1", dtype="float16")`` with
   ``amp.GradScaler()``, checked the same way (24 fp16 launches of each
   kernel a step), profiled, its ``GradScaler.unscale_`` timed alone on
   one more step, and its ms/step, tokens/s, device busy, idle share and
   attention share printed beside the bf16 step's;
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
12. holds the op surface at full width: every case of
   ``paddle_tpu_torch/testing/op_cases.py`` (every registered op) on the
   card at ``FULL`` ([4, 1024, 1024]: the eager gpt2-medium's activation
   width at batch 4, not 8, since the compile path's phase 19 came;
   batched products of two such;
   decompositions at 1024 x 1024), in fp32 and, where the reference
   takes it, bf16, forward and the gradient of sum(out * r), against the
   port's CPU path on the same inputs at ``op_cases.limit`` (the special
   functions' CPU side on the first 64 rows of the first batch row);
   every output on the card; under ``torch.cuda.set_sync_debug_mode
   ("error")`` only the data-dependent cases and ``LIBRARY_SYNCS`` may
   synchronise; each forward timed (CUDA events, median of 10) beside
   its byte bound, with the ten largest ratios; the random ops held by
   their statistics on the card; prints its time. Its ``kernel`` group
   calls the kernel, MoE and attention ops by their registered names
   (``flash_attention``, ``flash_attn_varlen`` and
   ``flashmask_attention`` at ``[2, 1024, 16, 64]``, 2048 packed tokens,
   fp32 and bf16, launching kernels #1-#11 (batch 2, not the main path's
   8, since the compile path's phase 19 came: their plain versions on the
   CPU took a third of the phase); ``fused_rms_norm``,
   ``fused_swiglu``, ``fused_rope``, the MoE gates, dispatch, combine
   and ``fused_moe``) and the four segment reductions;
14. drives the ``nn`` layers: a small Transformer step (2 + 2 layers,
   d_model 64), a bidirectional 2-layer GRU and SimpleRNN (hidden 64) and
   a ``PyLayer`` with a ``register_hook`` on the card against the port's
   CPU path; then Transformer-base (``nn.Transformer()`` at its defaults,
   vocab 37000, 32 x 128 + 128 tokens, O1 bf16, label-smoothed cross
   entropy, AdamW), checking that O1 ran its 18 dense SDPAs a forward in
   bf16 and that its loss falls, and the large PTB LSTM (Zaremba et al.:
   vocab 10000, 2 x 1500, 35 steps, batch 20, dropout 0.65, SGD 1.0 with
   global-norm clip 5), each 1 warm-up and 5 timed steps with ms/step,
   tokens/s, MFU, peak memory and one profiled step's idle share; no port
   kernel may launch;
15. drives the input pipeline, the vision leftovers and the remaining
   optimizers: (a) phase 5's compiled gpt2-medium trainer fed by
   ``io.NativeTokenLoader`` through ``io.DevicePrefetcher(depth=2)`` from
   a 2^24-token Zipf file (the first batch on the card bit-equal to the
   loader's CPU read, 48/24/24 launches of #1/#2/#3 a step, losses finite
   and falling; ms/step beside phase 5's and beside the same trainer's
   fixed batch right after, the host wait on the loader, the idle share,
   the batch's copies on the prefetcher's stream); (b) phase 11's
   ResNet-50 step fed by ``DataLoader(num_workers=min(8, cores),
   shuffle=True, drop_last=True)`` over 1024 seeded uint8 256² images
   with ``RandomResizedCrop``, ``RandomHorizontalFlip``, ``ToTensor`` and
   ``Normalize`` (a deterministic pipeline's batches bit-equal with W
   workers and 0; images/s beside phase 11's and a fixed batch's, the
   idle share; the loader alone with W workers and 0); (c) the five extra
   vision families, one step on the card against the CPU path in float64
   and fp32, then b64 224² O1 bf16 steps; (d) ``vision.ops`` at Mask
   R-CNN's, Fast R-CNN's, the RPN's, YOLOv3's and SSD300's shapes against
   the CPU path, timed; (e) every new optimizer's three steps against the
   CPU path, ``LBFGS`` on least squares, then one step of each over
   gpt2-medium's 354.9 M fp32 parameters beside its byte bound and under
   ``set_sync_debug_mode("error")``; no port kernel may launch in (b)-(e);
17. (run before 16) drives BERT and the fused layers, under a watchdog
   of 300 s: (a) a bert-tiny fp32 step on the card against the port's
   CPU path, then ``models.bert.build_train_step`` at ``bench_suite.py``'s
   ``bench_bert`` shape (bert-base, batch 16 x seq 512, bf16, remat,
   AdamW lr 1e-4, weights from seed 0, tokens and labels drawn as
   ``bench_bert`` draws them), 1 warm-up and 5 timed steps: losses finite
   and falling, no port kernel launched, ms/step, tokens/s, MFU (FLOPs
   as ``bench.py`` counts them), peak memory and one profiled step; the
   same for ERNIE-3.0-base (vocab 40000) while the phase has run under
   150 s; (b) 12 ``incubate.nn.FusedTransformerEncoderLayer(768, 12,
   3072, activation="gelu")`` eagerly, O1 bf16, ``AdamW``, batch 16 x
   512, a padding mask hiding the last quarter of the keys from half the
   rows: 12 bf16 SDPAs a forward (checked), falling loss, ms/step, MFU,
   idle share; (c) the four segment reductions over [2^20, 128] fp32 in
   2^16 sorted segments (one empty) against the CPU path, fwd+bwd timed
   through the eager API and through the registered body beside the byte
   bound;
18. (run before 16) drives the main path across ranks, under a watchdog
   of 180 s: (a) ``entry.dryrun_multichip(n)`` over the machine's n cards
   through NCCL (a spawned process a rank; the tiny fp32 GPT on a dp x pp
   x mp mesh, seq 128); (b) phase 5's gpt2-medium step through
   ``models.gpt.build_train_step(mesh=ProcessMesh([[[0]]], ["dp", "pp",
   "mp"]), seq_shard=True, zero1=True, remat=True)`` at world size 1 over
   NCCL, every collective called on its one-rank group: three steps'
   losses, params and master weights bit-equal to the single-device
   trainer's from the same seed and batch, 48 / 24 / 24 launches of #1 /
   #2 / #3 a step; then both trainers timed in turns (1 warm-up and 5
   steps each way), the collectives a step, peak memory and one profiled
   step (its idle share and its NCCL kernels and device copies). One
   card runs one NCCL rank: meshes of more ranks are held by the CPU
   tests over gloo;
19. (run before 16) the compile path, under a watchdog of 720 s, with
   inductor's cache in a fresh directory removed after: (e)
   ``torch.library.opcheck`` of the 11 kernel ops on CUDA inputs; (a)
   phase 10's eager gpt2-medium with its depth cut to 6 layers
   (``COMPILED_GPT_LAYERS``) through ``paddle.jit.to_static``
   (inductor): the first step's seconds, step 1's gradients leaf by leaf
   and three losses against the eager model's from the same seed, 12 /
   12 / 12 launches of #1 / #2 / #3 a step, one trace and one forward
   and one backward graph, no library attention in a profiled step,
   ms/step, tokens/s and idle share beside the eager step in turns, peak
   memory; (b) ResNet-50 ``@to_static`` (O1, ``Momentum(0.1)``, b64
   224^2; cut to ``RESNET_COMPILED_BLOCKS`` bottleneck blocks a stage)
   against phase 11's model, three steps each from the eager
   model's state (each step's loss and BN statistics), then in fp32 cut
   to one block a stage (each step's loss, BN statistics, gradients and
   update), then timed the same way; (c) ``jit.save`` with a None batch,
   ``jit.load`` and ``inference.create_predictor`` of ResNet-50 cut as (b)
   (b64, b7) and a 2-layer GPT at gpt2-medium's width (b2, b3; #1 inside
   the loaded program) against the eager layers; (d) a ``static.nn.fc`` MLP through
   ``Executor`` with the default passes;
20. (run before 16) the steady-state runtime, under a watchdog of 300 s:
   (a) phase 10's eager gpt2-medium step (b8 s1024, O1 bf16, AdamW) under
   the ambient lazy window (``framework.enable_eager_fusion(True)``, the
   segment cap raised to ``RT_CAP`` so the step is one segment) and with
   it off, each on its own model from seed 0: three losses and step 1's
   gradients leaf by leaf, on against off (bit-equal), a steady step's
   executions under the window (the fused forward and backward and the
   update: at most 2, plus the loss read), its segments and breaks, 24 /
   24 / 24 launches of #1 / #2 / #3, the runner caches flat over 5 steady
   steps, the kernels a profiled step launches both ways (equal), and
   ms/step of each in turns (on, off, off, on), tokens/s, idle share and
   peak memory; (b) phase 14's Transformer-base and PTB LSTM under the
   window and off in turns: executions and segments a step, ms/step,
   idle share; (c) ``jit.to_static(full_graph=False)`` (SOT) of a 2-layer
   GPT at gpt2-medium's width (bf16, b2 s1024, no grad): a loss function
   that captures clean (its fast path compiled by inductor with #1
   inside the graph: the capture's and the compile's seconds, the fast
   path's ms, launches) and one with a ``print`` inside (two segments),
   each against eager;
21. (run before 16) the native runtime and the eager communication API,
   under a watchdog of ``NATIVE_WATCHDOG_S``: (a) phase 20 (a)'s step
   under the window with the lazy window's native record core and
   whole-step driver (``csrc/eager_core.cc``, built by g++ at first use)
   against its Python prong, each on its own model from seed 0: losses
   and step 1's gradients (bit-equal), a steady step's executions (2
   each), ops the driver recorded, ``FAST_OPS`` and ``REPLAY_STEPS``,
   kernels of a profiled step (equal), ms/step in turns (native, python,
   python, native), the host time spent recording a step and the idle
   share of each; then phase 14's Transformer-base and PTB LSTM both ways;
   (b) the persistent compile cache: phase 19 (a)'s compiled GPT ran with
   ``FLAGS_executable_cache_dir`` set to a fresh directory; a child
   process (``chip_smoke.py --persist-child <dir>``) warm-starts the same
   model from it: first-step seconds cold and warm, the child's
   ``cache.persist.*`` and inductor's cache counts, its three losses
   against the cold ones; then the child corrupts the entry and runs the
   model again (a reject, a new trace, the same losses); (c)
   ``DataParallel`` of
   phase 10's model on a one-rank NCCL group (the reducer summing its
   buckets): three losses and step 1's gradients bit-equal to phase 10's
   step, the buckets and collectives a step, ms/step in turns, and each
   communication entry once on a CUDA tensor against its value;
22. (run before 16) fleet's hybrid-parallel eager API and eager ZeRO,
   under a watchdog of ``FLEET_WATCHDOG_S``, on a one-rank NCCL group:
   ``fleet.init`` with every degree 1 (mode ``single``, the five mesh
   axes, each axis's group on NCCL); then phase 10's step (gpt2-medium
   b8 s1024, O1 bf16, AdamW, seed 0) through each wrapper against the
   plain step on its own model from the same seed: (a)
   ``distributed_model`` and ``distributed_optimizer`` (with
   ``ClipGradByGlobalNorm(1.0)``, the plain step too), (b)
   ``DygraphShardingOptimizer``, (c) the same with ``offload``, (d)
   ``DygraphShardingStage3`` with ``step_and_release``, (e)
   ``group_sharded_parallel`` at ``os_g`` and ``p_g_os``: three losses and
   step 1's gradients bit-equal (a sum over one rank divided by 1), the
   collectives of a step, the state and parameter bytes against the plain
   optimizer's, #1-#3 launched 24 times each a step, ms/step in turns;
   (f) the mp collectives on CUDA tensors over the one-rank mp group at
   gpt2-medium's widths against their plain versions, forward and
   backward (``mp_identity``, ``mp_allreduce``, ``mp_concat``,
   ``mp_split``; ``mp_lookup_table`` against ``F.embedding`` on the
   ``[50304, 1024]`` table; ``mp_softmax_cross_entropy`` against
   ``F.cross_entropy`` on b8 s1024 logits), ``HybridParallelGradScaler``
   against ``GradScaler`` on the fp16 step, and ``fleet.metrics``;
23. (run before 16) the eager pipeline, the semi-auto API and the
   checkpoint, under a watchdog of ``PIPELINE_WATCHDOG_S``, on a one-rank
   NCCL group, with phase 10's gpt2-medium built as a ``PipelineLayer``
   (the embeddings, 24 decoder layers, the final norm, the head tied to
   the word embeddings through a ``SharedLayerDesc``'s ``forward_func``;
   b8 s1024, O1 bf16, AdamW, seed 0): (a) ``PipelineParallel.train_batch``
   at 4 micro-batches of 2 against a hand-written four-micro-batch
   accumulation on a twin from the same seed: three losses and step 1's
   gradients bit-equal, #1-#3 launched 96 times each a step; then
   against phase 10's plain b8 step in turns: ms/step, peak memory and
   the step's rise above what was allocated before it; (b)
   ``build_pipeline_runtime`` for 1F1B, FThenB, VPP (two chunks of 12
   blocks) and ZeroBubble, three steps each: losses and gradients
   bit-equal to (a)'s hand-written accumulation (VPP: all but the tied
   word embeddings, whose two chunks' parts add in another order, within
   ``PP_VPP_WTE_REL``), ZeroBubble's F = B = W = 4 a step,
   ``max_inflight``, ``max_stash_bytes``, the NCCL barriers, ms/step; (c)
   ``shard_tensor`` and ``reshard`` through every pair of a 1-D mesh,
   multi-axis moves on a 2-D one, ``p_to_p`` and a cross-mesh move,
   ``dtensor_from_local`` / ``to_local`` / ``unshard_dtensor``, on ``wte``
   ``[50304, 1024]``, forward and backward: bit-equal, every registered
   function chosen, the collectives issued; (d) ``save_state_dict`` /
   ``load_state_dict`` of the model's 1.42 GB of fp32 parameters: the
   round trip bit-equal, a flipped byte of ``data_rank0.pkl`` refused,
   seconds and GB/s each way;
16. prints the head_dim 256 and 512 and fp16 (64, 256 and 512) timings,
   the ``kernels`` JSON line, the card line, and last ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. It never falls back
to the CPU or to a plain version: with no CUDA device it exits 1 before
doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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

_HERE = os.path.dirname(os.path.abspath(__file__))
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


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events,
    with Python's garbage collector run before and kept off during the
    calls (as ``timeit`` does): a collection landing in the timed loop
    holds the host, and a ~0.07 ms kernel launched back to back is then
    timed at the host's pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
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
          f"flash library holds a tensor-core kernel (bf16 and fp16) and an "
          f"FMA kernel (fp32), each in a fixed-length, a varlen and a "
          f"flashmask instantiation, the fused one RMSNorm and SwiGLU)")
    check(set(infos) == set(_build.SOURCES), f"built {sorted(infos)}")
    for lib in HOPPER_KERNELS:
        if infos[lib].ptxas:
            check_spills(lib, infos[lib].ptxas)
        else:  # built by an earlier process: ptxas said nothing this time
            print(f"{lib}: cached library, no ptxas lines to read")
    sass_counts(infos)


def hopper_spills(ptxas, kernel, head_dims=None):
    """(entry, spill store bytes, spill load bytes) of each instantiation
    of ``kernel`` (of those at ``head_dims`` only, when given) in ptxas's
    ``-v`` lines: each entry's "Compiling entry" line comes before its
    spill line."""
    out, entry = [], None
    for line in ptxas:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry and kernel in entry and (
                head_dims is None
                or any(f"ILi{d}E" in entry for d in head_dims)):
            out.append((entry, int(m.group(1)), int(m.group(2))))
            entry = None
    return out


def check_spills(lib, ptxas):
    """Fails unless every tensor-core instantiation of ``lib`` that
    ``SPILL_FREE`` names (each forward one; the backward ones at the main
    path's head_dim 64, one per mask, and at 256, the SPLIT form's too;
    each for every io type of ``HOPPER_IO``) has a spill line, and it says
    0 bytes stored and loaded."""
    kernel, head_dims = HOPPER_KERNELS[lib][0], SPILL_FREE[lib]
    found = hopper_spills(ptxas, kernel, head_dims)
    want = HOPPER_INSTANTIATIONS[lib] if head_dims is None else len(
        HOPPER_IO[lib]) * sum(len(MASKS) * (2 if d == 256 else 1)
                              for d in head_dims)
    check(len(found) == want, f"{len(found)} {kernel} spill lines in ptxas's "
          f"output, want {want}")
    for entry, stores, loads in found:
        check(stores == 0 and loads == 0, f"ptxas spills {stores} / {loads} "
              f"bytes in {entry}")


# the three masks every flash kernel is instantiated with
MASKS = ("CausalMask", "SegmentMask", "StartEndMask")
# the io types of each library's tensor-core kernel, as their mangled
# names spell them (the kernel's second template argument): bf16 and fp16
# for all three
IO_TAGS = {"bf16": "13__nv_bfloat16", "fp16": "6__half"}
HOPPER_IO = {"flash_fwd": ("bf16", "fp16"), "flash_bwd_dq": ("bf16", "fp16"),
             "flash_bwd_dkv": ("bf16", "fp16")}
# tensor-core instantiations per library: each kernel at head_dim 32, 64,
# 128 and 256 and the SPLIT form (256-column chunks of a wider head_dim);
# each for the three masks and each io type of HOPPER_IO
HOPPER_INSTANTIATIONS = {lib: 15 * len(io) for lib, io in HOPPER_IO.items()}
# the head_dims whose instantiations must not spill (None: every one; 256
# names the SPLIT form too): a spill serializes the wgmma products
SPILL_FREE = {"flash_fwd": None, "flash_bwd_dq": (64, 256),
              "flash_bwd_dkv": (64, 256)}
# the products from registers at head_dim 256 (P V; dQ += dS K; dV += P^T
# dO and dK += dS^T Q): one m64n256k16 or two m64n128k16 a 16-row step
WIDE_PV_SHAPES = ("64x256x16", "64x128x16")
# per library: the tensor-core kernel's name, and what its HGMMA
# products from descriptors alone and with the transpose bit (.tnspB: the
# A operand from registers, B MN-major) compute
HOPPER_KERNELS = {
    "flash_fwd": ("flash_fwd_hopper", "S = QK^T", "O += PV"),
    "flash_bwd_dq": ("flash_bwd_dq_hopper", "S = QK^T and dP = dO V^T",
                     "dQ += dS K, hi and lo"),
    "flash_bwd_dkv": ("flash_bwd_dkv_hopper", "S^T = K Q^T and dP^T = V dO^T",
                      "dV += P^T dO and dK += dS^T Q, hi and lo"),
}


def io_of(name):
    """The io type (a key of ``IO_TAGS``) of a tensor-core instantiation,
    from its mangled name: the template argument after the head_dim; None
    if there is none."""
    for io, tag in IO_TAGS.items():
        if re.search(r"ILi\d+E" + re.escape(tag), name):
            return io
    return None


def sass_split(sass, kernel):
    """Per instantiation of ``kernel`` in a ``cuobjdump -sass`` text: its
    name and io type, the ``HGMMA`` products from descriptors alone and
    those with the transpose bit (.tnspB: A from registers, B MN-major),
    the ``UTMALDG`` TMA loads, the product shapes of each kind and the
    products' type suffixes (``.F32.BF16`` for bf16 operands; fp16 ones
    carry no ``BF16``)."""
    out = []
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        name = f.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        mma = re.findall(r"HGMMA\.(\d+x\d+x\d+)(\S*) ([^;]*);", f)
        regs = [shape for shape, _, ops in mma if "tnspB" in ops]
        desc = [shape for shape, _, ops in mma if "tnspB" not in ops]
        out.append({"name": name, "io": io_of(name), "desc": len(desc),
                    "regs": len(regs), "tma": f.count("UTMALDG"),
                    "desc_shapes": sorted(set(desc)),
                    "regs_shapes": sorted(set(regs)),
                    "types": sorted({t for _, t, _ in mma})})
    return out


def check_sass(lib, sass):
    """Fails unless the SASS holds every tensor-core instantiation of
    ``lib`` (``HOPPER_INSTANTIATIONS``: 15 of each io type of
    ``HOPPER_IO``), each with products of both kinds, of its io type
    (``.BF16`` for bf16, none for fp16), and TMA loads, and the
    head_dim-256 forms' P V at a shape of ``WIDE_PV_SHAPES``; prints each
    instantiation's counts."""
    kernel, from_desc, from_regs = HOPPER_KERNELS[lib]
    found = sass_split(sass, kernel)
    want = HOPPER_INSTANTIATIONS[lib]
    check(len(found) == want, f"{len(found)} {kernel} instantiations in the "
          f"SASS, want {want}")
    for io in HOPPER_IO[lib]:
        n = sum(f["io"] == io for f in found)
        check(n == want // len(HOPPER_IO[lib]), f"{n} {io} {kernel} "
              f"instantiations in the SASS, want "
              f"{want // len(HOPPER_IO[lib])}")
    for f in found:
        print(f"  SASS {f['name']}: HGMMA {f['desc'] + f['regs']} "
              f"({f['desc']} for {from_desc}: {', '.join(f['desc_shapes'])}; "
              f"{f['regs']} for {from_regs}: {', '.join(f['regs_shapes'])}; "
              f"types {' '.join(f['types'])}), UTMALDG {f['tma']}")
        check(f["desc"] > 0 and f["regs"] > 0 and f["tma"] > 0,
              f"{f['name']}: HGMMA {f['desc']} + {f['regs']}, UTMALDG "
              f"{f['tma']}")
        bf16_products = ["BF16" in t for t in f["types"]]
        check(all(bf16_products) if f["io"] == "bf16"
              else not any(bf16_products),
              f"{f['name']}: {f['io']} instantiation with HGMMA types "
              f"{f['types']}")
        if "ILi256E" in f["name"]:
            check(any(s in f["regs_shapes"] for s in WIDE_PV_SHAPES),
                  f"{f['name']}: P V shapes {f['regs_shapes']}, want one of "
                  f"{WIDE_PV_SHAPES}")


def sass_counts(infos):
    """Counts the tensor-core products (``HGMMA``, split by product) and
    TMA tile loads (``UTMALDG``) in the SASS of each tensor-core
    instantiation (forward, dQ, dK/dV; bf16 and fp16) of the built libraries (``check_sass``). The
    toolkit's ``cuobjdump`` reads the SASS; without it the count is
    skipped and said so."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("cuobjdump not found: SASS counts skipped")
        return
    for lib in HOPPER_KERNELS:
        sass = subprocess.run([tool, "-sass", str(infos[lib].path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        check_sass(lib, sass)


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


def hold_against_plain(bh, sq, sk, d, dtype, causal, seed, do_scale=1.0):
    """Runs each kernel and its plain version on the same inputs (dO times
    ``do_scale``, a power of two: a loss scaler's range); returns the max
    abs error per kernel (over all its outputs). At a scaled dO, dq is held
    against the plain version's unrounded fp32 result (``fp32_inputs``)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    q, k, v, do = _inputs(bh, sq, sk, d, dtype, seed)
    do = do * do_scale
    args = (causal, 1.0 / math.sqrt(d), sk, sk - sq)
    out, lse = fa.flash_fwd(q, k, v, *args)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    abs_v_out = fa.flash_fwd_plain(q, k, v.abs(), *args)[0]
    delta = fa.attention_delta(do, out)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    dq_ins = (q, k, v, do) if do_scale == 1.0 else fp32_inputs(q, k, v, do)
    p_dq = fa.flash_bwd_dq_plain(*dq_ins, lse, delta, *args)
    torch.cuda.synchronize()
    pairs = {"out": (out, p_out), "lse": (lse, p_lse), "dq": (dq, p_dq),
             "dk": (dk, p_dk), "dv": (dv, p_dv)}
    errs, ratios = {}, {}
    for key, (got, want) in pairs.items():
        errs[key], ratios[key] = within(
            got, want, limit(dtype, key, want, abs_v_out, d))
    shape = f"bh {bh} sq {sq} sk {sk} d {d} {dtype} causal {causal}" + (
        f" dO x {do_scale:g}" if do_scale != 1.0 else "")
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
    """Holds a tensor-core forward's (out, lse) against its plain
    version's with ``limit`` at out's io type; ``blind`` (a bool row mask
    over out's leading dimensions) marks rows that see no key, whose out
    must be exactly 0."""
    errs, ratios = {}, {}
    dtype = got[0].dtype
    for key, g, w in zip(("out", "lse"), got, want):
        errs[key], ratios[key] = within(
            g, w, limit(dtype, key, w, abs_v_out))
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


# the tensor-core forward's edge shapes: (bh, sq, sk, kv_len, causal):
# query tiles that visit more key tiles than the K/V ring has stages,
# sq != sk both ways under the bottom-right causal offset, kv_len cutting a
# key tile
TC_FWD_EDGE = [(2, 1000, 1000, 1000, True), (2, 1024, 1024, 1024, True),
                 (2, 100, 300, 300, True), (2, 300, 100, 100, True),
                 (2, 128, 256, 150, True), (2, 128, 256, 150, False)]
# varlen: an empty segment and segments of one token
TC_VARLEN_EDGE = [1, 0, 130, 64, 1, 1]


def hold_backward(label, got, want, unseen=None, blind=None):
    """Holds a backward's (dq, dk, dv) against the plain versions' with
    ``limit`` at dq's io type; ``unseen`` (a bool mask over dk's leading
    dimensions) marks keys that no query sees, whose dk and dv must be
    exactly 0, and ``blind`` rows that see no key, whose dq must be 0."""
    errs, ratios = {}, {}
    dtype = got[0].dtype
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[key], ratios[key] = within(g, w, limit(dtype, key, w))
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


# head_dims of the tensor-core kernels' edge checks, forward and backward:
# the one-warpgroup forms at 32, 64 and 128, the two-warpgroup form at 256
# and its SPLIT form at 512
TC_EDGE_DIMS = (32, 64, 128, 256, 512)


def tensor_core_edges(dtype):
    """The tensor-core kernels in ``dtype`` (bf16 or fp16: forward, dK/dV,
    dQ; fixed-length, varlen, flashmask) at their edge shapes, at each of
    ``TC_EDGE_DIMS``, against the plain versions: rows that see no key give out and dq of exactly 0,
    keys no query sees dk and dv of exactly 0, a fully banned flashmask
    tile is skipped, documents shorter than a tile, kv_len cutting a key
    tile."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    name = str(dtype).replace("torch.", "")
    for d in TC_EDGE_DIMS:
        scale = 1.0 / math.sqrt(d)
        for bh, sq, sk, kv_len, causal in TC_FWD_EDGE:
            q, k, v, do = _inputs(bh, sq, sk, d, dtype, seed=20)
            args = (causal, scale, kv_len, sk - sq)
            got = fa.flash_fwd(q, k, v, *args)
            want = fa.flash_fwd_plain(q, k, v, *args)
            abs_v = fa.flash_fwd_plain(q, k, v.abs(), *args)[0]
            blind = torch.zeros(bh, sq, dtype=torch.bool, device="cuda")
            if causal and sq > sk:
                blind[:, :sq - sk] = True
            label = (f"edge bh {bh} sq {sq} sk {sk} kv_len {kv_len} d {d} "
                     f"{name} causal {causal}")
            hold_forward(label, got, want, abs_v, blind)
            lse, delta = got[1], fa.attention_delta(do, got[0])
            bwd = (q, k, v, do, lse, delta, *args)
            unseen = torch.zeros(bh, sk, dtype=torch.bool, device="cuda")
            unseen[:, kv_len:] = True
            hold_backward(label, (fa.flash_bwd_dq(*bwd),
                                  *fa.flash_bwd_dkv(*bwd)),
                          (fa.flash_bwd_dq_plain(*bwd),
                           *fa.flash_bwd_dkv_plain(*bwd)), unseen, blind)
        lens = TC_VARLEN_EDGE
        for causal in (True, False):
            q, k, v, do, _, _, plan = _varlen_inputs(
                lens, lens, 0, 0, 3, d, dtype, causal, seed=21)
            got = fv.varlen_fwd(q, k, v, plan, scale)
            want = fv.varlen_fwd_plain(q, k, v, plan, scale)
            abs_v = fv.varlen_fwd_plain(q, k, v.abs(), plan, scale)[0]
            label = f"edge varlen segments {lens} d {d} {name} causal {causal}"
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
            q, k, v, do = _inputs(2, s, s, d, dtype, seed=22)
            got = fv.flashmask_fwd(q, k, v, plan, scale)
            want = fv.flashmask_fwd_plain(q, k, v, plan, scale)
            abs_v = fv.flashmask_fwd_plain(q, k, v.abs(), plan, scale)[0]
            mask = fv.flashmask_mask(plan, 2, s, s)
            label = (f"edge flashmask one open key tile s {s} d {d} {name} "
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


def misaligned_checks(d=64, dtype=torch.bfloat16):
    """bf16 or fp16 inputs whose base is not 16-byte aligned (TMA refuses
    it) reach the same kernels as fresh aligned copies: forward, dK/dV and
    dQ of the three masks give, bit for bit, what they give on aligned
    inputs, at head_dim ``d``."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    q, k, v, do = _inputs(2, 256, 256, d, dtype, seed=40)
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
                   fv.varlen_delta, lambda t: t.reshape(512, 1, d)),
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
        print(f"misaligned {str(dtype).replace('torch.', '')} base, {name}, "
              f"d {d}: out, lse, dq, dk, dv equal to the aligned run, bit "
              f"for bit")


def repairs():
    """fp16 io (the tensor-core kernels) for the three masks, forward and
    backward; a head_dim of 80, run at 128 with zero columns, in bf16 and
    fp16; misaligned bf16 and fp16 bases."""
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
    for dtype in (torch.bfloat16, torch.float16):
        misaligned_checks(64, dtype)
        misaligned_checks(256, dtype)


# dO scales of the fp16 checks at the path shape: unit scale, and a loss
# scaler's range on either side (GradScaler starts at 2^16 and halves on
# overflow; gradients far below 1 reach the attention as small dO)
FP16_DO_SCALES = (1.0, 2.0 ** -12, 2.0 ** 8)


def fp16_path_checks():
    """fp16 io at the path shapes, the tensor-core forward, dK/dV and dQ
    against the plain versions with ``limit``: the fixed-length
    mask at ``[8, 16, 1024, 64]`` causal with dO at each of
    ``FP16_DO_SCALES`` and at head_dim 256 (16 heads x 1024) with the
    smallest and largest, the varlen mask over ``DOCS`` and the flashmask
    mask at its path shape, unit scale."""
    for scale in FP16_DO_SCALES:
        hold_against_plain(BATCH * HEADS, SEQ, SEQ, HEAD_DIM, torch.float16,
                           True, seed=35, do_scale=scale)
    for scale in FP16_DO_SCALES[1:]:
        hold_against_plain(D256_HEADS, SEQ, SEQ, 256, torch.float16, True,
                           seed=36, do_scale=scale)
    hold_varlen_against_plain(DOCS, DOCS, 0, 0, HEADS, HEAD_DIM,
                              torch.float16, True, seed=37)
    hold_flashmask_against_plain(
        2, FM_SEQ, FM_SEQ, HEADS, HEAD_DIM, torch.float16, True,
        torch.from_numpy(flashmask_startend()).cuda(), seed=38)


def fp32_inputs(*tensors):
    """fp32 copies of io-typed inputs. The plain backward versions compute
    in fp32 from their inputs and round once, at the end, to the inputs'
    type: on these copies they return that fp32 result unrounded. fp16 dq
    at a scaled dO is held against it: at dO x 2^-12 many dq elements are
    fp16 subnormals, spaced 2^-24 apart, above ``limit``'s floor there (1e-4
    of the largest |dq|), so two results a hair apart can round to
    neighbouring subnormals: the exact dq rounded once misses the rounded
    plain version by up to 1.26x the limit and sits within 0.67x of the
    unrounded one (``tests/test_torch_fp16_split.py``)."""
    return tuple(t.float() for t in tensors)


def _hold_dq(label, got, want, blind=None):
    """One fp16 dQ result against its plain version's fp32 result
    (``fp32_inputs``) with ``limit``: finite, within the limit, and exactly
    0 on the ``blind`` rows (rows that see no key)."""
    _, ratio = within(got, want, limit(torch.float16, "dq", want))
    check(bool(torch.isfinite(got.float()).all()), f"dq non-finite at "
          f"{label}")
    check(math.isfinite(ratio) and ratio <= 1.0, f"dq at {ratio:.3g} of its "
          f"limit at {label}")
    if blind is not None:
        check(bool(blind.any()) and not got[blind].any(), f"rows that see no "
              f"key have dq not 0 at {label}")
    return ratio


def fp16_dq_checks():
    """fp16 dQ on the tensor cores (``flash_bwd_dq_hopper`` at ``__half``)
    against the plain versions with ``limit``, for the three masks at each
    of ``TC_EDGE_DIMS`` with dO at each of ``FP16_DO_SCALES``: the
    fixed-length mask at sq 320 > sk 256, causal; the varlen mask over
    ``EDGE`` (a segment with queries and no key, padding rows); the
    flashmask mask over ``_fm_edge_startend`` (rows banned by every key,
    rows past sk). Each against the plain version's unrounded fp32 result
    (``fp32_inputs``). Rows that see no key must give dq of exactly 0.
    Then ``dq_growth_check``."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    f16 = torch.float16
    for d in TC_EDGE_DIMS:
        sc = 1.0 / math.sqrt(d)
        q, k, v, do = _inputs(4, 320, 256, d, f16, seed=71)
        args = (True, sc, 256, -64)
        out, lse = fa.flash_fwd(q, k, v, *args)
        fixed_blind = torch.zeros(4, 320, dtype=torch.bool, device="cuda")
        fixed_blind[:, :64] = True
        vq, vk, vv, vdo, cu_q, _, vplan = _varlen_inputs(*EDGE, 2, d, f16,
                                                        True, seed=72)
        v_out, v_lse = fv.varlen_fwd(vq, vk, vv, vplan, sc)
        cu = cu_q.tolist()
        v_blind = torch.zeros(vq.shape[0], dtype=torch.bool, device="cuda")
        v_blind[cu[-1]:] = True  # padding rows
        for seg, n_k in enumerate(EDGE[1]):
            if n_k == 0:
                v_blind[cu[seg]:cu[seg + 1]] = True
        fq, fk, fvv, fdo = (_heads(x) for x in _flashmask_inputs(
            2, 200, 136, 2, d, f16, seed=73))
        fplan = fv.flashmask_plan(_fm_edge_startend(2, 2, 200, 136, seed=7),
                                  2, True)
        f_out, f_lse = fv.flashmask_fwd(fq, fk, fvv, fplan, sc)
        f_blind = torch.cat([~fv.flashmask_mask(fplan.select(i), 1, 200,
                                                136).any(-1)
                             for i in range(4)])
        ratios = []
        for do_scale in FP16_DO_SCALES:
            ido = (do * do_scale, vdo * do_scale, fdo * do_scale)
            delta = fa.attention_delta(ido[0], out)
            ratios.append(_hold_dq(
                f"fp16 dq fixed d {d} dO x {do_scale:g}",
                fa.flash_bwd_dq(q, k, v, ido[0], lse, delta, *args),
                fa.flash_bwd_dq_plain(*fp32_inputs(q, k, v, ido[0]), lse,
                                      delta, *args),
                fixed_blind))
            v_delta = fv.varlen_delta(ido[1], v_out)
            ratios.append(_hold_dq(
                f"fp16 dq varlen d {d} dO x {do_scale:g}",
                fv.varlen_bwd_dq(vq, vk, vv, ido[1], v_lse, v_delta, vplan,
                                 sc),
                fv.varlen_bwd_dq_plain(*fp32_inputs(vq, vk, vv, ido[1]),
                                       v_lse, v_delta, vplan, sc),
                v_blind))
            fdelta = fa.attention_delta(ido[2], f_out)
            got = fv.flashmask_bwd_dq(fq, fk, fvv, ido[2], f_lse, fdelta,
                                      fplan, sc)
            f32 = fp32_inputs(fq, fk, fvv, ido[2])
            want = torch.cat([fv.flashmask_bwd_dq_plain(
                *(t[i:i + 1] for t in f32), f_lse[i:i + 1],
                fdelta[i:i + 1], fplan.select(i), sc) for i in range(4)])
            ratios.append(_hold_dq(f"fp16 dq flashmask d {d} dO x "
                                   f"{do_scale:g}", got, want, f_blind))
        print(f"fp16 dQ d {d}, fixed / varlen / flashmask at dO x "
              f"{' / '.join(f'{x:g}' for x in FP16_DO_SCALES)}: of the "
              f"limit {' '.join(f'{r:.3g}' for r in ratios)}; rows that see "
              f"no key ({int(fixed_blind.sum())} / {int(v_blind.sum())} / "
              f"{int(f_blind.sum())}) dq exactly 0")
    torch.cuda.synchronize()
    dq_growth_check()


# the span, in powers of two, over which dq_growth_check's rows of v grow
# along the keys: every row's largest |dS| grows by more than 2^20 over its
# key tiles
GROWTH_BITS = 26


def dq_growth_check():
    """fp16 dQ where each query row's largest |dS| grows by more than 2^20
    from its first 64-key tile to its last (not causal; q = 0, so every
    key gets the same p; v's rows in +- pairs, so that O and delta lie
    near 0, growing by 2^GROWTH_BITS along the keys, so that
    dS = p (dP - delta) scale grows with them): the kernel's per-row power
    of two falls tile by tile and the dQ rows summed so far are rescaled
    with it; at head_dim 64, 256 and 512, against the plain version's fp32
    result with ``limit``. (Scores rising along the keys would grow dS as
    well, but recomputing large scores moves p by 1e-5 of itself, which
    that construction amplifies past the limit in any kernel:
    ``tests/test_torch_fp16_split.py``.)"""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    bh, sq, sk = 2, 128, 1024
    for d in (64, 256, 512):
        sc = 1.0 / math.sqrt(d)
        gen = torch.Generator(device="cuda").manual_seed(74)
        k, v, do = (torch.randn(bh, n, d, generator=gen, device="cuda")
                    for n in (sk, sk, sq))
        v[:, 1::2] = -v[:, 0::2]
        pos = torch.arange(sk, device="cuda") // 2 * 2 / sk
        v = v * (2.0 ** (GROWTH_BITS * (pos - 0.5)))[None, :, None]
        q = torch.zeros(bh, sq, d, device="cuda")
        q, k, v, do = (t.half() for t in (q, k, v, do))
        args = (False, sc, sk, sk - sq)
        out, lse = fa.flash_fwd(q, k, v, *args)
        delta = fa.attention_delta(do, out)
        mask = fa._mask(sq, sk, False, sk, sk - sq, "cuda")
        _, ds = fa._p_ds(q, k, v, do, lse, delta, mask, sc)
        tile_max = ds.abs().view(bh, sq, sk // 64, 64).amax(-1)
        growth = (tile_max[..., -1] / tile_max[..., 0]).log2().min().item()
        check(growth > 20, f"dS grows by 2^{growth:.3g} along a row, want "
              f"more than 2^20")
        ratio = _hold_dq(f"fp16 dq growth d {d}",
                         fa.flash_bwd_dq(q, k, v, do, lse, delta, *args),
                         fa.flash_bwd_dq_plain(*fp32_inputs(q, k, v, do),
                                               lse, delta, *args))
        print(f"fp16 dQ, |dS| growing by at least 2^{growth:.3g} along each "
              f"row, d {d}: {ratio:.3g} of the limit")


def head_dim_256_checks():
    """head_dim 256 and 160 (run at 256 with zero columns), fp32, bf16 and
    fp16 (bf16 and fp16 on the tensor cores, two warpgroups a block; fp32
    on the FMA kernels at 256, whose backward works on 32-row halves of
    its 64-row tiles),
    the three masks, forward and backward, against the plain versions with
    ``limit``; the fixed-length mask at sq > sk causal (rows that see no
    key) and sq < sk."""
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
    fp16 (each kernel's 256 form split over two 256-column chunks: bf16
    and fp16 on the tensor cores, fp32 on the FMA kernels), the
    three masks, forward and backward, against the plain versions with
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


# more than 65535 query tiles of 64 rows in one head: the varlen and
# flashmask bf16 kernels, which put the heads on the grid's x axis, put the
# tiles there instead past MAX_GRID_Y (y holds at most 65535 blocks)
LONG_TILES = 65535 + 2
LONG_DOC = 4000  # the last document straddles tile 65535


def _long_hold(label, got, want, abs_v_out):
    """``got`` against ``want`` (dicts by output) with ``limit``; returns
    the largest error / limit."""
    worst = 0.0
    for key in want:
        lim = limit(torch.bfloat16, key, want[key], abs_v_out)
        err, ratio = within(got[key], want[key], lim)
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"{label} {key} at {ratio:.3g} of its limit (err {err:.3g})")
        worst = max(worst, ratio)
    return worst


def many_tiles_checks():
    """A bf16 varlen pack and a bf16 flashmask row of ``LONG_TILES * 64``
    tokens (one head, head_dim 64, causal documents of ``LONG_DOC``
    tokens; for flashmask each key's start row is its document's end),
    forward, dK/dV and dQ. The first document, one in the middle and the
    last (past tile 65535) are held against the plain versions one
    document at a time, with ``limit``."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    t = LONG_TILES * 64
    cu = list(range(0, t, LONG_DOC)) + [t]
    gen = torch.Generator(device="cuda").manual_seed(58)
    q, k, v, do = (torch.randn(t, 1, 64, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = 0.125
    docs = (0, (len(cu) - 1) // 2, len(cu) - 2)
    check((cu[-2] // 64) <= 65535 < (cu[-1] - 1) // 64,
          "the last document does not straddle tile 65535")
    cu_t = torch.tensor(cu, device="cuda", dtype=torch.int32)
    plan = fv.varlen_plan(cu_t, cu_t, t, t, True)
    out, lse = fv.varlen_fwd(q, k, v, plan, scale)
    delta = fv.varlen_delta(do, out)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    dq = fv.varlen_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    worst = 0.0
    for i in docs:
        a, b = cu[i], cu[i + 1]
        n, sl = b - a, slice(a, b)
        one = torch.tensor([0, n], device="cuda", dtype=torch.int32)
        sub = fv.varlen_plan(one, one, n, n, True)
        args = (q[sl], k[sl], v[sl])
        p_out, p_lse = fv.varlen_fwd_plain(*args, sub, scale)
        abs_v = fv.varlen_fwd_plain(q[sl], k[sl], v[sl].abs(), sub,
                                    scale)[0]
        bw = (do[sl], lse[:, sl], delta[:, sl], sub, scale)
        p_dk, p_dv = fv.varlen_bwd_dkv_plain(*args, *bw)
        p_dq = fv.varlen_bwd_dq_plain(*args, *bw)
        worst = max(worst, _long_hold(
            f"varlen {t} tokens, document {i} [{a}, {b})",
            {"out": out[sl], "lse": lse[:, sl], "dq": dq[sl], "dk": dk[sl],
             "dv": dv[sl]},
            {"out": p_out, "lse": p_lse, "dq": p_dq, "dk": p_dk,
             "dv": p_dv}, abs_v))
    del out, lse, delta, dk, dv, dq, plan
    q, k, v, do = (x.view(1, t, 64) for x in (q, k, v, do))
    ends = torch.tensor(cu[1:], device="cuda", dtype=torch.int32)
    start = ends.repeat_interleave(torch.diff(cu_t)).view(1, 1, t, 1)
    plan = fv.flashmask_plan(start, 1, True)
    out, lse = fv.flashmask_fwd(q, k, v, plan, scale)
    delta = fa.attention_delta(do, out)
    dk, dv = fv.flashmask_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    dq = fv.flashmask_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    for i in docs:
        a, b = cu[i], cu[i + 1]
        n, sl = b - a, slice(a, b)
        sub = fv.flashmask_plan(torch.full((1, 1, n, 1), n, device="cuda",
                                           dtype=torch.int32), 1, True)
        args = (q[:, sl], k[:, sl], v[:, sl])
        p_out, p_lse = fv.flashmask_fwd_plain(*args, sub, scale)
        abs_v = fv.flashmask_fwd_plain(q[:, sl], k[:, sl], v[:, sl].abs(),
                                       sub, scale)[0]
        bw = (do[:, sl], lse[:, sl], delta[:, sl], sub, scale)
        p_dk, p_dv = fv.flashmask_bwd_dkv_plain(*args, *bw)
        p_dq = fv.flashmask_bwd_dq_plain(*args, *bw)
        worst = max(worst, _long_hold(
            f"flashmask {t} rows, document {i} [{a}, {b})",
            {"out": out[:, sl], "lse": lse[:, sl], "dq": dq[:, sl],
             "dk": dk[:, sl], "dv": dv[:, sl]},
            {"out": p_out, "lse": p_lse, "dq": p_dq, "dk": p_dk,
             "dv": p_dv}, abs_v))
    print(f"{LONG_TILES} query tiles ({t} tokens, bf16, varlen and "
          f"flashmask, forward and backward): documents {docs} within "
          f"the limit, worst at {worst:.3g} of it")
    del q, k, v, do, out, lse, delta, dk, dv, dq, plan
    torch.cuda.empty_cache()
    many_tiles_d256(cu, docs)


def many_tiles_d256(cu, docs):
    """The bf16 varlen forward, dK/dV and dQ and the flashmask forward at
    head_dim 256 (the two-warpgroup forms: 128 query rows a forward or dQ
    block, one 64-key tile a dK/dV block) over the same ``LONG_TILES *
    64`` tokens of one head, held document by document against the plain
    versions with ``limit``."""
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    t, d = cu[-1], 256
    gen = torch.Generator(device="cuda").manual_seed(59)
    q, k, v, do = (torch.randn(t, 1, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    cu_t = torch.tensor(cu, device="cuda", dtype=torch.int32)
    worst = 0.0
    plan = fv.varlen_plan(cu_t, cu_t, t, t, True)
    out, lse = fv.varlen_fwd(q, k, v, plan, scale)
    delta = fv.varlen_delta(do, out)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, plan, scale)
    dq = fv.varlen_bwd_dq(q, k, v, do, lse, delta, plan, scale)
    for i in docs:
        a, b = cu[i], cu[i + 1]
        sl = slice(a, b)
        one = torch.tensor([0, b - a], device="cuda", dtype=torch.int32)
        sub = fv.varlen_plan(one, one, b - a, b - a, True)
        args = (q[sl], k[sl], v[sl])
        p_out, p_lse = fv.varlen_fwd_plain(*args, sub, scale)
        abs_v = fv.varlen_fwd_plain(q[sl], k[sl], v[sl].abs(), sub,
                                    scale)[0]
        bw = (do[sl], lse[:, sl], delta[:, sl], sub, scale)
        p_dk, p_dv = fv.varlen_bwd_dkv_plain(*args, *bw)
        p_dq = fv.varlen_bwd_dq_plain(*args, *bw)
        worst = max(worst, _long_hold(
            f"varlen {t} tokens d {d}, document {i} [{a}, {b})",
            {"out": out[sl], "lse": lse[:, sl], "dq": dq[sl], "dk": dk[sl],
             "dv": dv[sl]},
            {"out": p_out, "lse": p_lse, "dq": p_dq, "dk": p_dk,
             "dv": p_dv}, abs_v))
    del out, lse, delta, dk, dv, dq, plan, do
    q, k, v = (x.view(1, t, d) for x in (q, k, v))
    ends = torch.tensor(cu[1:], device="cuda", dtype=torch.int32)
    start = ends.repeat_interleave(torch.diff(cu_t)).view(1, 1, t, 1)
    plan = fv.flashmask_plan(start, 1, True)
    out, lse = fv.flashmask_fwd(q, k, v, plan, scale)
    for i in docs:
        a, b = cu[i], cu[i + 1]
        sl = slice(a, b)
        sub = fv.flashmask_plan(torch.full((1, 1, b - a, 1), b - a,
                                           device="cuda", dtype=torch.int32),
                                1, True)
        p_out, p_lse = fv.flashmask_fwd_plain(q[:, sl], k[:, sl], v[:, sl],
                                              sub, scale)
        abs_v = fv.flashmask_fwd_plain(q[:, sl], k[:, sl], v[:, sl].abs(),
                                       sub, scale)[0]
        worst = max(worst, _long_hold(
            f"flashmask {t} rows d {d}, document {i} [{a}, {b})",
            {"out": out[:, sl], "lse": lse[:, sl]},
            {"out": p_out, "lse": p_lse}, abs_v))
    print(f"{LONG_TILES} query tiles ({t} tokens, bf16, head_dim {d}, "
          f"varlen forward and backward, flashmask forward): documents "
          f"{docs} within the limit, worst at {worst:.3g} of it")


# the card's repeats of the keyless-rows check, each bit-equal to the first
KEYLESS_REPEATS = 20


def keyless_rows_check():
    """Causal sq > sk through ``mha_forward``, ``KEYLESS_REPEATS`` times
    on the card, every repeat bit-equal to the first: the rows that see no
    key get the reference's output (the mean of v over the key blocks the
    reference visits), on the card as on the CPU path the CPU tests hold
    against the reference; fp32, 1e-5. Prints where the largest error sits
    and whether its row sees no key."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    for sq, sk in ((576, 512), (1536, 1280)):
        q, k, v, _ = _inputs(2, sq, sk, 32, torch.float32, seed=53)
        runs = [fa.mha_forward(q, k, v, causal=True)
                for _ in range(KEYLESS_REPEATS)]
        differ = [i for i, r in enumerate(runs) if not torch.equal(r, runs[0])]
        got = runs[0]
        want = fa.mha_forward(q.cpu(), k.cpu(), v.cpu(), causal=True)
        diff = (got.cpu() - want).abs()
        err = diff.max().item()
        b, row, col = (int(i) for i in np.unravel_index(int(diff.argmax()),
                                                        diff.shape))
        keyless = got[:, :sq - sk]
        print(f"keyless rows sq {sq} sk {sk}: {len(differ)} of "
              f"{KEYLESS_REPEATS - 1} card repeats differ from the first "
              f"{differ}; max abs err against the CPU path {err:.3g} at "
              f"(b {b}, row {row}, col {col}, a row that sees no key: "
              f"{row < sq - sk}); {int((keyless != 0).any(-1).sum())} of "
              f"{keyless.shape[0] * keyless.shape[1]} keyless rows take "
              f"the reference's mean of v")
        check(not differ, f"keyless rows: card repeats {differ} differ from "
              f"the first at sq {sq} sk {sk}")
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
    for dtype in (torch.bfloat16, torch.float16):
        tensor_core_edges(dtype)
    repairs()
    fp16_path_checks()
    fp16_dq_checks()
    head_dim_256_checks()
    head_dims_above_256_checks()
    many_heads_checks()
    many_tiles_checks()
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


def varlen_timings(h, d, seed, dtype=torch.bfloat16):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    t = sum(DOCS)
    q, k, v, do, cu, _, plan = _varlen_inputs(
        DOCS, DOCS, 0, 0, h, d, dtype, True, seed=seed)
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
          f"{d}, {str(dtype).replace('torch.', '')}, causal; {kept_pairs(DOCS, DOCS, True)} kept "
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


def flashmask_timings(h, d, seed, dtype=torch.bfloat16):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    b, s = 2, FM_SEQ
    q4, k4, v4, do4 = _flashmask_inputs(b, s, s, h, d, dtype, seed=seed)
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
    print(f"flashmask: batch {b} x seq {s}, {h} heads, d {d}, "
          f"{str(dtype).replace('torch.', '')}, causal, "
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


def fixed_timings(b, h, s, d, seed, dtype=torch.bfloat16):
    """The fixed-length kernels at a causal [b * h, s, d] shape in
    ``dtype`` (bf16 or fp16): each kernel's and its plain version's ms,
    the library's (SDPA forward; its backward computes dq, dk and dv in
    one call, so it stands beside no single backward kernel and is
    printed apart) and the bounds."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    bh = b * h
    q, k, v, do = _inputs(bh, s, s, d, dtype, seed=seed)
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
    print(f"fixed-length: batch {b} x {h} heads, seq {s}, d {d}, "
          f"{str(dtype).replace('torch.', '')}, causal")
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
# shared memory a block at head_dim 256, as the launchers size it. The
# tensor-core kernels (flash_common.cuh WideSmem; bf16 and fp16): seven
# 64 x 256 tiles of 2-byte elements, 1024 bytes of alignment, 15
# mbarriers, 32 bytes of thread 0's ring state and 1 KB of dK/dV's lse and
# delta rows. The FMA kernels (fp32; flash_common.cuh: 64-row tiles of
# D + 1 floats, score tiles of 65; the
# backward in 32-row passes): the forward's Q, K, V tiles and P; dQ: 32
# rows of Q and dO, 64 of K and V, 32 x 65 dS, 32 lse and delta; dK/dV: 32
# rows of K and V, 64 of Q and dO, 64 x 33 P and dS, 64 lse and delta
_WIDE_SMEM = 1024 + 7 * 64 * 256 * 2 + 8 * 15 + 32 + 4 * 256
D256_SMEM = {"flash_fwd bf16/fp16": _WIDE_SMEM,
             "flash_bwd_dq bf16/fp16": _WIDE_SMEM,
             "flash_bwd_dkv bf16/fp16": _WIDE_SMEM,
             "flash_fwd fp32": 4 * (3 * 64 * 257 + 64 * 65),
             "flash_bwd_dq fp32": 4 * (2 * 32 * 257 + 2 * 64 * 257
                                            + 32 * 65 + 2 * 32),
             "flash_bwd_dkv fp32": 4 * (2 * 32 * 257 + 2 * 64 * 257
                                        + 2 * 64 * 33 + 2 * 64)}


def d256_timings():
    """The three masks' kernels at head_dim 256, bf16 (forward, dQ and
    dK/dV on the tensor cores, two warpgroups a block), beside their
    bounds, plain versions and the library's forward and whole
    backward."""
    print(f"head_dim 256 (bf16: every kernel on the tensor cores, two "
          f"warpgroups a block), shared memory per block: " +
          ", ".join(f"{k} {v} B" for k, v in D256_SMEM.items()) +
          " of 232448")
    results = [fixed_timings(BATCH, D256_HEADS, SEQ, 256, seed=60),
               varlen_timings(D256_HEADS, 256, seed=61),
               flashmask_timings(D256_HEADS, 256, seed=62)]
    return tuple({k: v for r in results for k, v in r[i].items()}
                 for i in range(4))


def d512_timings():
    """The three masks' kernels at head_dim 512, bf16 (each kernel's 256
    form on the tensor cores split over two 256-column chunks, one block
    per chunk: the forward with Q's two chunks resident, dQ with Q and dO
    streamed, dK/dV with K's and V's two chunks resident), beside their
    bounds, plain versions and the library's forward and whole
    backward."""
    print("head_dim 512 (bf16: each kernel's 256 form on the tensor "
          "cores split over two 256-column chunks, one block per chunk; "
          "shared memory per block as at 256)")
    results = [fixed_timings(BATCH, D256_HEADS, SEQ, 512, seed=63),
               varlen_timings(D256_HEADS, 512, seed=64),
               flashmask_timings(D256_HEADS, 512, seed=65)]
    return tuple({k: v for r in results for k, v in r[i].items()}
                 for i in range(4))


def fp16_timings(bf16_dq):
    """The kernels with fp16 io (all three on the tensor cores): #1-#3 at
    the path shape (``[8, 16, 1024, 64]``, causal) and at head_dim 256 and
    512 (16 heads), #6-#11 at their path shapes, each beside its bound,
    plain version and SDPA's fp16 forward and whole backward; then each
    fp16 dQ time beside bf16's at the same shape (``bf16_dq``: label ->
    ms, from the bf16 timings of this run). Returns (path shapes, head_dim
    256, head_dim 512), each as ``d256_timings`` returns its results."""
    print("fp16 io (all three kernels on the tensor cores) at the path "
          "shapes and at head_dim 256 and 512")
    path = [fixed_timings(BATCH, HEADS, SEQ, HEAD_DIM, seed=66,
                          dtype=torch.float16),
            varlen_timings(HEADS, HEAD_DIM, seed=68, dtype=torch.float16),
            flashmask_timings(HEADS, HEAD_DIM, seed=69, dtype=torch.float16)]
    d256 = fixed_timings(BATCH, D256_HEADS, SEQ, 256, seed=70,
                         dtype=torch.float16)
    d512 = fixed_timings(BATCH, D256_HEADS, SEQ, 512, seed=75,
                         dtype=torch.float16)
    path = tuple({k: v for r in path for k, v in r[i].items()}
                 for i in range(4))
    fp16_dq = {"#3 dq, path shape": path[0]["flash_bwd_dq"],
               "#8 varlen dq, path shape": path[0]["varlen_bwd_dq"],
               "#11 flashmask dq, path shape": path[0]["flashmask_bwd_dq"],
               "#3 dq, head_dim 256": d256[0]["flash_bwd_dq"],
               "#3 dq, head_dim 512": d512[0]["flash_bwd_dq"]}
    for label, ms in fp16_dq.items():
        print(f"fp16 {label}: {ms:.4f} ms, bf16 {bf16_dq[label]:.4f} ms, "
              f"{ms / bf16_dq[label]:.3f}x")
    return path, d256, d512


# the public-entry runs: [batch, seq, heads, head_dim] and io type; head_dim
# 256 is Gemma-7B's attention (16 heads of 256) at gpt2-medium's tokens
ENTRY_RUNS = ((BATCH, SEQ, D256_HEADS, 256, torch.bfloat16),
              (BATCH, SEQ, HEADS, HEAD_DIM, torch.float16),
              (BATCH, SEQ, D256_HEADS, 256, torch.float16))
# the bf16 head_dim-256 run's forward + backward ms when the backward ran
# the FMA kernels (chip_smoke.py phase 4b, NVIDIA H100 80GB HBM3 at 700 W)
D256_ENTRY_FMA_MS = 20.49


def entry_paths():
    """``entry_path`` at each of ``ENTRY_RUNS``."""
    phase("4b the public entry: bf16 and fp16 at head_dim 256, fp16 at 64")
    for run in ENTRY_RUNS:
        entry_path(*run)


def entry_path(b, s, h, d, dtype):
    """Drives ``nn.functional.flash_attention`` at ``[b, s, h, d]`` in
    ``dtype``, causal, forward and backward, as a user calls it: checks one
    launch of each fixed-length kernel, holds out, dq, dk and dv against
    the plain versions with ``limit`` (the plain backward from the
    kernel's own lse, as in phase 3), shows under ``torch.profiler`` that
    the forward ran ``flash_fwd_hopper`` of the io type and no
    ``flash_fwd_kernel``, and the backward ``flash_bwd_dkv_hopper`` of the
    io type and no ``flash_bwd_dkv_kernel``, and dQ on
    ``flash_bwd_dq_hopper`` of the io type and no ``flash_bwd_dq_kernel``,
    and times the forward and forward + backward (the bf16 run at 256
    beside ``D256_ENTRY_FMA_MS``)."""
    import paddle_tpu_torch.nn.functional as PF
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from torch.profiler import ProfilerActivity, profile
    io = "__half" if dtype == torch.float16 else "__nv_bfloat16"
    name = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(67)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    fa.reset_launches()
    out, _ = PF.flash_attention(ql, kl, vl, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    print(f"flash_attention [{b}, {s}, {h}, {d}] {name} causal, forward "
          f"and backward: launches {launches}")
    check(launches == {"flash_fwd": 1, "flash_bwd_dkv": 1,
                       "flash_bwd_dq": 1}, f"entry launches {launches}")

    def heads(t):
        return t.transpose(1, 2).reshape(b * h, s, d)

    q3, k3, v3, do3 = (heads(t) for t in (q, k, v, do))
    args = (True, 1.0 / math.sqrt(d), s, 0)
    out3, lse = fa.flash_fwd(q3, k3, v3, *args)
    check(torch.equal(out3, heads(out.detach())), "the entry's out differs "
          "from the forward kernel's")
    p_out, p_lse = fa.flash_fwd_plain(q3, k3, v3, *args)
    abs_v = fa.flash_fwd_plain(q3, k3, v3.abs(), *args)[0]
    delta = fa.attention_delta(do3, out3)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, *args)
    p_dq = fa.flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, *args)
    pairs = {"out": (out3, p_out), "lse": (lse, p_lse),
             "dq": (heads(ql.grad), p_dq), "dk": (heads(kl.grad), p_dk),
             "dv": (heads(vl.grad), p_dv)}
    ratios = {}
    for key, (got, want) in pairs.items():
        err, ratios[key] = within(got, want, limit(dtype, key, want, abs_v,
                                                   d))
        check(bool(torch.isfinite(got.float()).all()), f"entry {key} "
              f"non-finite")
        check(math.isfinite(ratios[key]) and ratios[key] <= 1.0,
              f"entry {key} at {ratios[key]:.3g} of its limit")
    print(f"entry {name} d {d} against the plain versions, of the "
          f"limit: " + " ".join(
        f"{k} {r:.3g}" for k, r in ratios.items()))
    del p_out, p_lse, abs_v, p_dk, p_dv, p_dq, pairs

    def traced(run):
        """The flash kernels' names in a trace of ``run``; a trace that
        recorded no flash kernel at all (CUPTI dropped a ~0.07 ms launch
        once on the card) is taken again, up to three times."""
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            names = sorted({e.key for e in prof.key_averages()
                            if "flash" in e.key})
            if names:
                return names
            print(f"trace {attempt} recorded no flash kernel; again")
        return names

    with torch.no_grad():
        names = traced(lambda: PF.flash_attention(q, k, v, causal=True))
    print(f"profiled forward, kernels: {names}")
    check(any("flash_fwd_hopper" in n and io in n for n in names)
          and not any("flash_fwd_kernel" in n for n in names),
          f"the entry's forward ran {names}, want flash_fwd_hopper at {io} "
          f"alone")
    out, _ = PF.flash_attention(ql, kl, vl, causal=True)
    names = traced(lambda: out.backward(do, retain_graph=True))
    print(f"profiled backward, kernels: {names}")
    for kernel in ("flash_bwd_dkv", "flash_bwd_dq"):
        check(any(f"{kernel}_hopper" in n and io in n for n in names)
              and not any(f"{kernel}_kernel" in n for n in names),
              f"the entry's backward ran {names}, want {kernel}_hopper "
              f"({io}) and no {kernel}_kernel")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: PF.flash_attention(q, k, v, causal=True),
                         10)
    step_ms = cuda_ms(lambda: PF.flash_attention(
        ql, kl, vl, causal=True)[0].backward(do), 5)
    before = (f" (with the FMA backward: {D256_ENTRY_FMA_MS} ms)"
              if dtype == torch.bfloat16 and d == 256 else "")
    print(f"flash_attention [{b}, {s}, {h}, {d}] {name} causal: forward "
          f"{fwd_ms:.4f} ms, forward + backward {step_ms:.4f} ms{before}")
    return launches


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


def _eager_step(paddle, model, crit, opt, x, y, dtype="bfloat16",
                scaler=None):
    """One eager training step under O1 ``dtype``, in the trainer's
    profiler ranges (forward, backward, optimizer); with a ``GradScaler``
    the loss is scaled before the backward and the step goes through the
    scaler (unscale, skip on overflow)."""
    from torch.profiler import record_function
    with record_function("forward"):
        with paddle.amp.auto_cast(level="O1", dtype=dtype):
            loss = crit(model(x), y)
    (loss if scaler is None else scaler.scale(loss)).backward()
    with record_function("optimizer"):
        if scaler is None:
            opt.step()
        else:
            scaler.step(opt)
            scaler.update()
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
    depth: fp32 parameters, O1 ``auto_cast``, AdamW lr 1e-4, no
    recompute, batch ``BATCH`` x seq ``SEQ``, 1 warm-up and 5 timed
    steps, first in bf16, then from the same seed in fp16 with a
    ``GradScaler`` (what upstream Paddle's AMP defaults to). Each step must
    launch 24 forward, dK/dV and dQ kernels at head_dim 64 in the run's io
    type and no other port kernel."""
    phase("10 eager path")
    small_eager_check()
    torch.cuda.empty_cache()
    runs = {}
    for dtype in ("bfloat16", "float16"):
        torch.cuda.empty_cache()
        runs[dtype] = eager_gpt(smi, compiled_ms, dtype)
    attention = "flash attention (port)"
    for dtype, (med_ms, prof, _) in runs.items():
        if prof is None:
            continue
        att = prof["groups"].get(attention, 0.0)
        print(f"eager {dtype}: {med_ms:.2f} ms/step, device busy "
              f"{prof['busy']:.1f} ms, idle share {prof['idle']:.3f}, "
              f"attention {att:.2f} ms ({att / prof['busy']:.1%} of busy)")
    bf16_ms, fp16_ms = runs["bfloat16"][0], runs["float16"][0]
    unscale_ms = runs["float16"][2]
    print(f"eager gpt2-medium O1: fp16 with GradScaler {fp16_ms:.2f} ms/step "
          f"({BATCH * SEQ / (fp16_ms / 1e3):.1f} tokens/s) against bf16 "
          f"{bf16_ms:.2f} ms/step ({BATCH * SEQ / (bf16_ms / 1e3):.1f} "
          f"tokens/s), {fp16_ms / bf16_ms:.3f}x; fp16's GradScaler.unscale_ "
          f"alone {unscale_ms:.2f} ms ({unscale_ms / fp16_ms:.1%} of its "
          f"step), on {smi}")


def eager_gpt(smi, compiled_ms, dtype):
    """One eager gpt2-medium run of ``eager_path`` under O1 ``dtype``
    ("bfloat16", or "float16" with a ``GradScaler``): checks its launches,
    losses and memory, prints its steps and profiles one. With the scaler,
    one more step times ``GradScaler.unscale_`` alone (the card drained
    before and after it): one host read per parameter. Returns the median
    ms/step, ``profile_step``'s summary and that time (None for bf16)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    io = {"bfloat16": torch.bfloat16, "float16": torch.float16}[dtype]
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    paddle.set_device("gpu")
    paddle.seed(0)
    model = gpt.GPTForPretraining(cfg)
    crit = gpt.GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
    scaler = paddle.amp.GradScaler() if io == torch.float16 else None
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
        loss = _eager_step(paddle, model, crit, opt, x, y, dtype, scaler)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        if i:
            step_ms.append(dt)
        print(f"eager {dtype} step {i}{' (warm-up)' if not i else ''}: loss "
              f"{losses[-1]:.5f} {dt:.1f} ms" + (
                  "" if scaler is None else
                  f", loss scale {scaler._scale:g}"))
    fa._launch = launch
    launches = _all_launches()
    n_steps = 1 + TIMED_STEPS
    print(f"port kernel launches over {n_steps} steps: {launches}; launched "
          f"in the warm-up step: {sorted((n, str(t), d) for n, t, d in seen)}")
    for name, n in launches.items():
        want = cfg.num_layers * n_steps if name in fa.LAUNCHES else 0
        check(n == want, f"{name} launched {n} times, want {want}")
    check(seen == {(n, io, cfg.head_dim) for n in fa.LAUNCHES},
          f"launches not all {dtype} at head_dim {cfg.head_dim}: {seen}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    med_ms = float(np.median(step_ms))
    tok_s = BATCH * SEQ / (med_ms / 1e3)
    mfu = gpt_flops_per_token(cfg) * tok_s / PEAK_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    print(f"eager gpt2-medium ({n_params} parameters, fp32) b{BATCH} "
          f"s{SEQ} {dtype} O1 adamw"
          f"{'' if scaler is None else ' GradScaler'}, no recompute: median "
          f"{med_ms:.2f} ms/step "
          f"of {TIMED_STEPS} (steps {[round(v, 2) for v in step_ms]}), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, peak memory "
          f"{peak / 2**30:.2f} GiB on {smi}; the compiled functional step "
          f"(phase 5, bf16 params, remat) {compiled_ms:.2f} ms, "
          f"{med_ms / compiled_ms:.3f}x")
    check(peak < DEVICE_BYTES, f"peak memory {peak} >= {DEVICE_BYTES}")
    prof = profile_step(lambda *_: _eager_step(paddle, model, crit, opt, x, y,
                                               dtype, scaler),
                        None, None, None, med_ms)
    if scaler is None:
        return med_ms, prof, None
    unscale = scaler.unscale_
    unscale_ms = []

    def timed_unscale(optimizer):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unscale(optimizer)
        torch.cuda.synchronize()
        unscale_ms.append((time.perf_counter() - t0) * 1e3)

    scaler.unscale_ = timed_unscale
    _eager_step(paddle, model, crit, opt, x, y, dtype, scaler)
    torch.cuda.synchronize()
    scaler.unscale_ = unscale
    n_grads = sum(1 for _ in opt._all_params())
    print(f"GradScaler.unscale_ alone: {unscale_ms[0]:.2f} ms over {n_grads} "
          f"parameters (one isfinite read to the host each), "
          f"{unscale_ms[0] / med_ms:.1%} of the {med_ms:.2f} ms median step")
    return med_ms, prof, unscale_ms[0]


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
    the counts were read. Returns the device busy ms, the idle share and
    the ms of each kernel group (None if the profiler saw no device
    time)."""
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
        return None
    idle = max(0.0, 1 - total_ms / step_ms)
    print(f"profile of one step: device busy {total_ms:.1f} ms; idle share "
          f"{idle:.3f} of the {step_ms:.1f} ms "
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
    return {"busy": total_ms, "idle": idle, "groups": groups,
            "names": {e.key for e in events}}


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


def _resnet_step(paddle, F, model, opt, x, y, amp=True):
    """One eager ResNet step under bf16 O1 (fp32 with ``amp=False``), in
    the profiler ranges (forward, backward, optimizer)."""
    from torch.profiler import record_function
    with record_function("forward"):
        with paddle.amp.auto_cast(enable=amp, level="O1", dtype="bfloat16"):
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


# ------------------------------------------------------------ phase 12

# the CPU side of the special functions (Bessel, gamma and their
# gradients; the incomplete gamma's first-argument gradient sums 400 series
# terms) reads the first 64 rows of the first batch row: 65,536 elements
OPS_ROWS = (slice(0, 1), slice(0, 64))
OPS_ITERS = 10
# cases whose torch calls read back on the host although their outputs'
# shapes are fixed: torch.linalg's SVD, eigh, eig and the SVD-based norms,
# rank, condition number, pseudo-inverse and least squares check
# cuSOLVER's info on the host and have no check-free (_ex) form
LIBRARY_SYNCS = frozenset({"svd", "svd_grad", "svd_recon", "pinv",
                           "svd_norms", "eigh", "eigh_grad", "eigh_recon",
                           "eig", "lstsq"})


def cuda_median_ms(fn, iters: int = OPS_ITERS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``iters`` calls, each between
    its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _flat_out(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat_out(x)]
    return [out]


def _op_inputs(oc, case, cache):
    """The case's inputs at ``oc.FULL`` from ``np.random.RandomState``,
    each (spec, position) made once."""
    import zlib
    arrays = []
    for i, spec in enumerate(case.inputs):
        key = (spec, i)
        if key not in cache:
            seed = zlib.crc32(repr(key).encode()) % (2 ** 31)
            cache[key] = spec.make(np.random.RandomState(seed), oc.FULL)
        arrays.append(cache[key])
    return arrays


def _side_run(paddle, case, arrays, dtype, device, rs, mode):
    paddle.set_device(device)
    grads = case.grad if dtype == "float32" or case.low_grad else ()
    ts = [paddle.to_tensor(a, dtype=dtype if a.dtype == np.float32
                           and dtype != "float32" else None,
                           stop_gradient=i not in grads)
          for i, a in enumerate(arrays)]
    dev = ts[0]._t.device if ts else torch.device("cpu")
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(1000)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(mode)
    made_rs = []
    try:
        outs = _flat_out(case.fn(paddle, *ts))
        if grads:
            loss = None
            for o in outs:
                if o.dtype.name not in ("float32", "bfloat16", "float16",
                                        "float64") or o.stop_gradient:
                    continue
                r = rs[len(made_rs)] if rs is not None else \
                    torch.rand(o._t.shape, generator=gen,
                               device=o._t.device) * 2 - 1
                made_rs.append(r)
                term = (o._t.float() * r).sum()
                loss = term if loss is None else loss + term
            if loss is not None:
                loss.backward()
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
    g = [None if ts[i].grad is None else ts[i].grad._t for i in grads]
    return [o._t.detach() for o in outs], g, made_rs


def _side(paddle, case, arrays, dtype, device, rs=None, sync_ok=True):
    """Runs ``case`` on ``device``: (outputs, gradients, the r of each
    differentiated output, whether it synchronised with the host). On the
    card the run is under ``torch.cuda.set_sync_debug_mode('error')``
    unless the case may sync (a run that syncs is run again without it);
    the r are drawn there and handed to the CPU side."""
    if device != "cpu" and not sync_ok:
        try:
            return _side_run(paddle, case, arrays, dtype, device, rs,
                             "error") + (False,)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
        return _side_run(paddle, case, arrays, dtype, device, rs,
                         "default") + (True,)
    return _side_run(paddle, case, arrays, dtype, device, rs,
                     "default") + (False,)


def _op_compare(oc, what, got, want, family, terms, grad=False):
    """(worst error / limit, problem or None) of one output (both on the
    card, where the comparison is quick at full width)."""
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        return math.inf, (f"{what}: {tuple(got.shape)} {got.dtype} against "
                          f"{tuple(want.shape)} {want.dtype}")
    if not (got.is_floating_point() or got.is_complex()):
        return 0.0, None if torch.equal(got, want) else f"{what}: differs"
    if got.is_complex():
        g, w = torch.view_as_real(got).double(), torch.view_as_real(
            want).double()
    else:
        g, w = got.double(), want.double()
    nan = torch.isnan(w)
    if not torch.equal(torch.isnan(g), nan):
        return math.inf, f"{what}: NaN positions differ"
    inf = torch.isinf(w)
    if not torch.equal(g[inf], w[inf]):
        return math.inf, f"{what}: infinities differ"
    ok = ~(nan | inf)
    if not ok.any():
        return 0.0, None
    dt = {torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.float64: "float64"}.get(got.dtype, "float32")
    # one ulp of the larger of the two (they may straddle a binade)
    lim = oc.limit(family, dt, torch.maximum(g[ok].abs(), w[ok].abs()),
                   terms, grad)
    ratio = float(((g[ok] - w[ok]).abs() / lim.clamp(min=1e-300)).max())
    return ratio, None if ratio <= 1.0 else \
        f"{what}: {ratio:.3g} of its limit"


def _terms(case, arrays, out):
    """The values each output element sums (the CPU tests' rule)."""
    n_in = max((a.size for a in arrays), default=1)
    if case.scan:
        return n_in
    ratio = max(1, n_in // max(1, out.numel()))
    if case.family in ("matmul", "linalg") and arrays and arrays[0].ndim:
        return max(ratio, arrays[0].shape[-1])  # the contraction length
    return ratio


def _nbytes(x):
    return x.numel() * x.element_size()


def random_checks(paddle, shape):
    """The random ops on the card at full width, held by statistics of
    their draws (moments at five standard errors; Kolmogorov-Smirnov
    against the law on 200,000 of the draws, limit 0.01 where the 0.999
    quantile is 0.0044); the same seed gives the same draw."""
    from scipy import stats
    shape = list(shape)
    n = int(np.prod(shape))
    out = []

    def ks(x, cdf, what):
        s = x._t.flatten()[:200_000].double().cpu().numpy()
        d = stats.kstest(s, cdf).statistic
        out.append((what, d))
        check(d < 0.01, f"{what}: KS statistic {d:.4g}")
        check(x._t.is_cuda, f"{what} not on the card")

    def mean_near(x, mu, var, what):
        m = float(x._t.double().mean())
        out.append((what, m))
        check(abs(m - mu) < 5 * math.sqrt(var / x._t.numel()),
              f"{what}: mean {m} against {mu}")
        check(x._t.is_cuda, f"{what} not on the card")

    paddle.seed(5)
    ks(paddle.rand(shape), stats.uniform(0, 1).cdf, "rand")
    ks(paddle.uniform(shape, min=-2.0, max=3.0), stats.uniform(-2, 5).cdf,
       "uniform")
    ks(paddle.randn(shape), stats.norm().cdf, "randn")
    ks(paddle.normal(1.5, 2.0, shape), stats.norm(1.5, 2.0).cdf, "normal")
    ks(paddle.standard_gamma(paddle.full(shape, 2.5)), stats.gamma(2.5).cdf,
       "standard_gamma")
    ks(paddle.exponential_(paddle.zeros(shape), 2.0),
       stats.expon(scale=0.5).cdf, "exponential_")
    ri = paddle.randint(0, 10, shape)
    counts = torch.bincount(ri._t.flatten(), minlength=10).cpu().numpy()
    p = stats.chisquare(counts).pvalue
    out.append(("randint chi-square p", p))
    check(p > 1e-4, f"randint: chi-square p {p}")
    perm = paddle.randperm(n)
    check(torch.equal(torch.sort(perm._t).values,
                      torch.arange(n, device="cuda")), "randperm")
    mean_near(paddle.bernoulli(paddle.full(shape, 0.3)), 0.3, 0.21,
              "bernoulli")
    mean_near(paddle.poisson(paddle.full(shape, 4.0)), 4.0, 4.0, "poisson")
    mean_near(paddle.binomial(paddle.full(shape, 10.0),
                              paddle.full(shape, 0.25)), 2.5, 1.875,
              "binomial")
    d = paddle.dirichlet(paddle.full([n // 4, 4], 2.0))
    mean_near(d[:, 0], 0.25, 0.25 * 0.75 / 9, "dirichlet")
    mn = paddle.multinomial(paddle.to_tensor(np.array(
        [0.1, 0.2, 0.7], np.float32)), 100_000, replacement=True)
    freq = torch.bincount(mn._t, minlength=3).double() / 100_000
    check(float((freq - torch.tensor([0.1, 0.2, 0.7], device="cuda",
                                     dtype=torch.float64)).abs().max())
          < 0.01, f"multinomial frequencies {freq.tolist()}")
    x = paddle.ones(shape)
    f = paddle.fused_dropout_add(x, paddle.zeros(shape), p=0.25)
    mean_near((f != 0).astype("float32"), 0.75, 0.1875, "fused_dropout_add")
    dr = paddle.nn.functional.dropout(x, 0.4)
    mean_near((dr != 0).astype("float32"), 0.6, 0.24, "dropout")
    g = paddle.ops.parity.gumbel_softmax(paddle.zeros([n // 4, 4]))
    check(bool(((g.sum(-1) - 1).abs() < 1e-6).all()), "gumbel_softmax sums")
    rr = paddle.ops.parity.random_routing(
        paddle.ones([n // 2, 2]).astype("int64"), paddle.zeros([n // 2, 2]),
        paddle.full([n // 2, 2], 0.4))
    mean_near((rr != -1).astype("float32"), 0.4, 0.24, "random_routing")
    probs = paddle.to_tensor(np.tile(np.array(
        [[0.5, 0.3, 0.15, 0.05]], np.float32), (100_000, 1)))
    _, ids = paddle.top_p_sampling(probs, paddle.full([100_000], 0.7))
    check(bool((ids < 2).all()), "top_p_sampling left its nucleus")
    mean_near((ids == 0).astype("float32"), 0.625, 0.234, "top_p_sampling")
    for make in (lambda: paddle.rand([4096]), lambda: paddle.randn([4096]),
                 lambda: paddle.randint(0, 100, [4096])):
        paddle.seed(11)
        a = make()._t.clone()
        paddle.seed(11)
        b = make()._t
        check(torch.equal(a, b), "the same seed gave another draw")
    print("random ops on the card: " + ", ".join(
        f"{w} {v:.4g}" for w, v in out))


def op_surface_path(smi):
    """Phase 12: every case of ``paddle_tpu_torch/testing/op_cases.py``
    (every registered op of the op surface) at full width: the eager
    gpt2-medium's activation width at batch 4, [4, 1024, 1024], for the
    elementwise, reduction, cumulative, manipulation, search, sort and
    indexing ops, [4, 1024, 1024] @ [4, 1024, 1024] for the batched
    products, 1024 x 1024
    for the decompositions and solves. Each runs on the card in fp32 and,
    where the reference takes bf16, in bf16, forward and the gradient of
    sum(out * r), and on the port's CPU path on the same inputs; outputs
    and gradients are held to ``op_cases.limit`` (the CPU tests' limits,
    the reductions' growing with the reduced length). Every output must
    lie on the card, and under ``set_sync_debug_mode('error')`` only the
    data-dependent cases (and ``LIBRARY_SYNCS``) may synchronise. Each
    forward is timed (CUDA events, median of 10) beside its byte bound.
    The random ops are held by their statistics on the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.testing import op_cases as oc
    phase("12 the op surface at full width")
    t0 = time.perf_counter()
    cache, rows, misses, synced = {}, [], [], []
    n_runs = 0
    spent = {"inputs": 0.0, "card": 0.0, "cpu": 0.0, "compare": 0.0,
             "timing": 0.0}
    _reset_all_launches()
    for case in oc.CASES:
        tick = time.perf_counter()
        arrays = _op_inputs(oc, case, cache)
        spent["inputs"] += time.perf_counter() - tick
        for dtype in ["float32"] + (["bfloat16"] if case.low else []):
            label = f"{case.name} {dtype}"
            sync_ok = case.sync or case.name in LIBRARY_SYNCS
            tick = time.perf_counter()
            try:
                outs, grads, rs, did_sync = _side(
                    paddle, case, arrays, dtype, "gpu", sync_ok=sync_ok)
            except Exception as e:  # noqa: BLE001 (every miss is listed)
                misses.append(f"{label}: card run raised {e!r:.200}")
                continue
            if did_sync:
                synced.append(label)
                misses.append(f"{label}: synchronised with the host")
            for k, o in enumerate(outs):
                if not o.is_cuda:
                    misses.append(f"{label}: output {k} not on the card")
            spent["card"] += time.perf_counter() - tick
            tick = time.perf_counter()
            cpu_arrays = [a[OPS_ROWS] for a in arrays] if case.rows \
                else arrays
            cut = (lambda t: t[OPS_ROWS]) if case.rows else (lambda t: t)
            try:
                c_outs, c_grads, _, _ = _side(
                    paddle, case, cpu_arrays, dtype, "cpu",
                    rs=[cut(r).cpu() for r in rs])
            except Exception as e:  # noqa: BLE001
                misses.append(f"{label}: CPU run raised {e!r:.200}")
                continue
            spent["cpu"] += time.perf_counter() - tick
            tick = time.perf_counter()
            worst = 0.0
            for k, (g, w) in enumerate(zip(outs, c_outs)):
                ratio, bad = _op_compare(oc, f"{label} out {k}", cut(g),
                                         w.cuda(), case.family,
                                         _terms(case, cpu_arrays, w))
                worst = max(worst, ratio)
                if bad:
                    misses.append(bad)
            for i, g, w in zip(case.grad, grads, c_grads):
                if (g is None) != (w is None):
                    misses.append(f"{label} grad {i}: present on one side")
                elif g is not None:
                    ratio, bad = _op_compare(
                        oc, f"{label} grad {i}", cut(g), w.cuda(),
                        case.family, _terms(case, cpu_arrays, w), grad=True)
                    worst = max(worst, ratio)
                    if bad:
                        misses.append(bad)
            spent["compare"] += time.perf_counter() - tick
            tick = time.perf_counter()
            paddle.set_device("gpu")
            ts = [paddle.to_tensor(a, dtype=dtype if a.dtype == np.float32
                                   and dtype != "float32" else None)
                  for a in arrays]
            with torch.no_grad():
                ms = cuda_median_ms(lambda: case.fn(paddle, *ts))
            nbytes = sum(_nbytes(t._t) for t in ts) + sum(
                _nbytes(o) for o in outs)
            bound = nbytes / PEAK_BYTES * 1e3
            spent["timing"] += time.perf_counter() - tick
            rows.append((label, ms, bound, worst))
            print(f"op {label}: {ms:.4f} ms, byte bound {bound:.4f} ms "
                  f"({ms / bound:.1f}x), worst {worst:.3g} of its limit"
                  + (" (synchronised: data-dependent)" if sync_ok else ""),
                  flush=True)
            n_runs += 1
            del outs, grads, c_outs, c_grads, ts
        torch.cuda.empty_cache()
    top = sorted(rows, key=lambda r: r[1] / r[2], reverse=True)[:10]
    print("largest time/bound ratios: " + "; ".join(
        f"{lab} {ms:.4f}/{b:.4f} ms = {ms / b:.1f}x"
        for lab, ms, b, _ in top))
    for m in misses:
        print(f"miss: {m}")
    print("op surface wall time by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in spent.items()))
    # the kernel group calls the ops by their registered names: every
    # kernel of the port must have run under them
    by_name = _all_launches()
    print(f"port kernel launches of the op surface (its by-name calls): "
          f"{by_name}")
    if any(c.group == "kernel" for c in oc.CASES):
        check(all(by_name[k] for k in KERNELS), f"a kernel was not "
              f"launched by the op surface's by-name calls: {by_name}")
    random_checks(paddle, oc.FULL.x)
    dt = time.perf_counter() - t0
    print(f"op surface: {n_runs} runs of {len(oc.CASES)} cases, "
          f"{len(synced)} unexpected syncs, {len(misses)} misses, "
          f"{dt:.1f} s on {smi}", flush=True)
    check(not misses, f"{len(misses)} op-surface misses (listed above)")
    return dt


# ------------------------------------------------------------ phase 14

# Transformer-base (Vaswani et al. 2017, Table 3 "base"; Paddle's
# nn.Transformer defaults): the WMT14 en-de shared BPE vocabulary, 32
# pairs of 128 source and 128 target tokens (4096 target tokens)
TB_VOCAB, TB_BATCH, TB_SEQ, TB_LR = 37000, 32, 128, 5e-4
# Zaremba et al. 2014's large PTB LSTM (PaddlePaddle models' "large"
# language-model config)
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS, PTB_STEPS, PTB_BATCH = 10000, 1500, 2, \
    35, 20
PTB_DROPOUT, PTB_CLIP = 0.65, 5.0


def _hold_close(label, got, want, tol):
    """Each pair of arrays within ``tol`` of the larger of 1 and the
    wanted array's largest element; returns the worst ratio."""
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        check(g.shape == w.shape, f"{label} {k}: {g.shape} vs {w.shape}")
        err = float(np.abs(g - w).max()) if g.size else 0.0
        scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
        worst = max(worst, err / scale)
    print(f"{label}: worst |card - cpu| over the scale {worst:.3g} "
          f"(limit {tol:g})")
    check(worst <= tol, f"{label}: {worst} > {tol}")
    return worst


def _on(paddle, dev, fn):
    """``fn()`` with the eager API on ``dev``; the device restored."""
    paddle.set_device(dev)
    try:
        return fn()
    finally:
        paddle.set_device("gpu")


def _grads_of(model):
    return [p.grad.numpy() for p in model.parameters()]


def sinusoid(length, d):
    """The sinusoidal position table [length, d] of Vaswani et al."""
    pos = np.arange(length)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((length, d), np.float32)
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return out


def seq2seq(paddle, vocab, d, **kw):
    """A translation model on ``nn.Transformer(d, **kw)``: source and
    target embeddings scaled by sqrt(d) plus sinusoidal positions, dropout
    at the transformer's rate, an untied output projection."""
    nn = paddle.nn
    F = nn.functional

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(vocab, d)
            self.tgt_emb = nn.Embedding(vocab, d)
            self.transformer = nn.Transformer(d, **kw)
            self.proj = nn.Linear(d, vocab)
            self.register_buffer("pos", paddle.to_tensor(
                sinusoid(1024, d)), persistable=False)
            self.p = kw.get("dropout", 0.1)

        def embed(self, table, ids):
            x = table(ids) * math.sqrt(d) + self.pos[:ids.shape[1]]
            return F.dropout(x, self.p, training=self.training)

        def forward(self, src, tgt, tgt_mask):
            out = self.transformer(self.embed(self.src_emb, src),
                                   self.embed(self.tgt_emb, tgt),
                                   tgt_mask=tgt_mask)
            return self.proj(out)
    return Seq2Seq()


def _seq2seq_batch(paddle, vocab, batch, seq, seed):
    rng = np.random.RandomState(seed)
    src, tgt, lbl = (paddle.to_tensor(rng.randint(0, vocab, (batch, seq))
                                      .astype("int64")) for _ in range(3))
    return src, tgt, lbl, paddle.nn.Transformer \
        .generate_square_subsequent_mask(seq)


def small_transformer_check():
    """A small copy (2 + 2 layers, d_model 64, 4 heads, FFN 128, dropout
    0, fp32): one step's loss and every gradient on the card against the
    port's CPU path from the same weights and batch, within 1e-4 of each
    tensor's scale (fp32 summation order over 128-wide products)."""
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    runs = {}
    init = None
    for dev in ("cpu", "gpu"):
        def run():
            paddle.seed(0)
            model = seq2seq(paddle, 1000, 64, nhead=4, num_encoder_layers=2,
                            num_decoder_layers=2, dim_feedforward=128,
                            dropout=0.0)
            if init is not None:
                model.set_state_dict(init)
            src, tgt, lbl, mask = _seq2seq_batch(paddle, 1000, 4, 24, 1)
            loss = F.cross_entropy(model(src, tgt, mask), lbl,
                                   label_smoothing=0.1)
            loss.backward()
            state = {k: v.numpy() for k, v in model.state_dict().items()}
            return [loss.numpy()] + _grads_of(model), state
        runs[dev], state = _on(paddle, dev, run)
        init = init or state
    _hold_close("small transformer step (2+2 layers, d 64) loss and "
                "gradients", runs["gpu"], runs["cpu"], 1e-4)


def rnn_checks():
    """A bidirectional 2-layer GRU and SimpleRNN (hidden 64, batch 4, 12
    steps, with initial states): one step's output, final states, input
    and parameter gradients on the card against the CPU path, 1e-5 of
    each tensor's scale."""
    import paddle_tpu_torch as paddle
    rng = np.random.RandomState(2)
    x = rng.randn(4, 12, 32).astype(np.float32)
    h0 = rng.randn(4, 4, 64).astype(np.float32)
    r = rng.randn(4, 12, 128).astype(np.float32)
    for kind in ("GRU", "SimpleRNN"):
        runs, init = {}, None
        for dev in ("cpu", "gpu"):
            def run():
                paddle.seed(0)
                model = getattr(paddle.nn, kind)(32, 64, num_layers=2,
                                                 direction="bidirect")
                if init is not None:
                    model.set_state_dict(init)
                xs = paddle.to_tensor(x, stop_gradient=False)
                y, h = model(xs, paddle.to_tensor(h0))
                ((y * paddle.to_tensor(r)).sum() + h.sum()).backward()
                state = {k: v.numpy() for k, v in model.state_dict().items()}
                return [y.numpy(), h.numpy(), xs.grad.numpy()] + \
                    _grads_of(model), state
            runs[dev], state = _on(paddle, dev, run)
            init = init or state
        _hold_close(f"bidirectional 2-layer {kind} (hidden 64) step",
                    runs["gpu"], runs["cpu"], 1e-5)


def pylayer_check():
    """A ``PyLayer`` with a hand-written backward (the cube of a tanh) and
    a ``register_hook`` that halves a gradient, in one small SGD step on
    the card: its gradients equal the CPU path's (1e-5 of the scale), and
    the hook's halving shows against the same step unhooked."""
    import paddle_tpu_torch as paddle
    rng = np.random.RandomState(4)
    xs = rng.randn(16, 32).astype(np.float32)
    w1 = rng.randn(32, 24).astype(np.float32) * 0.2
    w2 = rng.randn(24, 8).astype(np.float32) * 0.2

    class Cube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, h):
            ctx.save_for_backward(h)
            return h * h * h

        @staticmethod
        def backward(ctx, g):
            (h,) = ctx.saved_tensor
            return g * 3.0 * h * h

    def step(hook):
        a = paddle.to_tensor(w1, stop_gradient=False)
        b = paddle.to_tensor(w2, stop_gradient=False)
        h = paddle.matmul(paddle.to_tensor(xs), a)
        if hook:
            h.register_hook(lambda g: g * 0.5)
        loss = paddle.matmul(Cube.apply(paddle.tanh(h)), b).sum()
        loss.backward()
        paddle.optimizer.SGD(0.1, parameters=[a, b]).step()
        return [loss.numpy(), a.grad.numpy(), b.grad.numpy(), a.numpy()]

    card = _on(paddle, "gpu", lambda: step(True))
    _hold_close("PyLayer + register_hook step", card,
                _on(paddle, "cpu", lambda: step(True)), 1e-5)
    plain = _on(paddle, "gpu", lambda: step(False))
    check(np.allclose(card[1], plain[1] * 0.5, rtol=1e-5, atol=1e-6),
          "the hook did not halve the first weight's gradient")


def _count_sdpa(counts):
    """Wraps the dense SDPA's body so that each call records its io type
    (``counts`` maps the type's name to calls); returns the undo."""
    from paddle_tpu_torch.nn.functional import attention
    body = attention._sdpa

    def counted(q, *args, **kw):
        name = str(q.dtype).replace("torch.", "")
        counts[name] = counts.get(name, 0) + 1
        return body(q, *args, **kw)
    attention._sdpa = counted
    return lambda: setattr(attention, "_sdpa", body)


def _linear_macs(paddle, model, *args) -> int:
    """Multiply-adds of one forward, from the shapes its ``Linear`` layers
    see (each output element takes its input width of them)."""
    total = [0]

    def hook(layer, inputs, out):
        total[0] += out.size * layer.weight.shape[0]

    handles = [m.register_forward_post_hook(hook)
               for m in model.sublayers(include_self=True)
               if isinstance(m, paddle.nn.Linear)]
    with paddle.no_grad():
        model(*args)
    for h in handles:
        h.remove()
    return total[0]


def _train_steps(label, step, n_tokens, flops_step, smi,
                 peak_flops=PEAK_BF16_FLOPS):
    """1 warm-up and ``TIMED_STEPS`` timed calls of ``step`` (each ending
    in a synchronize): losses, median ms, tokens/s, MFU and peak memory
    printed, then one profiled step. Returns the losses and the profile's
    result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        if i:
            step_ms.append(dt)
        print(f"{label} step {i}{' (warm-up)' if not i else ''}: loss "
              f"{losses[-1]:.5f} {dt:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms))
    mfu = flops_step / (med / 1e3) / peak_flops
    print(f"{label}: median {med:.2f} ms/step of {TIMED_STEPS} (steps "
          f"{[round(v, 2) for v in step_ms]}), {n_tokens / (med / 1e3):.1f} "
          f"tokens/s, MFU {mfu:.4f} of {peak_flops / 1e12:.0f} TFLOP/s, "
          f"peak memory "
          f"{peak / 2**30:.2f} GiB on {smi}")
    check(all(math.isfinite(v) for v in losses), f"{label} losses {losses}")
    check(peak < DEVICE_BYTES, f"{label} peak memory {peak}")
    prof = profile_step(lambda *_: step(), None, None, None, med)
    return losses, med, prof


def _tb_build(paddle):
    """Transformer-base of ``transformer_base`` on the card from seed 0:
    the model, its training step and its batch (src, tgt, mask)."""
    from torch.profiler import record_function
    F = paddle.nn.functional
    paddle.set_device("gpu")
    paddle.seed(0)
    model = seq2seq(paddle, TB_VOCAB, 512)
    opt = paddle.optimizer.AdamW(TB_LR, beta1=0.9, beta2=0.98,
                                 epsilon=1e-9,
                                 parameters=model.parameters())
    src, tgt, lbl, mask = _seq2seq_batch(paddle, TB_VOCAB, TB_BATCH, TB_SEQ,
                                         0)

    def step():
        with record_function("forward"):
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                logits = model(src, tgt, mask)
            loss = F.cross_entropy(logits, lbl, label_smoothing=0.1)
        loss.backward()
        with record_function("optimizer"):
            opt.step()
            opt.clear_grad()
        return loss
    return model, step, (src, tgt, mask)


def transformer_base(smi):
    """``nn.Transformer()`` at its defaults (d_model 512, 8 heads, 6 + 6
    layers, FFN 2048, dropout 0.1, relu, post-norm) in ``seq2seq``, vocab
    37000, batch 32 x 128 + 128 tokens, the causal target mask from
    ``generate_square_subsequent_mask``; fp32 parameters, bf16 O1,
    ``cross_entropy(label_smoothing=0.1)``, AdamW (0.9 / 0.98, eps 1e-9,
    fixed lr) on one fixed batch. Checks finite losses that fall, and that
    O1 ran every dense SDPA (18 a forward) in bf16."""
    import paddle_tpu_torch as paddle
    model, step, (src, tgt, mask) = _tb_build(paddle)
    n_params = sum(p.size for p in model.parameters())
    model.eval()
    macs = _linear_macs(paddle, model, src, tgt, mask)
    model.train()
    # 18 attentions a forward (6 encoder self, 6 decoder self, 6 cross),
    # each QK^T and PV over batch x seq x seq x d_model
    n_attn = model.transformer.encoder.num_layers \
        + 2 * model.transformer.decoder.num_layers
    attn_flops = n_attn * 2 * 2 * TB_BATCH * TB_SEQ * TB_SEQ * 512
    flops_step = 3 * (2 * macs + attn_flops)
    print(f"transformer-base ({n_params} parameters): forward "
          f"{2 * macs:.4e} FLOP in Linear layers + {attn_flops:.4e} in "
          f"attention; training {flops_step:.4e} FLOP a step (3 x "
          f"forward)")
    counts = {}
    undo = _count_sdpa(counts)
    try:
        step()
    finally:
        undo()
    print(f"transformer-base sdpa calls in one O1 step by io type: "
          f"{counts}")
    check(counts == {"bfloat16": n_attn}, f"O1 did not run the {n_attn} "
          f"SDPAs of a forward in bf16: {counts}")
    losses, med, prof = _train_steps(
        f"transformer-base b{TB_BATCH} s{TB_SEQ}+{TB_SEQ} bf16 O1 AdamW",
        step, TB_BATCH * TB_SEQ, flops_step, smi)
    check(losses[-1] < losses[0] and min(losses[1:]) < losses[0],
          f"transformer-base loss did not fall: {losses}")
    return med, prof


def ptb_lstm(smi):
    """Zaremba et al.'s large PTB LSTM: ``Embedding(10000, 1500)``, a
    2-layer ``nn.LSTM`` of 1500, dropout 0.65 on its input, between its
    layers and on its output, ``Linear(1500, 10000)``, mean
    ``cross_entropy``; fp32, ``SGD(1.0)`` with
    ``ClipGradByGlobalNorm(5.0)``, batch 20 x 35 steps on one fixed batch,
    the states carried from step to step (detached). The time loop is
    the reference's: 35 cell calls a layer, each a few kernels."""
    import paddle_tpu_torch as paddle
    model, step, (ids, state) = _ptb_build(paddle)
    n_params = sum(p.size for p in model.parameters())
    model.eval()
    macs = _linear_macs(paddle, model, ids, state[0])
    model.train()
    # the cells' products are matmuls, not Linear layers: 4H x (in + H)
    # a token and layer
    macs += PTB_BATCH * PTB_STEPS * PTB_LAYERS * 4 * PTB_HIDDEN * 2 \
        * PTB_HIDDEN
    flops_step = 3 * 2 * macs
    print(f"ptb large LSTM ({n_params} parameters): training "
          f"{flops_step:.4e} FLOP a step (3 x 2 x MACs)")
    losses, med, prof = _train_steps(
        f"ptb large LSTM b{PTB_BATCH} x {PTB_STEPS} fp32 SGD", step,
        PTB_BATCH * PTB_STEPS, flops_step, smi, PEAK_FP32_FLOPS)
    check(min(losses[1:]) < losses[0],
          f"ptb LSTM loss never fell below the first step's: {losses}")
    if prof is not None:
        print(f"ptb large LSTM: the host holds the card idle "
              f"{prof['idle']:.3f} of each step: "
              f"{PTB_LAYERS * PTB_STEPS} cell calls a forward, each a few "
              f"small kernels launched from Python")
    return med, prof


def _ptb_build(paddle):
    """The PTB LSTM of ``ptb_lstm`` on the card from seed 0: the model, its
    training step and (ids, the carried state's one-element list)."""
    from torch.profiler import record_function
    nn = paddle.nn
    F = nn.functional
    paddle.set_device("gpu")
    paddle.seed(0)

    class PTB(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(PTB_VOCAB, PTB_HIDDEN)
            self.lstm = nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS,
                                dropout=PTB_DROPOUT)
            self.fc = nn.Linear(PTB_HIDDEN, PTB_VOCAB)

        def forward(self, ids, states):
            x = F.dropout(self.emb(ids), PTB_DROPOUT, training=self.training)
            y, states = self.lstm(x, states)
            y = F.dropout(y, PTB_DROPOUT, training=self.training)
            return self.fc(y), states

    model = PTB()
    opt = paddle.optimizer.SGD(
        1.0, parameters=model.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(PTB_CLIP))
    rng = np.random.RandomState(0)
    ids = paddle.to_tensor(rng.randint(0, PTB_VOCAB, (
        PTB_BATCH, PTB_STEPS)).astype("int64"))
    lbl = paddle.to_tensor(rng.randint(0, PTB_VOCAB, (
        PTB_BATCH, PTB_STEPS)).astype("int64"))
    zeros = paddle.zeros([PTB_LAYERS, PTB_BATCH, PTB_HIDDEN])
    state = [(zeros, zeros)]

    def step():
        with record_function("forward"):
            logits, (h, c) = model(ids, state[0])
            loss = F.cross_entropy(logits, lbl)
        loss.backward()
        with record_function("optimizer"):
            opt.step()
            opt.clear_grad()
        state[0] = (h.detach(), c.detach())
        return loss
    return model, step, (ids, state)


def nn_layers_path(smi):
    """Phase 14: the ``nn`` surface of this slice on the card. The small
    checks first (a small Transformer step, a bidirectional GRU and
    SimpleRNN, a PyLayer with a hook, each against the port's CPU path),
    then Transformer-base and the large PTB LSTM trained eagerly. No TPU
    kernel is on this path: no port kernel may launch."""
    phase("14 nn layers")
    t0 = time.perf_counter()
    _reset_all_launches()
    small_transformer_check()
    rnn_checks()
    pylayer_check()
    torch.cuda.empty_cache()
    transformer_base(smi)
    torch.cuda.empty_cache()
    ptb_lstm(smi)
    launches = _all_launches()
    check(not any(launches.values()), f"a port kernel launched on the nn "
          f"path (it runs no TPU kernel): {launches}")
    dt = time.perf_counter() - t0
    print(f"nn layers: {dt:.1f} s on {smi}", flush=True)
    return dt


# ------------------------------------------------------------ phase 15

TOKEN_FILE_TOKENS = 1 << 24   # 64 MB of int32 tokens
ZIPF_A = 1.2                  # the token law, folded into the vocabulary
FED_DEPTH = 2                 # DevicePrefetcher depth on the token path
IMAGES, IMAGE_SIDE = 1024, 256  # the worker-fed ResNet's uint8 dataset
LOADER_WORKERS = min(8, os.cpu_count() or 1)
IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]
EXTRA_FAMILIES = ("alexnet", "squeezenet1_1", "densenet121",
                  "shufflenet_v2_x1_0", "googlenet")
EXTRA_BATCH, EXTRA_STEPS = 64, 3
# Momentum's rate by family: 0.1 (bench_suite.py's ResNet rate) where the
# family has batch norm; AlexNet, SqueezeNet and GoogLeNet have none and
# diverge to NaN within three steps at 0.1 (SqueezeNet on the card, the
# others in a CPU rehearsal at 64²), so SqueezeNet and GoogLeNet take
# 0.01 and AlexNet 0.001 (at 0.01 its loss still grew 16 -> 1e9 in three
# steps)
EXTRA_LR = {"alexnet": 0.001, "googlenet": 0.01, "squeezenet1_1": 0.01}
DETECTION_ITERS = 10


def _trace_copies(step):
    """One call of ``step`` under ``torch.profiler``, its trace read back:
    prints every memory copy the profiler recorded as (kind, bytes,
    stream): count and the operators around the first one (outermost
    first), and the kernels by stream. A record of what the profiler
    sees; the copies' stream is checked by ``_copy_stream_check``."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    cpu = [e for e in events if e.get("cat") == "cpu_op"]
    by_id = {(e.get("args") or {}).get("External id"): e for e in cpu}

    def around(op):  # the operators that enclose ``op``, outermost first
        if op is None:
            return "no operator recorded"
        t0, t1 = op["ts"], op["ts"] + op.get("dur", 0)
        outer = sorted((e for e in cpu if e.get("tid") == op.get("tid")
                        and e["ts"] <= t0 and e["ts"] + e.get("dur", 0) >= t1),
                       key=lambda e: (e["ts"], -e.get("dur", 0)))
        return " > ".join(e["name"] for e in outer[-4:])
    copies, kernels = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "gpu_memcpy":
            key = (e.get("name"), args.get("bytes"), args.get("stream"))
            if key not in copies:
                copies[key] = [0, around(by_id.get(args.get("External id")))]
            copies[key][0] += 1
        elif e.get("cat") == "kernel":
            s = args.get("stream")
            kernels[s] = kernels.get(s, 0) + 1
    print(f"traced copies (kind, bytes, stream): [count, operators]: "
          f"{dict(sorted(copies.items(), key=str))}; kernels by stream "
          f"{kernels}")


SPIN_CYCLES = 1 << 30  # a spin kernel of ~0.5 s: far longer than a placement


def _copy_stream_check(fed, it, placed):
    """Which stream the prefetcher ``fed``'s host-to-device copies run on,
    from CUDA events in the main path's own run. ``it`` iterates ``fed``;
    ``placed`` grows by (the host tokens, ``fed._put``'s result) each time
    ``fed`` places a batch. A spin kernel holds one stream while the
    consumer takes a batch, so that the staging thread places one more:
    with the prefetcher's stream held, that batch's tokens (read on a
    third stream) are not on the card before the spin ends, and are after
    it; with the consumer's stream held, its copies complete while the
    spin still runs. Returns whether both held."""
    reader = torch.cuda.Stream()

    def next_placed(n):
        t0 = time.monotonic()
        while len(placed) <= n:
            check(time.monotonic() - t0 < 30, "the prefetcher placed no "
                  "batch within 30 s")
            time.sleep(0.001)
        return placed[-1]

    def tokens_on_card(tree, host):
        with torch.cuda.stream(reader):
            seen = tree[0]._t.cpu()  # synchronises the reader stream alone
        return torch.equal(seen, torch.from_numpy(host))

    results = []
    for name, held in (("prefetcher", fed.stream),
                       ("consumer", torch.cuda.current_stream())):
        torch.cuda.synchronize()
        n = len(placed)
        with torch.cuda.stream(held):
            torch.cuda._sleep(SPIN_CYCLES)
        spun = torch.cuda.Event()
        spun.record(held)
        next(it)
        host, (tree, _, event) = next_placed(n)
        if name == "prefetcher":
            early = tokens_on_card(tree, host)
            spinning = not spun.query()
            event.synchronize()
            after = tokens_on_card(tree, host)
            results.append(spinning and not early and after)
            print(f"prefetcher's stream held by a spin: the next batch's "
                  f"tokens on the card before the spin ended: {early} (spin "
                  f"still running when read: {spinning}); after it: {after}")
        else:
            event.synchronize()
            spinning = not spun.query()
            results.append(spinning and tokens_on_card(tree, host))
            print(f"step's stream held by a spin: the next batch's copies "
                  f"complete while the spin still runs: {spinning}")
        torch.cuda.synchronize()
    return all(results)


def _write_tokens(path, vocab):
    """``TOKEN_FILE_TOKENS`` int32 tokens from seed 0: a Zipf law of
    exponent ``ZIPF_A`` folded into the vocabulary (frequent tokens that a
    model can learn, so the loss falls)."""
    rng = np.random.default_rng(0)
    toks = ((rng.zipf(ZIPF_A, TOKEN_FILE_TOKENS) - 1) % vocab)
    toks.astype(np.int32).tofile(path)


def token_fed_gpt(smi, compiled_ms):
    """(a) Phase 5's compiled gpt2-medium trainer (b8 s1024, bf16, fp32
    master, remat, AdamW) fed by ``io.NativeTokenLoader`` through
    ``io.DevicePrefetcher(depth=2)`` from a 2^24-token file. The first
    batch on the card must equal the same loader's CPU read bit for bit;
    every step launches 48/24/24 kernels #1/#2/#3; the losses are finite
    and fall. Prints ms/step beside phase 5's fixed-batch median, the host
    ms waiting on the loader a step, one profiled step's idle share, and
    which stream carried the batch's host-to-device copies."""
    import tempfile
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.bin")
        tick = time.perf_counter()
        _write_tokens(path, cfg.vocab_size)
        print(f"token file: {TOKEN_FILE_TOKENS} int32 tokens "
              f"({os.path.getsize(path) / 2**20:.0f} MiB), Zipf a={ZIPF_A} "
              f"over {cfg.vocab_size}, written in "
              f"{time.perf_counter() - tick:.1f} s")
        cpu_tokens, cpu_labels = io.NativeTokenLoader(path, SEQ, BATCH,
                                                      seed=0).next()
        loader = io.NativeTokenLoader(path, SEQ, BATCH, seed=0)
        print(f"NativeTokenLoader: {loader.num_windows} windows of "
              f"{SEQ + 1}, batch {BATCH}")
        fed = io.DevicePrefetcher(loader, depth=FED_DEPTH)
        placed, put = [], fed._put

        def put_and_keep(batch):  # for _copy_stream_check
            staged = put(batch)
            placed.append((np.array(batch[0]), staged))
            return staged
        fed._put = put_and_keep
        it = iter(fed)
        init_fn, step = gpt.build_train_step(cfg, lr=1e-4, remat=True,
                                             device="cuda")
        state = init_fn(0)
        first = next(it)
        check(first[0]._t.is_cuda and first[0]._t.dtype == torch.int32,
              f"fed batch {first[0]._t.device} {first[0]._t.dtype}")
        same = torch.equal(first[0]._t.cpu(), torch.from_numpy(cpu_tokens)) \
            and torch.equal(first[1]._t.cpu(), torch.from_numpy(cpu_labels))
        print(f"first fed batch on the card bit-equal to the CPU read: "
              f"{same}")
        check(same, "the first fed token batch differs from the CPU read")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, step_ms, wait_ms = [], [], []
        batch = first
        for i in range(1 + TIMED_STEPS):
            t0 = time.perf_counter()
            if i:
                tw = time.perf_counter()
                batch = next(it)
                wait_ms.append((time.perf_counter() - tw) * 1e3)
            state, loss = step(state, batch[0]._t, batch[1]._t)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            losses.append(loss.item())
            if i:
                step_ms.append(dt)
            print(f"fed step {i}{' (warm-up)' if not i else ''}: loss "
                  f"{losses[-1]:.5f} {dt:.1f} ms")
        launches = dict(fa.LAUNCHES)
        n_steps = 1 + TIMED_STEPS
        for name, n in (("flash_fwd", 2 * cfg.num_layers),
                        ("flash_bwd_dkv", cfg.num_layers),
                        ("flash_bwd_dq", cfg.num_layers)):
            check(launches[name] == n * n_steps,
                  f"fed path: {name} launched {launches[name]}, want "
                  f"{n * n_steps}")
        print(f"fed path launches over {n_steps} steps: {launches}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(losses[-1] < losses[0], f"fed loss did not fall: {losses}")
        med = float(np.median(step_ms))

        def fixed_step():
            nonlocal state
            state, _ = step(state, first[0]._t, first[1]._t)
        again = _fixed_median(fixed_step)
        print(f"token-fed gpt2-medium b{BATCH} s{SEQ}: median {med:.2f} "
              f"ms/step ({BATCH * SEQ / (med / 1e3):.1f} tokens/s) against "
              f"phase 5's fixed batch {compiled_ms:.2f} ms "
              f"({med / compiled_ms:.3f}x) and the same trainer's fixed "
              f"batch right after {again:.2f} ms ({med / again:.3f}x); host "
              f"wait on the loader "
              f"{float(np.median(wait_ms)):.3f} ms a step (median; max "
              f"{max(wait_ms):.3f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")

        def fed_step(*_):
            nonlocal state
            tokens, labels = next(it)
            state, _ = step(state, tokens._t, labels._t)
        prof = profile_step(fed_step, None, None, None, med)
        check(prof is not None, "the profiler saw no device time")
        feed = io.NativeTokenLoader(path, SEQ, BATCH, seed=0)
        feed_ms = []
        for _ in range(20):
            tw = time.perf_counter()
            feed.next()
            feed_ms.append((time.perf_counter() - tw) * 1e3)
        feed.close()
        print(f"of the wait, the token feed's next() alone: "
              f"{float(np.median(feed_ms)):.3f} ms (median of 20)")
        _trace_copies(fed_step)
        on_side = _copy_stream_check(fed, it, placed)
        print(f"the batch's host-to-device copies ran on the prefetcher's "
              f"stream: {on_side} (CUDA events in this run: they queue "
              f"behind that stream, not behind the step's)")
        check(on_side, "the fed batch's copies did not run on the "
              "prefetcher's stream alone")
        it.close()
        loader.close()
    return med


def _fixed_median(step):
    """Median ms of ``TIMED_STEPS`` calls of ``step`` on the host clock,
    each ending in a synchronize: the same model on one batch, timed in
    turn with the fed steps."""
    ms = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def _images_dataset(paddle, transform):
    """``IMAGES`` uint8 ``IMAGE_SIDE``^2 x 3 images and labels from seed 0,
    each sample ``(transform(image), label)``."""
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (IMAGES, IMAGE_SIDE, IMAGE_SIDE, 3),
                       dtype=np.uint8)
    labels = rng.randint(0, 1000, (IMAGES,)).astype(np.int64)

    class Images(paddle.io.Dataset):
        def __len__(self):
            return IMAGES

        def __getitem__(self, i):
            return transform(imgs[i]), int(labels[i])
    return Images()


def _loader_rate(loader, batches):
    """Batches/s of ``loader`` alone (each batch placed on the card, no
    step): one batch to start, then ``batches`` timed."""
    batches = min(batches, len(loader) - 1)
    it = iter(loader)
    next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    torch.cuda.synchronize()
    rate = batches / (time.perf_counter() - t0)
    it.close()
    return rate


def worker_fed_resnet(smi, fixed_ms):
    """(b) Phase 11's ResNet-50 step (b64 224², O1 bf16, Momentum 0.1) fed
    by ``DataLoader(num_workers=W, shuffle=True, drop_last=True)`` and
    ``DevicePrefetcher`` over a seeded uint8 dataset with
    ``RandomResizedCrop(224)``, ``RandomHorizontalFlip``, ``ToTensor`` and
    ``Normalize``: first a deterministic pipeline's batches on the card
    bit-equal with W workers and with 0, then 1 + 5 steps (images/s beside
    phase 11's fixed batch, idle share), then the loader alone with W
    workers and with 0 (batches/s)."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import io
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import resnet50
    paddle.set_device("gpu")
    norm = T.Normalize(IMAGENET_MEAN, IMAGENET_STD, data_format="CHW")
    fixed = _images_dataset(paddle, T.Compose([
        T.CenterCrop(RESNET_SIZE), T.ToTensor(), norm]))
    runs = {}
    for w in (LOADER_WORKERS, 0):
        it = iter(io.DataLoader(fixed, batch_size=RESNET_BATCH,
                                num_workers=w, timeout=120))
        runs[w] = [next(it) for _ in range(3)]
        it.close()
    pairs = [(a[k]._t, b[k]._t) for a, b in zip(runs[LOADER_WORKERS],
                                                 runs[0]) for k in (0, 1)]
    equal = all(torch.equal(a, b) for a, b in pairs)
    print(f"deterministic pipeline (CenterCrop + Normalize, no shuffle): "
          f"3 batches on the card bit-equal with {LOADER_WORKERS} workers "
          f"and with 0: {equal}")
    check(equal, "worker batches differ from the single-process ones")
    check(all(a.is_cuda and b.is_cuda for a, b in pairs),
          "a loader batch is not on the card")
    del runs
    ds = _images_dataset(paddle, T.Compose([
        T.RandomResizedCrop(RESNET_SIZE), T.RandomHorizontalFlip(),
        T.ToTensor(), norm]))
    loader = io.DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True,
                           drop_last=True, num_workers=LOADER_WORKERS,
                           timeout=120)
    paddle.seed(0)
    model = resnet50()
    opt = paddle.optimizer.Momentum(0.1, parameters=model.parameters())
    it = iter(io.DevicePrefetcher(loader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, wait_ms = [], [], []
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        x, y = next(it)
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        loss = _resnet_step(paddle, F, model, opt, x, y)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        if i:
            step_ms.append(dt)
        print(f"worker-fed resnet step {i}{' (warm-up)' if not i else ''}: "
              f"loss {losses[-1]:.5f} {dt:.1f} ms (waited "
              f"{wait_ms[-1]:.1f} ms)")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    med = float(np.median(step_ms))
    again = _fixed_median(lambda: _resnet_step(paddle, F, model, opt, x, y))
    print(f"worker-fed resnet50 b{RESNET_BATCH} {RESNET_SIZE}^2 bf16 O1 "
          f"({LOADER_WORKERS} workers): median {med:.2f} ms/step, "
          f"{RESNET_BATCH / (med / 1e3):.1f} images/s against phase 11's "
          f"fixed batch {fixed_ms:.2f} ms "
          f"({RESNET_BATCH / (fixed_ms / 1e3):.1f} images/s) and the same "
          f"model's fixed batch right after, the workers still filling their "
          f"in-flight batches, {again:.2f} ms "
          f"({RESNET_BATCH / (again / 1e3):.1f} images/s); host wait on "
          f"the loader {float(np.median(wait_ms[1:])):.1f} ms a step "
          f"(median), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")

    def fed_step(*_):
        bx, by = next(it)
        _resnet_step(paddle, F, model, opt, bx, by)
    profile_step(fed_step, None, None, None, med, group=_vision_group)
    it.close()
    del model, opt
    torch.cuda.empty_cache()
    rates = {w: _loader_rate(io.DataLoader(
        ds, batch_size=RESNET_BATCH, shuffle=True, drop_last=True,
        num_workers=w, timeout=120), 8 if w else 2)
        for w in (LOADER_WORKERS, 0)}
    print(f"loader alone (augment, collate, to the card): "
          f"{rates[LOADER_WORKERS]:.2f} batches/s with {LOADER_WORKERS} "
          f"workers ({rates[LOADER_WORKERS] * RESNET_BATCH:.1f} images/s), "
          f"{rates[0]:.2f} with 0 ({rates[0] * RESNET_BATCH:.1f} images/s), "
          f"host cores {os.cpu_count()}")
    return med


def _state_err(got, want):
    worst = 0.0
    for k in want:
        w = want[k].astype(np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        worst = max(worst, float(np.abs(got[k].astype(np.float64) - w)
                                 .max()) / scale)
    return worst


def _update_err(init, got, want):
    """The worst difference of two steps' updates (state after minus
    ``init``), each tensor's over its own largest update (at least 1e-3
    of the largest update of all)."""
    ups = {k: (got[k].astype(np.float64) - init[k],
               want[k].astype(np.float64) - init[k]) for k in want}
    top = max(float(np.abs(w).max()) for _, w in ups.values())
    worst = 0.0
    for g, w in ups.values():
        scale = max(float(np.abs(w).max()), 1e-3 * top, 1e-30)
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def extra_families(smi):
    """(c) Each of the five extra families: one Momentum step on the card
    against the port's CPU path (batch 2, 224², eval mode: dropout off and
    batch norm on its running statistics, so both devices compute one
    function), in float64 (each tensor's update to 1e-9 of its scale,
    ``_update_err``) and in fp32 (the parameters to 1e-4 of their scale
    and the loss, as phase 11's resnet18); then batch 64 x
    224², O1 bf16, ``Momentum`` (``EXTRA_LR``), 1 warm-up and 3 timed
    steps, the losses finite."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision import models as M
    rng = np.random.RandomState(5)
    x2 = rng.randn(2, 3, RESNET_SIZE, RESNET_SIZE).astype(np.float32)
    y2 = rng.randint(0, 1000, (2,)).astype(np.int64)
    xb = paddle.to_tensor(rng.randn(EXTRA_BATCH, 3, RESNET_SIZE, RESNET_SIZE)
                          .astype(np.float32), place="gpu")
    yb = paddle.to_tensor(rng.randint(0, 1000, (EXTRA_BATCH,))
                          .astype(np.int64), place="gpu")
    out = {}
    for name in EXTRA_FAMILIES:
        paddle.set_device("cpu")
        paddle.seed(0)
        init = {k: v.numpy() for k, v in getattr(M, name)()
                .state_dict().items()}
        lr = EXTRA_LR.get(name, 0.1)
        for dtype in ("float64", "float32"):
            runs = {}
            for dev in ("gpu", "cpu"):
                paddle.set_device(dev)
                model = getattr(M, name)()
                model.set_state_dict(init)
                model.astype(dtype)
                model.eval()
                opt = paddle.optimizer.Momentum(
                    lr, parameters=model.parameters())
                loss = F.cross_entropy(
                    model(paddle.to_tensor(x2.astype(dtype), dtype=dtype)),
                    paddle.to_tensor(y2))
                loss.backward()
                opt.step()
                runs[dev] = (float(loss), {k: v.numpy() for k, v in
                                           model.state_dict().items()})
            upd = _update_err(init, runs["gpu"][1], runs["cpu"][1])
            par = _state_err(runs["gpu"][1], runs["cpu"][1])
            loss_err = abs(runs["gpu"][0] - runs["cpu"][0]) / max(
                1.0, abs(runs["cpu"][0]))
            # float64: the updates themselves; fp32: the parameters over
            # their scale and the loss, as phase 11's resnet18 (a tensor
            # whose gradient sums terms that nearly cancel differs by up
            # to 0.5% of its own update in fp32, 1e-14 in float64)
            err, lim = (upd, 1e-9) if dtype == "float64" else (par, 1e-4)
            print(f"{name} {dtype} step (Momentum {lr}), card against CPU: "
                  f"updates {upd:.3g} of their scale, parameters {par:.3g} "
                  f"of theirs, loss {loss_err:.3g} (limit {lim:g} on the "
                  f"{'updates' if dtype == 'float64' else 'parameters'} "
                  f"and the loss)")
            check(err <= lim and loss_err <= lim,
                  f"{name} {dtype} card step: {err}, {loss_err}")
        paddle.set_device("gpu")
        paddle.seed(0)
        model = getattr(M, name)()
        opt = paddle.optimizer.Momentum(lr, parameters=model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(1 + EXTRA_STEPS):
            t0 = time.perf_counter()
            loss = _resnet_step(paddle, F, model, opt, xb, yb)
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        check(all(math.isfinite(v) for v in losses), f"{name} {losses}")
        med = float(np.median(ms))
        n_params = sum(p.size for p in model.parameters())
        print(f"{name} ({n_params} parameters) b{EXTRA_BATCH} "
              f"{RESNET_SIZE}^2 bf16 O1 momentum {lr}: median {med:.2f} "
              f"ms/step "
              f"of {EXTRA_STEPS} ({[round(v, 2) for v in ms]}), "
              f"{EXTRA_BATCH / (med / 1e3):.1f} images/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, losses "
              f"{[round(v, 4) for v in losses]} on {smi}")
        out[name] = med
        del model, opt
        torch.cuda.empty_cache()
    return out


def _boxes(rng, n, width, height, least=8.0):
    """``n`` boxes inside a ``width`` x ``height`` image: a corner in the
    first 60%, sides from ``least`` to 35% of the image."""
    corner = rng.uniform(0, 0.6, (n, 2)) * [width, height]
    most = np.array([0.35 * width, 0.35 * height])
    side = least + rng.uniform(0, 1, (n, 2)) * (most - least)
    return np.concatenate([corner, corner + side], 1).astype(np.float32)


def _detection_hold(label, run, args, grad_of=None, terms=None,
                    floor=None, dtype="float32", timed=True):
    """``run(*tensors)`` on the card and on the port's CPU path (float
    inputs in ``dtype``), the outputs (and the gradient of sum(out * r)
    wrt input ``grad_of``) held to ``op_cases.limit`` (fp32 1e-5 of each
    element and of the output's largest, float64 1e-11, growing past 1024
    terms with the square root of ``terms[k]``, the values output k sums)
    plus ``floor[k]`` (an absolute error the inputs' own rounding allows);
    integer outputs equal. Then the card's time by CUDA events."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.testing import op_cases as oc

    def cast(a):
        return a.astype(dtype) if a.dtype.kind == "f" else a
    results = {}
    for dev in ("gpu", "cpu"):
        ts = [paddle.to_tensor(cast(a), dtype=str(cast(a).dtype),
                               place=dev, stop_gradient=(k != grad_of))
              if isinstance(a, np.ndarray) else a
              for k, a in enumerate(args)]
        outs = run(*ts)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        grads = []
        if grad_of is not None:
            r = paddle.to_tensor(np.random.RandomState(1).uniform(
                -1, 1, outs[0].shape).astype(dtype), dtype=dtype, place=dev)
            (outs[0] * r).sum().backward()
            grads = [ts[grad_of].grad]
        results[dev] = [t._t.detach().double().cpu() for t in outs + grads]
    worst = 0.0
    for k, (g, c) in enumerate(zip(results["gpu"], results["cpu"])):
        check(g.shape == c.shape, f"{label}: shapes {g.shape} {c.shape}")
        if not g.is_floating_point():
            check(torch.equal(g, c), f"{label}: output {k} differs")
            continue
        if c.numel() == 0:
            continue
        lim = oc.limit("elementwise", dtype, c.abs(),
                       (terms or {}).get(k, 1)) + (floor or {}).get(k, 0.0)
        worst = max(worst, float(((g - c).abs() / lim.clamp(min=1e-300))
                                 .max()))
    check(worst <= 1.0, f"{label} {dtype}: {worst} of the limit")
    if not timed:
        print(f"{label} {dtype}: worst |card - cpu| {worst:.3g} of the "
              f"limit")
        return
    ts = [paddle.to_tensor(a, place="gpu") if isinstance(a, np.ndarray)
          else a for a in args]
    fwd = cuda_ms(lambda: run(*ts), DETECTION_ITERS)
    line = f"{label}: card {fwd:.4f} ms forward"
    if grad_of is not None:
        tg = list(ts)

        def fwd_bwd():
            tg[grad_of] = paddle.to_tensor(args[grad_of], place="gpu",
                                           stop_gradient=False)
            o = run(*tg)
            o = o[0] if isinstance(o, (list, tuple)) else o
            o.sum().backward()
        line += f", {cuda_ms(fwd_bwd, DETECTION_ITERS):.4f} ms fwd+bwd"
    print(f"{line}; worst |card - cpu| {worst:.3g} of the limit")


def _roi_align_terms(x, boxes, num, *attrs):
    """The most samples (of all RoIs, each bilinear corner one) that land
    on one pixel: the terms ``roi_align``'s gradient sums there."""
    from paddle_tpu_torch.vision.ops import _roi_samples
    corners, _, _ = _roi_samples(torch.from_numpy(boxes),
                                 torch.from_numpy(num), x.shape, *attrs)
    return int(torch.bincount(torch.cat([c.reshape(-1) for c in corners]))
               .max())


def detection_ops(smi):
    """(d) ``vision.ops`` at detection shapes, each held against the port's
    CPU path and timed: ``roi_align`` at Mask R-CNN R50-FPN's box head
    (P2 [2, 256, 200, 336], 512 RoIs an image, 7 x 7, scale 0.25,
    sampling 2, aligned; forward and the gradient for x), ``roi_pool`` at
    Fast R-CNN VGG16's conv5 ([2, 512, 38, 50], 128 RoIs an image, 7 x 7,
    scale 1/16), ``nms`` over 2000 RPN proposals at IoU 0.7 with and
    without categories (indices exact), ``yolo_box`` over YOLOv3's three
    heads at 608² (batch 8, 80 classes), ``prior_box`` and ``box_coder``
    at SSD300's 38 x 38 map."""
    from paddle_tpu_torch.vision import ops as V
    rng = np.random.RandomState(7)
    feat = rng.randn(2, 256, 200, 336).astype(np.float32)
    boxes = _boxes(rng, 1024, 1344, 800)
    num = np.array([512, 512], np.int32)
    terms = _roi_align_terms(feat, boxes, num, 7, 7, 0.25, 2, True)
    # fp32 sample coordinates carry one unit of their last place (3.05e-5
    # at 336 feature pixels); moving wy or wx by it moves an interpolated
    # value by up to 2 max|x| each, and a pixel's gradient by 1/4 of it
    # for each of its samples (|r| <= 1, 4 samples a bin): the two devices
    # round them differently, and float64 shows the formulas agree
    ulp = float(np.spacing(np.float32(boxes.max() * 0.25)))
    floor = {0: 4 * float(np.abs(feat).max()) * ulp, 1: terms * ulp / 2}
    print(f"roi_align: at most {terms} samples land on one pixel; "
          f"coordinate ulp {ulp:.3g}, allowed |card - cpu| from it "
          f"{floor[0]:.3g} (out), {floor[1]:.3g} (grad)")
    roi = (lambda x, b, n: V.roi_align(x, b, n, 7, 0.25, 2, True))
    _detection_hold("roi_align [2, 256, 200, 336], 1024 RoIs", roi,
                    [feat, boxes, num], grad_of=0, dtype="float64",
                    timed=False)
    _detection_hold("roi_align [2, 256, 200, 336], 1024 RoIs", roi,
                    [feat, boxes, num], grad_of=0,
                    terms={0: 16, 1: terms}, floor=floor)
    conv5 = rng.randn(2, 512, 38, 50).astype(np.float32)
    _detection_hold("roi_pool [2, 512, 38, 50], 256 RoIs",
                    lambda x, b, n: V.roi_pool(x, b, n, 7, 1 / 16),
                    [conv5, _boxes(rng, 256, 800, 600),
                     np.array([128, 128], np.int32)], grad_of=0)
    props = _boxes(rng, 2000, 1344, 800)
    scores = rng.uniform(0, 1, 2000).astype(np.float32)
    cats = rng.randint(0, 80, 2000).astype(np.int64)
    _detection_hold("nms 2000 proposals, IoU 0.7",
                    lambda b, s: V.nms(b, s, 0.7), [props, scores])
    _detection_hold("nms 2000 proposals, IoU 0.7, 80 categories",
                    lambda b, s, c: V.nms(b, s, 0.7, category_idxs=c,
                                          categories=list(range(80))),
                    [props, scores, cats])
    anchors = ([116, 90, 156, 198, 373, 326], [30, 61, 62, 45, 59, 119],
               [10, 13, 16, 30, 33, 23])
    size = np.full((8, 2), 608, np.int32)
    for side, anc, ratio in zip((19, 38, 76), anchors, (32, 16, 8)):
        head = rng.randn(8, 255, side, side).astype(np.float32)
        _detection_hold(f"yolo_box [8, 255, {side}, {side}]",
                        lambda x, s, a=anc, d=ratio: V.yolo_box(
                            x, s, a, 80, 0.005, d), [head, size])
    fmap = rng.randn(8, 512, 38, 38).astype(np.float32)
    image = rng.randn(8, 3, 300, 300).astype(np.float32)
    _detection_hold("prior_box 38 x 38 (SSD300 conv4_3)",
                    lambda f, i: V.prior_box(f, i, [30.0], [60.0],
                                             aspect_ratios=(2.0,),
                                             flip=True, clip=True),
                    [fmap, image])
    priors = _boxes(rng, 5776, 1, 1, least=0.01)
    _detection_hold("box_coder encode 5776 priors",
                    lambda p, v, t: V.box_coder(p, v, t,
                                                "encode_center_size"),
                    [priors, np.full((5776, 4), 0.1, np.float32),
                     _boxes(rng, 5776, 1, 1, least=0.01)])
    _detection_hold("box_coder decode 5776 priors",
                    lambda p, v, t: V.box_coder(p, v, t,
                                                "decode_center_size"),
                    [priors, np.full((5776, 4), 0.1, np.float32),
                     rng.randn(5776, 4).astype(np.float32)])


# (name, make(paddle, params), bytes a parameter of one fp32 step: each
# input read once and each output written once)
OPTIMIZERS = (
    ("Adagrad", lambda P, ps: P.optimizer.Adagrad(0.01, parameters=ps), 20),
    ("RMSProp", lambda P, ps: P.optimizer.RMSProp(0.01, parameters=ps), 28),
    ("RMSProp centered momentum", lambda P, ps: P.optimizer.RMSProp(
        0.01, momentum=0.9, centered=True, parameters=ps), 36),
    ("Adadelta", lambda P, ps: P.optimizer.Adadelta(1.0, parameters=ps), 28),
    ("Adamax", lambda P, ps: P.optimizer.Adamax(0.01, parameters=ps), 28),
    ("Lamb", lambda P, ps: P.optimizer.Lamb(0.01, parameters=ps), 28),
    ("Adam amsgrad", lambda P, ps: P.optimizer.Adam(
        1e-3, parameters=ps, amsgrad=True), 36),
    ("AdamW lr_ratio", lambda P, ps: P.optimizer.AdamW(
        1e-3, parameters=ps, lr_ratio=lambda q: 0.5 if len(q.shape) == 1
        else 1.0), 28),
)


def optimizer_steps(smi):
    """(e) Three steps of each new optimizer on a small MLP on the card
    against the port's CPU path (held to 1e-5 of the scale), ``LBFGS`` on a
    least-squares problem; then one step of each ``_foreach`` optimizer
    over gpt2-medium's 354.9 M fp32 parameters with random gradients,
    timed beside its byte bound, and one more under
    ``torch.cuda.set_sync_debug_mode("error")``: no step may
    synchronise."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    rng = np.random.RandomState(11)
    xs = [rng.randn(6, 8).astype(np.float32) for _ in range(3)]

    def mlp():
        return paddle.nn.Sequential(paddle.nn.Linear(8, 16),
                                    paddle.nn.LayerNorm(16),
                                    paddle.nn.Linear(16, 4))
    paddle.set_device("cpu")
    paddle.seed(0)
    init = {k: v.numpy() for k, v in mlp().state_dict().items()}
    for name, make, _ in OPTIMIZERS:
        states = {}
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            m = mlp()
            m.set_state_dict(init)
            opt = make(paddle, m.parameters())
            for x in xs:
                out = m(paddle.to_tensor(x))
                (paddle.mean(out * out) + paddle.mean(out)).backward()
                opt.step()
                opt.clear_grad()
            states[dev] = {k: v.numpy() for k, v in m.state_dict().items()}
        err = _state_err(states["gpu"], states["cpu"])
        print(f"{name}: 3 steps, card against CPU {err:.3g} of the scale "
              f"(limit 1e-5)")
        check(err <= 1e-5, f"{name} card steps: {err}")
    a = rng.randn(64, 16).astype(np.float32)
    b = rng.randn(64, 1).astype(np.float32)
    sols = {}
    for dev in ("gpu", "cpu"):
        paddle.set_device(dev)
        paddle.seed(0)
        layer = paddle.nn.Linear(16, 1, bias_attr=False)
        layer.weight.set_value(np.zeros((16, 1), np.float32))
        opt = paddle.optimizer.LBFGS(parameters=layer.parameters(),
                                     history_size=10)
        ta, tb = paddle.to_tensor(a), paddle.to_tensor(b)

        def closure():
            opt.clear_grad()
            loss = paddle.mean((layer(ta) - tb) ** 2)
            loss.backward()
            return loss
        opt.step(closure)
        sols[dev] = layer.weight.numpy()
    best = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                           rcond=None)[0]
    err = float(np.abs(sols["gpu"] - sols["cpu"]).max())
    err_best = float(np.abs(sols["gpu"] - best).max())
    print(f"LBFGS least squares 64 x 16: card against CPU {err:.3g}, "
          f"against lstsq {err_best:.3g} (limits 1e-5, 1e-3)")
    check(err <= 1e-5 and err_best <= 1e-3, f"LBFGS {err} {err_best}")

    paddle.set_device("gpu")
    paddle.seed(0)
    model = gpt.GPTForPretraining(gpt.GPT_CONFIGS["gpt2-medium"])
    params = model.parameters()
    n = sum(p.size for p in params)
    dev = params[0]._t.device
    gen = torch.Generator(device=dev).manual_seed(0)
    for p in params:
        p._t.grad = torch.randn(p._t.shape, device=dev, generator=gen) * 1e-3
    for name, make, per_param in OPTIMIZERS:
        opt = make(paddle, params)
        ms = cuda_ms(opt.step, 3, warmup=1)
        bound = n * per_param / PEAK_BYTES * 1e3
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"{name} step over {n} fp32 parameters: {ms:.3f} ms, byte "
              f"bound {bound:.3f} ms ({per_param} B a parameter), "
              f"{bound / ms:.1%} of it; no sync under sync-debug 'error' "
              f"on {smi}")
        del opt
        torch.cuda.empty_cache()
    del model, params
    torch.cuda.empty_cache()


def input_pipeline_path(smi, compiled_ms, resnet_ms):
    """Phase 15: the input pipeline that feeds the card, the vision
    leftovers and the remaining optimizers (a)-(e). Only (a) runs TPU
    kernels (#1-#3, checked there); no port kernel may launch on (b)-(e).
    """
    phase("15 input pipeline, vision extras, detection ops, optimizers")
    t0 = time.perf_counter()
    token_fed_gpt(smi, compiled_ms)
    torch.cuda.empty_cache()
    _reset_all_launches()
    worker_fed_resnet(smi, resnet_ms)
    torch.cuda.empty_cache()
    extra_families(smi)
    detection_ops(smi)
    torch.cuda.empty_cache()
    optimizer_steps(smi)
    launches = _all_launches()
    check(not any(launches.values()), f"a port kernel launched on (b)-(e) "
          f"(they run no TPU kernel): {launches}")
    dt = time.perf_counter() - t0
    print(f"input pipeline phase: {dt:.1f} s on {smi}", flush=True)
    return dt


# ------------------------------------------------------------ phase 17

# bench_suite.py's bench_bert row: bert-base, batch 16 x seq 512, bf16,
# the compiled trainer, lr 1e-4; then ERNIE-3.0-base (vocab 40000) the
# same way while the phase has time left
BERT_BATCH, BERT_SEQ = 16, 512
BERT_ERNIE_BEFORE_S = 150.0
# the eager fused encoder: bert-base's widths in 12 FusedTransformerEncoder
# layers (post-norm, gelu), the same batch
FUSED_ENCODER = dict(d_model=768, nhead=12, dim_feedforward=3072,
                     layers=12)
# graph pooling: 2^20 node rows of 128 features into 2^16 graphs
SEG_ROWS, SEG_WIDTH, SEG_COUNT = 1 << 20, 128, 1 << 16
SEG_EMPTY = 1000  # the graph left empty
SEGMENT_OPS = ("segment_sum", "segment_mean", "segment_max", "segment_min")


def bert_flops_per_token(cfg, seq) -> float:
    """6 N + 12 L s h with N = 12 L h^2 + V h + P h, as ``bench.py``
    counts a step."""
    h, L = cfg.hidden_size, cfg.num_layers
    n = 12 * L * h * h + cfg.vocab_size * h \
        + cfg.max_position_embeddings * h
    return 6 * n + 12 * L * seq * h


def small_bert_check():
    """The CUDA BERT step against the port's CPU path on bert-tiny in
    fp32 (seq 128, 85% of the labels ignored, as masked-LM batches are):
    two steps from the same state, held as ``small_step_check`` holds the
    GPT (losses 1e-5 relative, masters 1e-4)."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.models.trainer import tree_leaves, tree_map
    cfg = dataclasses.replace(bert.BERT_CONFIGS["bert-tiny"],
                              dtype="float32")
    init_fn, cuda_step = bert.build_train_step(cfg, device="cuda")
    _, cpu_step = bert.build_train_step(cfg, device="cpu")
    state = init_fn(0)
    cpu_state = tree_map(lambda t: t.cpu(), state)
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
    labels[torch.from_numpy(rng.uniform(0, 1, (2, 128)) < 0.85)] = -100
    for i in range(2):
        state, loss = cuda_step(state, tokens.cuda(), labels.cuda())
        cpu_state, cpu_loss = cpu_step(cpu_state, tokens, labels)
        print(f"small bert step {i}: cuda loss {loss.item():.6f} "
              f"cpu loss {cpu_loss.item():.6f}")
        check(abs(loss.item() - cpu_loss.item())
              <= 1e-5 * abs(cpu_loss.item()), "small bert step loss")
    err = max(_err(a.cpu(), b) for a, b in zip(
        tree_leaves(state["master"]), tree_leaves(cpu_state["master"])))
    print(f"small bert step master max abs err {err:.3g} (limit 1e-4)")
    check(err <= 1e-4, f"small bert step master err {err}")


def bert_step_path(name, smi):
    """``name`` from ``BERT_CONFIGS`` through ``build_train_step``: bf16
    params, fp32 master, remat per block, AdamW lr 1e-4, batch
    ``BERT_BATCH`` x seq ``BERT_SEQ``, tokens and labels drawn as
    ``bench_bert`` draws them; 1 warm-up and 5 timed steps, one profiled.
    No port kernel may launch (the reference's BERT calls none)."""
    from paddle_tpu_torch.models import bert
    cfg = bert.BERT_CONFIGS[name]
    b, s = BERT_BATCH, BERT_SEQ
    init_fn, step = bert.build_train_step(cfg, lr=1e-4, remat=True,
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
        print(f"{name} step {i}{' (warm-up)' if not i else ''}: loss "
              f"{losses[-1]:.5f} {dt:.1f} ms")
    launches = _all_launches()
    check(not any(launches.values()), f"the BERT path launched a port "
          f"kernel; its reference calls none: {launches}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"{name} loss did not fall: {losses}")
    med = float(np.median(step_ms))
    tok_s = b * s / (med / 1e3)
    fpt = bert_flops_per_token(cfg, s)
    mfu = fpt * tok_s / PEAK_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    print(f"{name} b{b} s{s} bf16 remat adamw ({fpt / 1e6:.1f} MFLOP a "
          f"token, {fpt * b * s / 1e12:.3f} TFLOP a step): median "
          f"{med:.2f} ms/step of {TIMED_STEPS} (steps "
          f"{[round(x, 2) for x in step_ms]}), {tok_s:.1f} tokens/s, MFU "
          f"{mfu:.4f} of 989 TFLOP/s, peak memory {peak / 2**30:.2f} GiB on "
          f"{smi}")
    check(peak < DEVICE_BYTES, f"peak memory {peak}")
    profile_step(step, state, tokens, labels, med)
    return med


def fused_encoder_path(smi):
    """12 ``incubate.nn.FusedTransformerEncoderLayer(768, 12, 3072,
    activation="gelu")`` (post-norm, dropout 0.1) eagerly: fp32
    parameters, O1 bf16, ``AdamW(1e-4)``, batch ``BERT_BATCH`` x
    ``BERT_SEQ`` of seeded inputs, a bool padding mask that hides the last
    quarter of the keys from half the rows, MSE to a seeded target. Checks
    that O1 ran its 12 dense SDPAs a forward in bf16, that the loss is
    finite and falls, and that no port kernel launched."""
    import paddle_tpu_torch as paddle
    from torch.profiler import record_function
    F = paddle.nn.functional
    c = FUSED_ENCODER
    b, s, h, f = BERT_BATCH, BERT_SEQ, c["d_model"], c["dim_feedforward"]
    paddle.set_device("gpu")
    paddle.seed(0)
    layers = paddle.nn.LayerList([
        paddle.incubate.nn.FusedTransformerEncoderLayer(
            h, c["nhead"], f, activation="gelu")
        for _ in range(c["layers"])])
    opt = paddle.optimizer.AdamW(1e-4, parameters=layers.parameters())
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randn(b, s, h).astype(np.float32))
    target = paddle.to_tensor(rng.randn(b, s, h).astype(np.float32))
    keep = np.ones((b, 1, 1, s), bool)
    keep[::2, ..., -s // 4:] = False
    mask = paddle.to_tensor(keep)
    layers.train()

    def step():
        with record_function("forward"):
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                y = x
                for layer in layers:
                    y = layer(y, mask)
            loss = F.mse_loss(y.astype("float32"), target)
        loss.backward()
        with record_function("optimizer"):
            opt.step()
            opt.clear_grad()
        return loss

    counts = {}
    _reset_all_launches()
    undo = _count_sdpa(counts)
    try:
        step()
    finally:
        undo()
    print(f"fused encoder sdpa calls in one O1 step by io type: {counts}")
    check(counts == {"bfloat16": c["layers"]}, f"O1 did not run the "
          f"{c['layers']} SDPAs of a forward in bf16: {counts}")
    # a forward: 4 h^2 + 2 h f multiply-adds a token in the products, and
    # 2 s h in the attention; a training step 3 forwards
    flops_step = 3 * b * s * c["layers"] * 2 * (4 * h * h + 2 * h * f
                                                + 2 * s * h)
    losses, med, prof = _train_steps(
        f"fused encoder {c['layers']} x ({h}, {c['nhead']}, {f}) b{b} s{s} "
        f"bf16 O1 AdamW", step, b * s, flops_step, smi)
    check(losses[-1] < losses[0], f"fused encoder loss did not fall: "
          f"{losses}")
    launches = _all_launches()
    check(not any(launches.values()), f"the fused encoder launched a port "
          f"kernel (it runs none): {launches}")
    return med, prof


def segment_inputs(seed=0):
    """``SEG_ROWS`` rows of ``SEG_WIDTH`` fp32 features, sorted ids of
    ``SEG_COUNT`` graphs (sizes drawn at random), graph ``SEG_EMPTY`` empty
    and the last graph present."""
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.randint(0, SEG_COUNT, SEG_ROWS))
    ids[ids == SEG_EMPTY] = SEG_EMPTY + 1
    ids[-1] = SEG_COUNT - 1
    data = rng.randn(SEG_ROWS, SEG_WIDTH).astype(np.float32)
    return data, ids


def segment_checks(smi):
    """The four segment reductions at a graph-pooling size on the card
    against the port's CPU path (forward and the gradient of sum(out * r),
    at ``op_cases.limit``), then fwd+bwd timed (CUDA events, mean of 10)
    through the eager API (which reads the segment count on the host each
    call) and through the registered body alone, beside the byte bound
    (data, ids and the output's gradient read once, the output and the
    data's gradient written once)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import op_registry
    from paddle_tpu_torch.testing import op_cases as oc
    data, ids = segment_inputs()
    out_shape = (SEG_COUNT, SEG_WIDTH)
    r = np.random.RandomState(1).uniform(-1, 1, out_shape).astype(
        np.float32)
    nbytes = data.nbytes + ids.nbytes + 2 * r.nbytes + data.nbytes
    bound = nbytes / PEAK_BYTES * 1e3
    terms = SEG_ROWS // SEG_COUNT
    _reset_all_launches()
    for name in SEGMENT_OPS:
        res = {}
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            d = paddle.to_tensor(data, stop_gradient=False)
            out = getattr(paddle.incubate, name)(d, paddle.to_tensor(ids))
            (out * paddle.to_tensor(r)).sum().backward()
            res[dev] = (out._t.detach(), d.grad._t)
        worst = 0.0
        for k, what in enumerate(("out", "grad")):
            ratio, bad = _op_compare(oc, f"{name} {what}", res["gpu"][k],
                                     res["cpu"][k].cuda(), "reduce", terms,
                                     grad=k == 1)
            check(bad is None, f"{name} {what}: {bad}")
            worst = max(worst, ratio)
        empty = res["gpu"][0][SEG_EMPTY]
        check(not bool(empty.any()), f"{name}: the empty graph is not 0")
        paddle.set_device("gpu")
        d = paddle.to_tensor(data, stop_gradient=False)
        i = paddle.to_tensor(ids)
        rt = torch.from_numpy(r).cuda()
        body = op_registry.get_op(name).fn
        dt, it = d._t, i._t

        def eager():
            out = getattr(paddle.incubate, name)(d, i)
            torch.autograd.grad((out._t * rt).sum(), dt)

        def alone():
            out = body(dt, it, SEG_COUNT)
            torch.autograd.grad((out * rt).sum(), dt)

        ms_eager = cuda_ms(eager, 10)
        ms_body = cuda_ms(alone, 10)
        print(f"{name} [{SEG_ROWS}, {SEG_WIDTH}] fp32 into {SEG_COUNT} "
              f"sorted segments (one empty): fwd+bwd {ms_eager:.4f} ms "
              f"through the eager API, {ms_body:.4f} ms the body alone; "
              f"byte bound {bound:.4f} ms ({bound / ms_body:.1%} of it "
              f"alone); worst {worst:.3g} of its limit against the CPU "
              f"path; on {smi}", flush=True)
        del res, d, i, dt, it
        torch.cuda.empty_cache()
    launches = _all_launches()
    check(not any(launches.values()), f"the segment ops launched a port "
          f"kernel (they run none): {launches}")


def bert_fused_path(smi):
    """Phase 17: (a) the BERT trainer at bench_bert's shape (after a
    bert-tiny step against the CPU path), then ERNIE-3.0-base while time
    is left; (b) the eager fused encoder; (c) the segment reductions at a
    graph-pooling size."""
    phase("17 bert and the fused layers")
    t0 = time.perf_counter()
    small_bert_check()
    torch.cuda.empty_cache()
    bert_step_path("bert-base", smi)
    torch.cuda.empty_cache()
    if time.perf_counter() - t0 < BERT_ERNIE_BEFORE_S:
        bert_step_path("ernie-3.0-base", smi)
    else:
        print(f"ernie-3.0-base skipped: the phase had run "
              f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    fused_encoder_path(smi)
    torch.cuda.empty_cache()
    segment_checks(smi)
    dt = time.perf_counter() - t0
    print(f"bert and fused layers phase: {dt:.1f} s on {smi}", flush=True)
    return dt


# ------------------------------------------------- phase 18: the mesh path

MESH_STEPS = 3  # steps held bit for bit against the single-device trainer


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_group(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "NCCL collectives"
    if "memcpy" in low:
        return "device copies (memcpy)"
    return _kernel_group(name)


def _turns(step, state, tokens, labels, n):
    """Host ms of ``n`` steps, each ended by a synchronize."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(state, tokens, labels)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def mesh_path(smi, phase5_ms, cfg_name="gpt2-medium", device="cuda"):
    """Phase 18: (a) ``entry.dryrun_multichip`` over every card through
    NCCL; (b) phase 5's gpt2-medium step through the mesh trainer at world
    size 1 (NCCL; every collective called on its one-rank group): three
    steps' losses and the final params and master weights bit for bit
    against the single-device trainer from the same seed and batch, 48 /
    24 / 24 launches of #1 / #2 / #3 a step, then both trainers timed in
    turns (1 warm-up and 5 steps each way), the collectives a step, peak
    memory and one profiled step."""
    from paddle_tpu_torch import entry
    from paddle_tpu_torch.distributed import _collectives as C
    from paddle_tpu_torch.distributed import (ProcessMesh,
                                              destroy_process_group,
                                              init_parallel_env)
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.trainer import tree_leaves
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    phase("18 the main path on a mesh (torch.distributed)")
    t_phase = time.perf_counter()
    # one host: NCCL's bootstrap over the loopback (the ranks, spawned
    # ones included, inherit it)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    n = torch.cuda.device_count()
    print(f"{n} card(s): NCCL takes one rank a card, so the card runs the "
          f"mesh at world size {n}; runs of more ranks are the CPU tests' "
          f"(gloo ranks, tests/test_torch_*mesh*, *mp_ops, *pipeline*, "
          f"*flash_sharded) until a machine has several cards")
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(n, device=None if device == "cuda"
                                 else device)
    check(math.isfinite(dry), f"dryrun loss {dry}")
    print(f"dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s "
          f"(a process a rank: start, kernels loaded from the build, one "
          f"step)")

    init_parallel_env(f"tcp://127.0.0.1:{_free_port()}", rank=0,
                      world_size=1, device=device)
    try:
        cfg = gpt.GPT_CONFIGS[cfg_name]
        mesh = ProcessMesh([[[0]]], ["dp", "pp", "mp"])
        init_s, step_s = gpt.build_train_step(cfg, lr=1e-4, remat=True,
                                              device=device)
        init_m, step_m = gpt.build_train_step(
            cfg, mesh=mesh, lr=1e-4, seq_shard=True, zero1=True,
            remat=True, device=device)
        rng = np.random.RandomState(0)  # phase 5's batch
        tokens = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (BATCH, SEQ))).to(device)
        labels = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (BATCH, SEQ))).to(device)
        state_s = init_s(0)
        losses_s = [step_s(state_s, tokens, labels)[1].item()
                    for _ in range(MESH_STEPS)]
        state_m = init_m(0)
        per_step = {"flash_fwd": 2 * cfg.num_layers,
                    "flash_bwd_dkv": cfg.num_layers,
                    "flash_bwd_dq": cfg.num_layers}
        losses_m, calls = [], {}
        for i in range(MESH_STEPS):
            fa.reset_launches()
            C.reset_calls()
            _, loss = step_m(state_m, tokens, labels)
            losses_m.append(loss.item())
            launches = {k: fa.LAUNCHES[k] for k in per_step}
            calls = dict(C.CALLS)
            print(f"mesh step {i}: loss {losses_m[-1]!r} (single-device "
                  f"{losses_s[i]!r}); launches {launches}")
            check(launches == per_step,
                  f"mesh step {i} launched {launches}, want {per_step}")
        check(losses_m == losses_s,
              f"mesh losses {losses_m} != single-device {losses_s}")
        for key in ("params", "master"):
            equal = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(state_m[key]), tree_leaves(state_s[key])))
            print(f"{key} after {MESH_STEPS} steps bit-equal to the "
                  f"single-device trainer's: {equal}")
            check(equal, f"mesh {key} differ from the single-device run")
        print(f"collectives a mesh step: {sum(calls.values())} "
              f"({dict(sorted(calls.items()))})")

        single = _turns(step_s, state_s, tokens, labels, 1 + TIMED_STEPS)
        meshed = _turns(step_m, state_m, tokens, labels, 1 + TIMED_STEPS)
        meshed += _turns(step_m, state_m, tokens, labels, TIMED_STEPS)
        single += _turns(step_s, state_s, tokens, labels, TIMED_STEPS)
        med_s = float(np.median(single[1:]))
        med_m = float(np.median(meshed[1:]))
        del state_s
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _turns(step_m, state_m, tokens, labels, 1)
        peak = torch.cuda.max_memory_allocated()
        print(f"{cfg_name} b{BATCH} s{SEQ} bf16 remat adamw on the mesh "
              f"(dp1 x pp1 x mp1, seq_shard, ZeRO-1): median {med_m:.2f} "
              f"ms/step of {2 * TIMED_STEPS} against the single-device "
              f"trainer's {med_s:.2f} in turns ({med_m / med_s:.4f}x) and "
              f"phase 5's {phase5_ms:.2f} ({med_m / phase5_ms:.4f}x); "
              f"steps {[round(x, 2) for x in meshed[1:]]}, single "
              f"{[round(x, 2) for x in single[1:]]}; peak memory "
              f"{peak / 2**30:.2f} GiB on {smi}")
        prof = profile_step(step_m, state_m, tokens, labels, med_m,
                            group=_mesh_group)
        if prof is not None:
            comm = sum(t for g, t in prof["groups"].items()
                       if g in ("NCCL collectives", "device copies (memcpy)"))
            print(f"mesh step: {comm:.3f} ms of NCCL kernels and device "
                  f"copies in one step; idle share {prof['idle']:.3f}")
    finally:
        destroy_process_group()
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s on {smi}",
          flush=True)


# ------------------------------------------------------------ phase 19

# the compiled step's losses against the eager step's (the same weights,
# batch and seed): 2.4e-5 relative in every run on the H100 (limit 1e-3)
COMPILE_LOSS_REL = 1e-3
# step 1's gradients, leaf by leaf, ||compiled - eager|| / ||eager||: the
# same weights and batch, so only the rounding points differ (inductor
# rounds each fused group of O1 elementwise ops to bf16 once, eager after
# each op); 0.0077 at the worst leaf, 0.0053 at the median on the H100;
# a lost or wrong dQ or dK/dV reads ~1 on the attention leaves
COMPILE_GRAD_REL = 2.0 ** -5
# ResNet-50 against the eager model, three steps, each from the eager
# model's parameters and BN statistics (left to run free, any two models
# drift apart step by step: Momentum(0.1) from scratch compounds any
# rounding difference, as it does one of summation order alone,
# ``chip_compile_witness.py``). Under O1: each step's loss and the BN
# running statistics it leaves (the worst buffer's ||c - e|| / ||e||, and
# its worst element over the buffer's scale); 0.0027 and 0.0055 at worst
# on the H100, an eager twin fed the batch in another order 0.0020 and
# 0.0056
RESNET_LOSS_REL = 2.0 ** -6
# Under O1 the gradients at this initialisation are mostly rounding noise
# (over all leaves at once, the compiled model and the reordered twin both
# read 0.89-1.07 against eager), so the backward is held in fp32 (TF32
# off) on the model cut to one block a stage: each step's loss and BN
# statistics (0 and 4.4e-7 at worst, the twin 8.6e-8 and 3.7e-7) ...
RESNET_FP32_REL = 1e-5
# ... its gradients and update over all leaves at once (0.0024 at worst,
# the twin 0.0025) ...
RESNET_FP32_GRAD_REL = 2.0 ** -6
# ... and at the worst leaf (0.0069, the twin 0.0056); a lost or wrong
# term of the backward reads 0.1-1
RESNET_FP32_LEAF_REL = 2.0 ** -4
# fp32 forwards, TF32 off: inductor's fused kernels sum in another order
LOADED_REL = 1e-4
COMPILED_STEPS = 5


def _graph_counts(layer):
    """The compiled forward's cache: one entry, its traces and graphs."""
    cache = layer.forward._fwd_cache
    check(len(cache) == 1, f"{len(cache)} cache entries, want 1")
    entry = next(iter(cache.values()))
    return entry.traces, entry.counts


def _no_library_attention(names):
    """No PyTorch or cuDNN attention among a profile's op and kernel
    names."""
    bad = sorted(n for n in names if "scaled_dot_product" in n
                 or "fmha" in n.lower() or "pytorch_flash" in n
                 or ("cudnn" in n.lower() and ("attn" in n.lower()
                                               or "mha" in n.lower())))
    check(not bad, f"library attention in the compiled step: {bad[:5]}")


def _step_grads(opt, params, run):
    """Runs ``run()``, one training step ending in ``opt.step()``; returns
    its loss and copies (fp32) of the gradients that step read."""
    grads = []
    step = opt.step

    def capture():
        grads.extend(torch.zeros_like(p._t, dtype=torch.float32)
                     if p.grad is None else
                     p.grad._t.detach().float().clone() for p in params)
        step()
    opt.step = capture
    try:
        loss = run()
    finally:
        del opt.step
    return loss, grads


def _divergence(got, want):
    """Leaf by leaf ||got - want|| / ||want|| (float64; leaves whose
    ``want`` is all zeros left out): the worst, the median and the worst
    leaf's index, and the same ratio over all leaves at once
    ("global")."""
    rels, num, den = {}, 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        d = float(w.double().norm())
        n = float((g.double() - w.double()).norm())
        num, den = num + n * n, den + d * d
        if d > 0:
            rels[i] = n / d
    at = max(rels, key=rels.get)
    return {"worst": rels[at], "median": float(np.median(list(rels.values()))),
            "at": at, "global": (num / den) ** 0.5}


def _worst_elem(got, want):
    """The worst element's |got - want| over its buffer's largest
    magnitude (at least 1), over all buffers."""
    return max(float((g.double() - w.double()).abs().max())
               / max(1.0, float(w.double().abs().max()))
               for g, w in zip(got, want))


def _in_turns(step, n=3):
    """Host ms of ``n`` steps of each model in turns (eager, compiled,
    compiled, eager), each turn after one warm-up step."""
    ms = {"eager": [], "compiled": []}
    for name in ("eager", "compiled", "compiled", "eager"):
        step(name)
        torch.cuda.synchronize()
        ms[name] += _turns(lambda *_: step(name), None, None, None, n)
    return ms


def compiled_gpt(smi, cfg_name="gpt2-medium", batch=BATCH, seq=SEQ,
                 layers=None, persist_dir=None):
    """(a) phase 10's eager gpt2-medium (fp32 parameters, O1 bf16, AdamW
    1e-4, seed 0; its depth cut to ``layers`` where given) through
    ``paddle.jit.to_static`` (inductor): the first
    step's seconds (trace + inductor's cold compile of the forward and
    backward graphs, with its cache in a fresh directory), step 1's
    gradients leaf by leaf and three losses against the eager model's
    from the same seed, 24 / 24 / 24 launches of #1 / #2 / #3 a step, one
    forward and one backward graph and one trace over all steps, no
    library attention in a profiled step, ms/step, tokens/s and idle
    share beside the eager step in turns, peak memory. With
    ``persist_dir`` the model compiles with ``FLAGS_executable_cache_dir``
    set to it (phase 21 (b) warm-starts a child from it): its first step's
    seconds, three losses and the cache's counts go to ``PERSIST``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import persist
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    if persist_dir is not None:
        paddle.set_flags({"FLAGS_executable_cache_dir": persist_dir})
        try:
            return compiled_gpt(smi, cfg_name, batch, seq, layers)
        finally:
            paddle.set_flags({"FLAGS_executable_cache_dir": ""})
            PERSIST.update(persist.counters(), dir=persist_dir)
    cfg = gpt.GPT_CONFIGS[cfg_name] if isinstance(cfg_name, str) \
        else cfg_name
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg_name = f"{cfg_name} at {layers} layers"
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)))
    models = {}
    for name in ("eager", "compiled"):
        paddle.seed(0)
        model = gpt.GPTForPretraining(cfg)
        if name == "compiled":
            model = paddle.jit.to_static(model)
        models[name] = (model, gpt.GPTPretrainingCriterion(),
                        paddle.optimizer.AdamW(
                            1e-4, parameters=model.parameters()))

    def step(name):
        return _eager_step(paddle, *models[name], x, y, "bfloat16")

    losses = {"eager": [], "compiled": []}
    grads = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name in ("compiled", "eager"):  # the compiled model compiles first
        model, _, opt = models[name]
        loss, grads[name] = _step_grads(opt, list(model.parameters()),
                                        lambda: step(name))
        losses[name].append(float(loss))
        if name == "compiled":
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
    div = _divergence(grads["compiled"], grads["eager"])
    names = [n for n, _ in models["eager"][0].named_parameters()]
    del grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        for name in ("compiled", "eager"):
            losses[name].append(float(step(name)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["compiled"],
                                                  losses["eager"]))
    print(f"compiled {cfg_name}: first step (trace + inductor's cold "
          f"compile of both graphs + run) {first_s:.1f} s on {smi}")
    print(f"step 1's gradients against eager, leaf by leaf ||c - e|| / "
          f"||e||: worst {div['worst']:.3g} ({names[div['at']]}), median "
          f"{div['median']:.3g} over {len(names)} leaves (limit "
          f"{COMPILE_GRAD_REL:.3g}); all leaves at once {div['global']:.3g}")
    print(f"losses compiled {[round(v, 5) for v in losses['compiled']]} "
          f"eager {[round(v, 5) for v in losses['eager']]}: worst relative "
          f"{rel:.3g} (limit {COMPILE_LOSS_REL:.3g})")
    check(all(math.isfinite(v) for v in losses["compiled"]),
          f"compiled losses {losses['compiled']}")
    check(div["worst"] <= COMPILE_GRAD_REL, f"compiled gradients off by "
          f"{div['worst']} at {names[div['at']]}")
    check(rel <= COMPILE_LOSS_REL, f"compiled losses off by {rel}")
    PERSIST.update(first_s=first_s, losses=losses["compiled"][:3])

    _reset_all_launches()
    step("compiled")
    torch.cuda.synchronize()
    launches = _all_launches()
    want = {n: (cfg.num_layers if n in fa.LAUNCHES else 0) for n in launches}
    print(f"port kernel launches in one compiled step: {launches}")
    check(launches == want, f"compiled step launches {launches}, want "
          f"{want}")
    for _ in range(COMPILED_STEPS - 4):
        step("compiled")
    traces, counts = _graph_counts(models["compiled"][0])
    print(f"after {COMPILED_STEPS} steps: {traces} trace, graphs {counts}")
    check(traces == 1 and counts == {"forward": 1, "backward": 1},
          f"traces {traces}, graphs {counts}")
    peak = torch.cuda.max_memory_allocated()

    ms = _in_turns(step)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    prof = {}
    for name in ("eager", "compiled"):
        prof[name] = profile_step(lambda *_: step(name), None, None, None,
                                  med[name])
    if prof["compiled"] is not None:
        _no_library_attention(prof["compiled"]["names"])
    for name in ("eager", "compiled"):
        idle = "not measured" if prof[name] is None else \
            f"{prof[name]['idle']:.3f}"
        print(f"{name} {cfg_name} O1 step in turns: median {med[name]:.2f} "
              f"ms/step of {len(ms[name])} ({[round(v, 2) for v in ms[name]]}"
              f"), {batch * seq / (med[name] / 1e3):.1f} tokens/s, idle "
              f"share {idle}")
    print(f"compiled / eager: {med['compiled'] / med['eager']:.3f}x; peak "
          f"memory of the compiled run after step 1 {peak / 2**30:.2f} GiB "
          f"(both models resident) on {smi}")
    return med


def _cut_resnet(paddle, model, blocks):
    """``model`` with each of its four stages cut to its first ``blocks``
    blocks (the first holds the stage's stride and width change, so the
    widths are kept); unchanged for None."""
    for stage in ("layer1", "layer2", "layer3", "layer4")[
            :4 if blocks else 0]:
        setattr(model, stage, paddle.nn.Sequential(
            *list(getattr(model, stage))[:blocks]))
    return model


def resnet_divergence(smi, amp=True, twins=("permuted",), forced=True,
                      factory="resnet50", batch=RESNET_BATCH,
                      size=RESNET_SIZE, classes=1000, steps=3, blocks=None):
    """``bench_suite.py``'s ResNet-50 workload (``Momentum(0.1)``, batch 64
    x 224^2; O1 bf16, or fp32 with ``amp=False``) trained ``steps`` steps
    on one batch from seed 0, several ways: eager; ``@to_static``
    ("compiled", stepped first: its first step holds the trace and
    inductor's cold compile); and each eager twin in ``twins``, built from
    the same seed: "same" on the same batch, "permuted" on the batch's
    samples in another order (the same step in exact arithmetic: only the
    summation orders of the BN statistics, the loss's mean and the weight
    gradients change). With ``forced``, every way starts each step from
    the eager model's parameters and BN statistics (copied in place), so
    each step's comparison holds one step's rounding; without it the ways
    run free and any difference compounds from step to step. ``blocks``
    keeps that many blocks of each stage (the first holds the stage's
    downsample). Each way against eager, step by step: the loss
    (relative), the gradients and the update (p_after - p_before)
    (``_divergence``), the BN running statistics after the step (the
    worst buffer's ``_divergence`` and the worst element over its
    buffer's largest magnitude). Prints the readings; returns the
    models (model, optimizer, step) by way, the readings by way and the
    compiled first step's seconds."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision import models as vm
    rng = np.random.RandomState(0)
    x_np = rng.randn(batch, 3, size, size).astype("float32")
    y_np = rng.randint(0, classes, (batch,)).astype("int64")
    perm = np.random.RandomState(1).permutation(batch)
    ways = ("compiled", "eager") + tuple(twins)
    models = {}
    for name in ways:
        paddle.seed(0)
        model = _cut_resnet(paddle, getattr(vm, factory)(
            num_classes=classes), blocks)
        if name == "compiled":
            model = paddle.jit.to_static(model)
        order = perm if name == "permuted" else slice(None)
        models[name] = (model, paddle.optimizer.Momentum(
            0.1, parameters=model.parameters()),
            paddle.to_tensor(x_np[order]), paddle.to_tensor(y_np[order]))

    def step(name):
        model, opt, x, y = models[name]
        return _resnet_step(paddle, F, model, opt, x, y, amp=amp)

    def params(name):
        return [p._t for p in models[name][0].parameters()]

    def bufs(name):
        return [b._t for _, b in models[name][0].named_buffers()]

    r = {n: {"losses": [], "loss": [], "grad": [], "update": [], "bn": []}
         for n in ways}
    t0 = time.perf_counter()
    for i in range(steps):
        if forced and i:
            with torch.no_grad():
                for name in ways:
                    for get in (params, bufs):
                        for t, e in zip(get(name), get("eager")):
                            t.copy_(e)
        before = {n: [t.detach().clone() for t in params(n)] for n in ways}
        grads = {}
        for name in ways:
            model, opt = models[name][:2]
            loss, grads[name] = _step_grads(
                opt, list(model.parameters()), lambda: step(name))
            r[name]["losses"].append(float(loss))
            if i == 0 and name == "compiled":
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
        upd = {n: [a.detach() - b for a, b in zip(params(n), before[n])]
               for n in ways}
        for name in ways:
            w = r[name]
            w["loss"].append(abs(w["losses"][-1] - r["eager"]["losses"][-1])
                             / abs(r["eager"]["losses"][-1]))
            w["grad"].append(_divergence(grads[name], grads["eager"]))
            w["update"].append(_divergence(upd[name], upd["eager"]))
            w["bn"].append((_divergence(bufs(name), bufs("eager"))["worst"],
                            _worst_elem(bufs(name), bufs("eager"))))
        del grads, upd, before
    kind = "O1 bf16" if amp else "fp32"
    mode = "each step from eager's state" if forced else "running free"
    cut = f" cut to {blocks} block(s) a stage" if blocks else ""
    print(f"{factory}{cut} b{batch} {size}^2 {kind} momentum 0.1, {steps} "
          f"steps from seed 0, {mode}; each way against eager step by step "
          f"(compiled's first step, trace + cold compile + run: "
          f"{first_s:.1f} s on {smi}):")

    def fmt(vals):
        return "[" + ", ".join(f"{v:.3g}" for v in vals) + "]"

    def fmt_div(divs):
        return "[" + ", ".join(f"{d['worst']:.3g}/{d['median']:.3g}/"
                               f"{d['global']:.3g}" for d in divs) + "]"
    for name in ways:
        w = r[name]
        print(f"  {name}: losses {[round(v, 5) for v in w['losses']]}" + (
            "" if name == "eager" else
            f", relative {fmt(w['loss'])}; gradients worst/median leaf/all "
            f"leaves {fmt_div(w['grad'])}; update {fmt_div(w['update'])}; "
            f"BN statistics worst buffer {fmt([b for b, _ in w['bn']])}, "
            f"worst element over its buffer's scale "
            f"{fmt([e for _, e in w['bn']])}"))
    return {n: models[n][:2] + (lambda n=n: step(n),) for n in ways}, r, \
        first_s


# phase 19 (b)'s depth: ResNet-50's O1 model cut to 1 bottleneck block a
# stage (its widths kept): inductor's cold compile of the whole model took
# 150-260 s (133 s at 2 blocks a stage), and phase 21 came after it in the
# same 1200 s
RESNET_COMPILED_BLOCKS = 1


def compiled_resnet(smi, factory="resnet50", batch=RESNET_BATCH,
                    size=RESNET_SIZE, classes=1000, fp32_blocks=1,
                    blocks=RESNET_COMPILED_BLOCKS):
    """(b) ``bench_suite.py``'s ResNet-50 workload with ``@to_static``
    (cut to ``blocks`` block(s) a stage, None for all):
    O1 bf16, ``Momentum(0.1)``, batch 64 x 224^2, three steps against
    phase 11's eager model, each from the eager model's state, with an
    eager twin fed the batch in another order beside it
    (``resnet_divergence``): every step's loss and BN statistics held to
    rounding; its gradients and updates are printed beside the twin's
    (under O1 both are mostly rounding noise, ``RESNET_FP32_REL``). Then
    the same three steps in fp32 on the model cut to ``fp32_blocks``
    block(s) a stage: every step's loss, BN statistics, gradients and
    update held to fp32 rounding. Then one trace and one forward and one
    backward graph, ms/step and images/s beside the eager O1 step in
    turns, idle share."""
    models, r, _ = resnet_divergence(smi, True, ("permuted",), True,
                                     factory, batch, size, classes,
                                     blocks=blocks)
    c = r["compiled"]
    check(all(math.isfinite(v) for v in c["losses"]),
          f"compiled resnet losses {c['losses']}")
    worst = {"loss": max(c["loss"]), "BN": max(max(b) for b in c["bn"])}
    print("O1 over the three steps: " + ", ".join(
        f"{k} {v:.3g}" for k, v in worst.items())
        + f" (limit {RESNET_LOSS_REL:.3g})")
    check(max(worst.values()) <= RESNET_LOSS_REL,
          f"compiled resnet against eager: {worst}")
    traces, counts = _graph_counts(models["compiled"][0])
    check(traces == 1 and counts == {"forward": 1, "backward": 1},
          f"traces {traces}, graphs {counts}")
    del models["permuted"]

    _, r, _ = resnet_divergence(smi, False, ("permuted",), True, factory,
                                batch, size, classes, blocks=fp32_blocks)
    c = r["compiled"]
    worst = {"loss": (max(c["loss"]), RESNET_FP32_REL),
             "BN": (max(max(b) for b in c["bn"]), RESNET_FP32_REL)}
    for key in ("grad", "update"):
        worst[f"{key} (all leaves)"] = (max(d["global"] for d in c[key]),
                                        RESNET_FP32_GRAD_REL)
        worst[f"{key} (worst leaf)"] = (max(d["worst"] for d in c[key]),
                                        RESNET_FP32_LEAF_REL)
    print("fp32 over the three steps: " + ", ".join(
        f"{k} {v:.3g} (limit {lim:.3g})" for k, (v, lim) in worst.items()))
    check(all(v <= lim for v, lim in worst.values()),
          f"fp32 compiled resnet against eager: {worst}")

    def step(name):
        return models[name][2]()

    ms = _in_turns(step)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    for name in ("eager", "compiled"):
        prof = profile_step(lambda *_: step(name), None, None, None,
                            med[name], group=_vision_group)
        idle = "not measured" if prof is None else f"{prof['idle']:.3f}"
        cut = f" cut to {blocks} blocks a stage" if blocks else ""
        print(f"{name} {factory}{cut} b{batch} {size}^2 O1 momentum in "
              f"turns: "
              f"median {med[name]:.2f} ms/step of {len(ms[name])} "
              f"({[round(v, 2) for v in ms[name]]}), "
              f"{batch / (med[name] / 1e3):.1f} images/s, idle share {idle}")
    print(f"compiled / eager: {med['compiled'] / med['eager']:.3f}x on {smi}")
    return med


def _predictor_check(label, layer, spec, batches, make_input, tmp):
    """``jit.save`` with ``spec`` (a None batch), ``jit.load``, then
    ``inference.create_predictor`` on the card; each batch's outputs
    against the eager layer's. Returns the port kernel launches of one
    predictor run at the last batch."""
    import paddle_tpu_torch as paddle
    path = os.path.join(tmp, label)
    t0 = time.perf_counter()
    paddle.jit.save(layer, path, input_spec=[spec])
    loaded = paddle.jit.load(path)
    pred = paddle.inference.create_predictor(paddle.inference.Config(path))
    print(f"{label}: jit.save + jit.load + create_predictor "
          f"{time.perf_counter() - t0:.1f} s")
    launches = None
    for b in batches:
        x = make_input(b)
        with paddle.no_grad():
            want = layer(paddle.to_tensor(x)).numpy()
        t0 = time.perf_counter()
        _reset_all_launches()
        got = pred.run([x])[0]
        torch.cuda.synchronize()
        launches = _all_launches()
        compile_s = time.perf_counter() - t0
        with paddle.no_grad():
            via_load = loaded(paddle.to_tensor(x)).numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        err_load = float(np.abs(via_load - want).max()) / scale
        print(f"{label} batch {b}: predictor (first run, compile included "
              f"{compile_s:.1f} s) worst abs err over the output's scale "
              f"{err:.3g}, jit.load's layer {err_load:.3g} (limit "
              f"{LOADED_REL:g})")
        check(err <= LOADED_REL and err_load <= LOADED_REL,
              f"{label} batch {b}: {err}, {err_load}")
    return launches


def saved_programs(smi, resnet="resnet50", size=RESNET_SIZE,
                   gpt_cfg="gpt2-medium", seq=SEQ,
                   blocks=RESNET_COMPILED_BLOCKS):
    """(c) ``jit.save`` with a None batch, ``jit.load`` and
    ``inference.create_predictor`` on the card, fp32, eval mode: ResNet-50
    cut to ``blocks`` bottleneck blocks a stage (as (b))
    at batch 64 and 7, and a 2-layer GPT at gpt2-medium's width (its
    attention through kernel #1 inside the loaded program: two launches a
    run) at batch 2 and 3 (its logits, [b, 1024, 50304] in fp32, are read
    back to the host)."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.vision import models as vm
    tmp = tempfile.mkdtemp(prefix="phase19_")
    try:
        paddle.seed(0)
        net = _cut_resnet(paddle, getattr(vm, resnet)(), blocks)
        net.eval()
        _predictor_check(
            f"{resnet} cut to {blocks} blocks a stage", net, paddle.static.InputSpec([None, 3, size, size]),
            (RESNET_BATCH, 7), lambda b: np.random.RandomState(b).randn(
                b, 3, size, size).astype("float32"), tmp)
        base = gpt.GPT_CONFIGS[gpt_cfg] if isinstance(gpt_cfg, str) \
            else gpt_cfg
        cfg = dataclasses.replace(base, num_layers=2, dtype="float32")
        paddle.seed(0)
        model = gpt.GPTForPretraining(cfg)
        model.eval()
        launches = _predictor_check(
            f"gpt 2 layers at {cfg.hidden_size} wide", model,
            paddle.static.InputSpec([None, seq], "int64"), (2, 3),
            lambda b: np.random.RandomState(b).randint(
                0, cfg.vocab_size, (b, seq)), tmp)
        print(f"port kernel launches in one loaded GPT run: {launches}")
        check(launches["flash_fwd"] == cfg.num_layers
              and sum(launches.values()) == cfg.num_layers,
              f"loaded GPT launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def static_program(smi):
    """(d) a ``static.nn.fc`` MLP recorded under ``enable_static`` and run
    by ``Executor`` on the card with the default passes, against the eager
    formula on the captured parameters (fp32, TF32 off)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    paddle.seed(0)
    paddle.enable_static()
    try:
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [None, 256], "float32")
            h = static.nn.fc(x, 1024, activation="relu")
            out = static.nn.fc(h, 10)
    finally:
        paddle.disable_static()
    params = [t for n in prog.ops for t in n.inputs
              if isinstance(t, paddle.Tensor)
              and not isinstance(t, static.Variable)]
    xs = np.random.RandomState(0).randn(64, 256).astype("float32")
    exe = static.Executor()
    got, = exe.run(prog, feed={"x": xs}, fetch_list=[out])
    w1, b1, w2, b2 = (p.numpy().astype(np.float64) for p in params)
    want = np.maximum(xs @ w1 + b1, 0) @ w2 + b2
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    print(f"static fc MLP ({len(prog.ops)} recorded ops) through Executor "
          f"with the default passes: worst abs err over the output's scale "
          f"{err:.3g} against the float64 formula (limit {LOADED_REL:g})")
    check(err <= LOADED_REL, f"static program err {err}")


def op_checks():
    """(e) ``torch.library.opcheck`` of every kernel op on CUDA inputs at
    a small shape: schema, autograd registration, fake implementation
    against the CUDA one, AOTAutograd with dynamic shapes."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_varlen as fv
    from paddle_tpu_torch.ops.cuda import library
    ops = library.ops()
    dev = "cuda"

    def r(*shape, seed=0, grad=False, dtype=torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=dtype).requires_grad_(grad)

    def qkv(grad, shape=(4, 128, 64)):
        return tuple(r(*shape, seed=i, grad=grad) for i in range(3))

    cu = torch.tensor([0, 100, 256, 300], dtype=torch.int32, device=dev)
    vplan = fv._plan_args(fv.varlen_plan(cu, cu, 300, 300, True))
    st = torch.randint(0, 128, (1, 1, 128, 1), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))
    fp = fv.flashmask_plan(st, 4, True)
    fplan = (fp.st, fp.en, fp.st_max, fp.en_min, fp.heads, fp.col_heads,
             fp.causal)
    fwd_args = {"flash_fwd": qkv(True) + (True, 0.125, 128, 0),
                "varlen_fwd": qkv(True, (300, 4, 64)) + vplan + (0.125,),
                "flashmask_fwd": qkv(True) + fplan + (0.125,)}
    cases = dict(fwd_args)
    for fwd, delta in (("flash_fwd", fa.attention_delta),
                       ("varlen_fwd", fv.varlen_delta),
                       ("flashmask_fwd", fa.attention_delta)):
        args = fwd_args[fwd]
        q, k, v = (t.detach() for t in args[:3])
        out, lse = ops[fwd](q, k, v, *args[3:])
        do = r(*out.shape, seed=7)
        bwd = (q, k, v, do, lse, delta(do, out)) + tuple(args[3:])
        prefix = fwd[:-len("fwd")]
        cases[prefix + "bwd_dkv"] = bwd
        cases[prefix + "bwd_dq"] = bwd
    cases["rms_norm"] = (r(64, 1024, grad=True), r(1024, seed=1, grad=True),
                         1e-6)
    cases["swiglu"] = (r(64, 2048, grad=True), None)
    for name in library.OP_NAMES:
        result = torch.library.opcheck(ops[name], cases[name])
        print(f"opcheck {name} (cuda, bf16): {result}")


def compile_path(smi):
    """Phase 19: the compile path on the card. Inductor's cache goes to a
    fresh directory for the phase (its first compile is cold) and is
    removed after."""
    import tempfile
    phase("19 the compile path")
    cache = tempfile.mkdtemp(prefix="inductor_")
    saved = {k: os.environ.get(k) for k in ("TORCHINDUCTOR_CACHE_DIR",
                                            "TRITON_CACHE_DIR")}
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    times = {}
    try:
        for label, run in (("(e) opcheck", op_checks),
                           ("(a) compiled gpt", lambda smi: compiled_gpt(
                               smi, layers=COMPILED_GPT_LAYERS,
                               persist_dir=PERSIST_DIR[0])),
                           ("(b) compiled resnet", compiled_resnet),
                           ("(c) saved programs", saved_programs),
                           ("(d) static program", static_program)):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            print(f"-- 19 {label}", flush=True)
            run() if run is op_checks else run(smi)
            times[label] = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(cache, ignore_errors=True)
    print("phase 19 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items()) + f" on {smi}")


# ------------------------------------------------------------ phase 20

# phase 19 (a)'s depth: inductor's cold compile of the 24-layer step took
# 108-259 s (63-77 s at 12 layers), and phases 20 and 21 came after it in
# the same 1200 s
COMPILED_GPT_LAYERS = 6

# phase 20 (a): the segment cap for the run. A gpt2-medium step records
# ~340 ops (14 a layer); the default cap (256, the reference's) would seal
# the forward twice, so the root's segment would take inputs from the
# first one and backward would leave the fused path
RT_CAP = 1024
RT_TURN_STEPS = 3       # timed steps a turn (after one warm-up a mode)
RT_SOT_LAYERS, RT_SOT_BATCH = 2, 2


def _rt_counts():
    """(executions, the thread's ambient context) now."""
    from paddle_tpu_torch._core import dispatch, lazy
    return dispatch.exec_count(), lazy.current_context()


def _rt_profile(step):
    """One step under ``torch.profiler``, after one warm-up step in the same
    trace (a late trace can lose its first device records; the warm-up
    step takes that loss): (device busy ms, kernels launched, wall ms) of
    the second step, whose records are the ones that start after a 5 ms
    pause between the two; None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
        time.sleep(0.005)
        with record_function("profiled step"):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    window = next(e for e in events if e.name == "profiled step"
                  and e.device_type == torch.autograd.DeviceType.CPU)
    since = window.time_range.start - 2500   # us: inside the pause
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.start >= since
               and e.name not in PHASES + ("profiled step",)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if busy <= 0:
        return None
    return busy, len(kernels), wall


def _rt_turns(label, steps, smi, turn_steps=RT_TURN_STEPS):
    """Times ``steps`` ({"on": step, "off": step}, fusion switched by the
    caller's step) in turns on, off, off, on, each turn ``turn_steps``
    synchronized steps after a warm-up of each mode; prints each turn's
    median and returns {mode: median of all its steps}."""
    from paddle_tpu_torch.framework import enable_eager_fusion
    for mode in ("on", "off"):
        enable_eager_fusion(mode == "on")
        steps[mode]()
        torch.cuda.synchronize()
    times = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        enable_eager_fusion(mode == "on")
        turn = []
        for _ in range(turn_steps):
            t0 = time.perf_counter()
            float(steps[mode]())
            torch.cuda.synchronize()
            turn.append((time.perf_counter() - t0) * 1e3)
        times[mode] += turn
        print(f"{label} turn fusion {mode}: {[round(v, 2) for v in turn]} "
              f"ms")
    enable_eager_fusion(False)
    med = {m: float(np.median(v)) for m, v in times.items()}
    print(f"{label}: fusion on {med['on']:.2f} ms/step, off "
          f"{med['off']:.2f} ms/step ({med['on'] / med['off']:.3f}x) in "
          f"turns on {smi}")
    return med


def _rt_gpt_pair(paddle, gpt, cfg):
    """Two eager gpt2-medium models from seed 0 with their AdamW (lr 1e-4)
    and phase 10's fixed batch: one for each mode, so each trains only
    under its own."""
    pair = []
    for _ in range(2):
        paddle.seed(0)
        model = gpt.GPTForPretraining(cfg)
        pair.append((model, paddle.optimizer.AdamW(
            1e-4, parameters=model.parameters())))
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    return pair, x, y


def runtime_gpt(smi):
    """Phase 20 (a): phase 10's eager gpt2-medium bf16 O1 step under the
    ambient window (``enable_eager_fusion(True)``) and with it off, each
    mode on its own copy of the model from seed 0: three losses and step
    1's gradients leaf by leaf, on against off (bit-equal: the same ops run
    in the same order); then a steady step's executions (the fused forward
    and backward, the update: at most 2, plus the loss read), segments,
    breaks and #1/#2/#3 launches (24 each) under the window; the runner
    caches flat over 5 steady steps; kernel launches a profiled step both
    ways (equal); ms/step in turns, tokens/s, idle share and peak memory
    of each mode."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import lazy
    from paddle_tpu_torch.framework import enable_eager_fusion
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    paddle.set_device("gpu")
    crit = gpt.GPTPretrainingCriterion()
    pair, x, y = _rt_gpt_pair(paddle, gpt, cfg)
    (m_on, o_on), (m_off, o_off) = pair
    del pair

    def run(model, opt, grads=None):
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(x), y)
        loss.backward()
        if grads is not None:
            grads.extend(p._t.grad.detach().clone()
                         for p in model.parameters())
        opt.step()
        opt.clear_grad()
        return loss

    def step(mode, grads=None):
        enable_eager_fusion(mode == "on")
        return run(*((m_on, o_on) if mode == "on" else (m_off, o_off)),
                   grads)

    old_cap = paddle.get_flags("FLAGS_lazy_max_segment_ops")
    paddle.set_flags({"FLAGS_lazy_max_segment_ops": RT_CAP})
    try:
        losses = {"on": [], "off": []}
        grads = {"on": [], "off": []}
        for i in range(3):
            for mode in ("on", "off"):
                loss = step(mode, grads[mode] if i == 0 else None)
                losses[mode].append(float(loss))
        enable_eager_fusion(False)
        names = [n for n, _ in m_on.named_parameters()]
        diffs = [(float((a.float() - b.float()).abs().max()), n)
                 for n, a, b in zip(names, grads["on"], grads["off"])]
        equal = all(torch.equal(a, b)
                    for a, b in zip(grads["on"], grads["off"]))
        worst = max(diffs)
        print(f"runtime gpt: losses fusion on {losses['on']}, off "
              f"{losses['off']}; step 1's gradients bit-equal over "
              f"{len(names)} leaves: {equal} (worst |on - off| "
              f"{worst[0]:.3g} at {worst[1]})")
        check(losses["on"] == losses["off"],
              f"fusion-on losses {losses['on']} != off {losses['off']}")
        check(equal, f"fusion-on gradients differ from off: worst "
              f"{worst}")
        del grads

        # a steady step's counts under the window
        enable_eager_fusion(True)
        ctx = lazy.current_context()
        caches0 = (len(lazy._SEG_CACHE), len(lazy._FUSED_CACHE),
                   len(lazy._AVAL_CACHE))
        fa.reset_launches()
        n0, _ = _rt_counts()
        s0, b0, r0 = ctx.segments_run, len(ctx.breaks), ctx.ops_recorded
        float(run(m_on, o_on))
        n1, _ = _rt_counts()
        launches = dict(fa.LAUNCHES)
        execs, segs = n1 - n0, ctx.segments_run - s0
        print(f"runtime gpt: a steady step under the window: {execs} "
              f"executions (segments {segs}: {ctx.breaks[b0:]}, the update "
              f"1, the loss read {'0' if execs <= 2 else 'the rest'}), "
              f"{ctx.ops_recorded - r0} ops recorded, launches {launches}")
        check(execs <= 3, f"{execs} executions a steady step (want <= 2 "
              f"plus the loss read)")
        check(ctx.breaks[b0:] == ["backward_fused"],
              f"breaks of a steady step {ctx.breaks[b0:]}")
        for name in fa.LAUNCHES:
            check(launches[name] == cfg.num_layers,
                  f"{name} launched {launches[name]} times a windowed "
                  f"step, want {cfg.num_layers}")
        for _ in range(5):
            float(run(m_on, o_on))
        caches1 = (len(lazy._SEG_CACHE), len(lazy._FUSED_CACHE),
                   len(lazy._AVAL_CACHE))
        print(f"runtime gpt: runner caches (segment, fused step, "
              f"metadata) {caches0} before 5 steady steps, {caches1} "
              f"after; fast-path ops {lazy.FAST_OPS}, step plans "
              f"{lazy.REPLAY_STEPS}")
        check(caches1 == caches0, f"caches grew {caches0} -> {caches1}")

        # kernel launches of a profiled step, both ways (one read each)
        counts, prof = {}, {}
        for mode in ("on", "off"):
            got = _rt_profile(lambda: float(step(mode)))
            if got is not None:
                counts[mode], prof[mode] = got[1], got
        enable_eager_fusion(False)
        print(f"runtime gpt: kernels launched in a profiled step: fusion "
              f"on {counts.get('on')}, off {counts.get('off')}")
        if counts:
            check(counts.get("on") == counts.get("off"),
                  f"kernel launches a step differ: {counts}")

        med = _rt_turns("runtime gpt2-medium b8 s1024 bf16 O1 AdamW",
                        {"on": lambda: run(m_on, o_on),
                         "off": lambda: run(m_off, o_off)}, smi)
        peak = {}
        for mode in ("on", "off"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            float(step(mode))
            torch.cuda.synchronize()
            peak[mode] = torch.cuda.max_memory_allocated()
        enable_eager_fusion(False)
        for mode in ("on", "off"):
            busy = prof[mode][0] if mode in prof else float("nan")
            print(f"runtime gpt fusion {mode}: {med[mode]:.2f} ms/step, "
                  f"{BATCH * SEQ / (med[mode] / 1e3):.1f} tokens/s, device "
                  f"busy {busy:.1f} ms, idle share "
                  f"{max(0.0, 1 - busy / med[mode]):.3f}, peak memory "
                  f"{peak[mode] / 2**30:.2f} GiB on {smi}")
        check(all(math.isfinite(v) for v in losses["on"]), "losses")

        # phase 10's fp16 step with a GradScaler under the window: its
        # unscale_ reads one value a parameter to the host (292 reads)
        scaler = paddle.amp.GradScaler()
        enable_eager_fusion(True)
        n0, ctx = _rt_counts()
        s0, b0 = ctx.segments_run, len(ctx.breaks)
        with paddle.amp.auto_cast(level="O1", dtype="float16"):
            loss = crit(m_on(x), y)
        scaler.scale(loss).backward()
        scaler.step(o_on)
        scaler.update()
        o_on.clear_grad()
        fp16_loss = float(loss)
        n1, _ = _rt_counts()
        enable_eager_fusion(False)
        print(f"runtime gpt fp16 O1 with a GradScaler under the window: "
              f"loss {fp16_loss:.5f}, {n1 - n0} executions, "
              f"{ctx.segments_run - s0} segments ({ctx.breaks[b0:]}); "
              f"unscale_ reads its {len(names)} gradients to the host "
              f"outside any segment")
        check(math.isfinite(fp16_loss) and n1 - n0 <= 3,
              f"fp16 windowed step: loss {fp16_loss}, {n1 - n0} executions")
    finally:
        enable_eager_fusion(False)
        paddle.set_flags({"FLAGS_lazy_max_segment_ops": old_cap[
            "FLAGS_lazy_max_segment_ops"]})
    return med


def runtime_host_bound(smi):
    """Phase 20 (b): phase 14's Transformer-base and PTB LSTM under the
    window and off, in turns (one model each, trained by both modes):
    ms/step, idle share of a profiled step, and the window's executions
    and segments a step (the recording cost the CUDA-graph PR must
    recover)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import enable_eager_fusion
    out = {}
    for label, build in (("transformer-base", _tb_build),
                         ("ptb large LSTM", _ptb_build)):
        torch.cuda.empty_cache()
        _, step, _ = build(paddle)
        enable_eager_fusion(True)
        float(step())
        n0, ctx = _rt_counts()
        s0 = ctx.segments_run
        float(step())
        n1, _ = _rt_counts()
        reasons = {}
        for r in ctx.breaks[-(ctx.segments_run - s0):] \
                if ctx.segments_run > s0 else []:
            reasons[r] = reasons.get(r, 0) + 1
        print(f"{label} under the window: {n1 - n0} executions a step, "
              f"{ctx.segments_run - s0} segments ({reasons})")
        med = _rt_turns(label, {"on": step, "off": step}, smi,
                        turn_steps=2)
        for mode in ("on", "off"):
            enable_eager_fusion(mode == "on")
            got = _rt_profile(lambda: float(step()))
            if got is not None:
                print(f"{label} fusion {mode}: device busy {got[0]:.1f} ms "
                      f"of {med[mode]:.2f} ms/step, idle share "
                      f"{max(0.0, 1 - got[0] / med[mode]):.3f}, "
                      f"{got[1]} kernels")
        enable_eager_fusion(False)
        out[label] = med
    return out


def runtime_sot(smi):
    """Phase 20 (c): ``to_static(full_graph=False)`` (SOT) of a 2-layer GPT
    at gpt2-medium's width, bf16 parameters, b2 s1024, no grad: a loss
    function that captures clean (its second call takes the guarded fast
    path, the segment compiled by inductor with #1 inside the graph) and
    one with a ``print`` of a value inside (two segments, no fast path),
    each against the eager function."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit.sot import sot_stats
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    cfg = dataclasses.replace(gpt.GPT_CONFIGS["gpt2-medium"],
                              num_layers=RT_SOT_LAYERS)
    paddle.set_device("gpu")
    paddle.seed(0)
    model = gpt.GPTForPretraining(cfg)
    model.astype("bfloat16")
    model.eval()
    crit = gpt.GPTPretrainingCriterion()
    rng = np.random.RandomState(2)
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size,
                                     (RT_SOT_BATCH, SEQ)))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size,
                                     (RT_SOT_BATCH, SEQ)))
    # the positions come in as an argument: a tensor the function made
    # itself from host values would be a constant the fast path cannot
    # re-fetch, and the capture would install no entry
    pos = paddle.arange(SEQ, dtype="int64")

    def clean(m, a, p, b):
        return crit(m(a, p), b)

    def broken(m, a, p, b):
        logits = m(a, p)
        print(f"runtime sot: mean logit inside the function "
              f"{float(logits.astype('float32').mean()):.6f}")
        return crit(logits, b)

    with paddle.no_grad():
        want = float(clean(model, x, pos, y))
        sfn = paddle.jit.to_static(clean, full_graph=False)
        t0 = time.perf_counter()
        first = float(sfn(model, x, pos, y))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = float(sfn(model, x, pos, y))
        compile_s = time.perf_counter() - t0
        fa.reset_launches()
        t0 = time.perf_counter()
        fast = float(sfn(model, x, pos, y))
        torch.cuda.synchronize()
        fast_s = time.perf_counter() - t0
        launched = fa.LAUNCHES["flash_fwd"]
        st = sot_stats(sfn)
        entry = sfn._entries[0] if sfn._entries else None
        graphs = entry.segment.graphs if entry is not None else []
        in_graph = sum(
            1 for _, gm in graphs for node in gm.graph.nodes
            if "flash_fwd" in str(node.target))
        print(f"runtime sot clean: eager loss {want:.6f}, first call "
              f"{first:.6f} ({first_s:.2f} s: the bytecode capture), "
              f"second {compiled:.6f} ({compile_s:.1f} s: the fast path's "
              f"trace and inductor's compile), third {fast:.6f} "
              f"({fast_s * 1e3:.1f} ms); stats {st}; #1 nodes in the "
              f"compiled graphs {in_graph}, #1 launched by the third call "
              f"{launched}")
        check(st["captures"] == 1 and st["fast_hits"] == 2,
              f"sot clean capture stats {st}")
        check(in_graph >= RT_SOT_LAYERS and launched == RT_SOT_LAYERS,
              f"#1 not inside the compiled graph: {in_graph} nodes, "
              f"{launched} launches")
        for got in (first, compiled, fast):
            check(abs(got - want) <= 1e-2 * abs(want),
                  f"sot clean loss {got} against eager {want}")
        bfn = paddle.jit.to_static(broken, full_graph=False)
        got = float(bfn(model, x, pos, y))
        want_b = float(broken(model, x, pos, y))
        st = sot_stats(bfn)
        print(f"runtime sot with a print: loss {got:.6f} against eager "
              f"{want_b:.6f}; breaks {st['breaks']} on {smi}")
        check(any(len(b) >= 2 for b in st["breaks"]),
              f"the print did not break the capture: {st['breaks']}")
        check(abs(got - want_b) <= 1e-2 * abs(want_b),
              f"sot broken loss {got} against eager {want_b}")
    return first_s + compile_s


def steady_state_path(smi):
    """Phase 20: the steady-state runtime on the card: (a) the eager
    gpt2-medium step under the window against off, (b) the host-bound
    models of phase 14 both ways, (c) SOT's ``to_static(full_graph=
    False)``. Inductor's cache for (c) goes to a fresh directory."""
    import tempfile
    phase("20 the steady-state runtime")
    cache = tempfile.mkdtemp(prefix="inductor_")
    saved = {k: os.environ.get(k) for k in ("TORCHINDUCTOR_CACHE_DIR",
                                            "TRITON_CACHE_DIR")}
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    times = {}
    try:
        for label, run in (("(a) runtime gpt", runtime_gpt),
                           ("(b) host-bound models", runtime_host_bound),
                           ("(c) sot", runtime_sot)):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            print(f"-- 20 {label}", flush=True)
            run(smi)
            times[label] = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(cache, ignore_errors=True)
    print("phase 20 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items()) + f" on {smi}")


# ------------------------------------------------------------ phase 21

NATIVE_WATCHDOG_S = 420
NATIVE_TURN_STEPS = 3
PERSIST_STEPS = 3
# phase 19 (a) stores its traced graph here (made by main, removed after
# phase 21 (b)); phase 19 (a)'s first step's seconds, losses and counts
PERSIST_DIR = [None]
PERSIST = {}


def _use_prong(native_on, core):
    """The lazy window's native prong (``core``) or its Python prong."""
    from paddle_tpu_torch._core import lazy
    lazy._drive_retire()
    lazy._NC, lazy._NC_TRIED = (core if native_on else None), True
    lazy._DRIVE_OK = native_on


class _RecordClock:
    """Host time from a step's start to its ``backward()`` call: under the
    window, the forward only records (``ms``, per step)."""

    def __enter__(self):
        from paddle_tpu_torch._core import autograd
        self._mod, self._inner = autograd, autograd.backward
        self.entered = None
        inner = self._inner

        def timed(*a, **k):
            if self.entered is None:
                self.entered = time.perf_counter()
            return inner(*a, **k)
        autograd.backward = timed
        return self

    def step(self, fn):
        """Runs ``fn()`` to a synchronize: (its result, wall ms, record
        ms)."""
        self.entered = None
        t0 = time.perf_counter()
        out = fn()
        float(out)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec = (self.entered or t1) - t0
        return out, (t1 - t0) * 1e3, rec * 1e3

    def __exit__(self, *exc):
        self._mod.backward = self._inner


class _DrivenOps:
    """Ops the whole-step driver recorded inside the block."""

    def __enter__(self):
        from paddle_tpu_torch._core import dispatch
        self.n, self._d, self._inner = 0, dispatch, dispatch.NC_DRIVE
        inner = self._inner

        def counted(*a):
            out = inner(*a)
            self.n += out is not None
            return out
        dispatch.NC_DRIVE = counted
        return self

    def __exit__(self, *exc):
        self._d.NC_DRIVE = self._inner


def _prong_turns(label, steps, smi, turn_steps=NATIVE_TURN_STEPS):
    """``steps`` ({"native": step, "python": step}) in turns native,
    python, python, native after a warm-up of each: each turn's ms, and
    {mode: (median ms/step, median record ms)}."""
    ms = {"native": [], "python": []}
    rec = {"native": [], "python": []}
    with _RecordClock() as clock:
        for mode in ("native", "python"):
            clock.step(steps[mode])
        for mode in ("native", "python", "python", "native"):
            turn = []
            for _ in range(turn_steps):
                _, dt, r = clock.step(steps[mode])
                turn.append(dt)
                rec[mode].append(r)
            ms[mode] += turn
            print(f"{label} turn {mode}: {[round(v, 2) for v in turn]} ms")
    med = {m: (float(np.median(ms[m])), float(np.median(rec[m])))
           for m in ms}
    print(f"{label}: native {med['native'][0]:.2f} ms/step (recording "
          f"{med['native'][1]:.2f} ms of host time), python "
          f"{med['python'][0]:.2f} ms/step (recording "
          f"{med['python'][1]:.2f} ms); native / python "
          f"{med['native'][0] / med['python'][0]:.3f}x in turns on {smi}")
    return med


def _steady_counts(label, step):
    """One steady step's executions, driven ops, FAST_OPS, REPLAY_STEPS
    and recorded ops."""
    from paddle_tpu_torch._core import dispatch, lazy
    ctx = lazy.current_context()
    n0, f0, r0 = dispatch.exec_count(), lazy.FAST_OPS, lazy.REPLAY_STEPS
    o0 = ctx.ops_recorded
    with _DrivenOps() as driven:
        float(step())
    got = dict(execs=dispatch.exec_count() - n0, driven=driven.n,
               fast=lazy.FAST_OPS - f0, replay=lazy.REPLAY_STEPS - r0,
               recorded=ctx.ops_recorded - o0)
    print(f"{label}: a steady step: {got['execs']} executions, "
          f"{got['recorded']} ops recorded, {got['fast']} of them on the "
          f"fast path ({got['driven']} by the whole-step driver), "
          f"REPLAY_STEPS +{got['replay']}")
    return got


def native_gpt(smi, core):
    """Phase 21 (a): phase 20 (a)'s step under the window, native prong
    against Python prong, each on its own model from seed 0."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import enable_eager_fusion
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    paddle.set_device("gpu")
    crit = gpt.GPTPretrainingCriterion()
    pair, x, y = _rt_gpt_pair(paddle, gpt, cfg)
    models = {"native": pair[0], "python": pair[1]}
    del pair

    def run(model, opt, grads=None):
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(x), y)
        loss.backward()
        if grads is not None:
            grads.extend(p._t.grad.detach().clone()
                         for p in model.parameters())
        opt.step()
        opt.clear_grad()
        return loss

    def step(mode, grads=None):
        _use_prong(mode == "native", core)
        return run(*models[mode], grads)

    old_cap = paddle.get_flags("FLAGS_lazy_max_segment_ops")
    paddle.set_flags({"FLAGS_lazy_max_segment_ops": RT_CAP})
    enable_eager_fusion(True)
    try:
        losses = {"native": [], "python": []}
        grads = {"native": [], "python": []}
        for i in range(6):   # 3 compared, then to the step plan
            for mode in ("native", "python"):
                loss = step(mode, grads[mode] if i == 0 else None)
                if i < 3:
                    losses[mode].append(float(loss))
        equal = all(torch.equal(a, b) for a, b in
                    zip(grads["native"], grads["python"]))
        print(f"native gpt: losses native {losses['native']}, python "
              f"{losses['python']}; step 1's gradients bit-equal over "
              f"{len(grads['native'])} leaves: {equal}")
        check(losses["native"] == losses["python"],
              f"native losses {losses['native']} != python "
              f"{losses['python']}")
        check(equal, "native gradients differ from python's")
        del grads
        counts = {m: _steady_counts(f"native gpt {m}",
                                    lambda m=m: step(m))
                  for m in ("native", "python")}
        for key in ("execs", "fast", "replay", "recorded"):
            check(counts["native"][key] == counts["python"][key],
                  f"{key} differ: {counts}")
        check(counts["native"]["execs"] == 2, f"executions {counts}")
        check(counts["native"]["driven"] > 0
              and counts["python"]["driven"] == 0,
              f"driven ops {counts}")
        check(counts["native"]["replay"] == 1, f"step plans {counts}")
        kernels, prof = {}, {}
        for mode in ("native", "python"):
            got = _rt_profile(lambda: float(step(mode)))
            if got is not None:
                kernels[mode], prof[mode] = got[1], got
        print(f"native gpt: kernels launched in a profiled step: native "
              f"{kernels.get('native')}, python {kernels.get('python')}")
        if kernels:
            check(kernels.get("native") == kernels.get("python"),
                  f"kernel launches a step differ: {kernels}")
        med = _prong_turns("native gpt2-medium b8 s1024 bf16 O1 AdamW",
                           {m: (lambda m=m: step(m))
                            for m in ("native", "python")}, smi)
        for mode in ("native", "python"):
            idle = "not measured" if mode not in prof else \
                f"{max(0.0, 1 - prof[mode][0] / med[mode][0]):.3f}"
            busy = "not measured" if mode not in prof else \
                f"{prof[mode][0]:.1f} ms"
            print(f"native gpt {mode}: {med[mode][0]:.2f} ms/step, "
                  f"recording {med[mode][1]:.2f} ms, device busy {busy}, "
                  f"idle share {idle} on {smi}")
    finally:
        enable_eager_fusion(False)
        _use_prong(True, core)
        paddle.set_flags({"FLAGS_lazy_max_segment_ops": old_cap[
            "FLAGS_lazy_max_segment_ops"]})


def native_host_bound(smi, core):
    """Phase 21 (a), continued: phase 14's Transformer-base and PTB LSTM
    under the window, one model each trained by both prongs in turns."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import enable_eager_fusion
    for label, build in (("transformer-base", _tb_build),
                         ("ptb large LSTM", _ptb_build)):
        torch.cuda.empty_cache()
        _, step, _ = build(paddle)
        enable_eager_fusion(True)
        try:
            for mode in ("native", "python") * 3:
                _use_prong(mode == "native", core)
                float(step())
            counts = {}
            for mode in ("native", "python"):
                _use_prong(mode == "native", core)
                counts[mode] = _steady_counts(f"{label} {mode}", step)
            check(counts["native"]["execs"] == counts["python"]["execs"]
                  and counts["native"]["fast"] == counts["python"]["fast"],
                  f"{label} counts differ: {counts}")

            def prong_step(mode):
                _use_prong(mode == "native", core)
                return step()
            med = _prong_turns(label, {m: (lambda m=m: prong_step(m))
                                       for m in ("native", "python")}, smi,
                               turn_steps=2)
            for mode in ("native", "python"):
                got = _rt_profile(lambda: float(prong_step(mode)))
                if got is not None:
                    print(f"{label} {mode}: device busy {got[0]:.1f} ms of "
                          f"{med[mode][0]:.2f} ms/step, idle share "
                          f"{max(0.0, 1 - got[0] / med[mode][0]):.3f}, "
                          f"{got[1]} kernels, recording "
                          f"{med[mode][1]:.2f} ms")
        finally:
            enable_eager_fusion(False)
            _use_prong(True, core)


def _persist_run(paddle, gpt, cfg, x, y):
    """Phase 19 (a)'s compiled GPT from seed 0, ``PERSIST_STEPS`` steps:
    its first step's seconds, the losses, and its forward's cache entry."""
    paddle.seed(0)
    model = paddle.jit.to_static(gpt.GPTForPretraining(cfg))
    crit = gpt.GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
    losses = []
    t0 = time.perf_counter()
    for i in range(PERSIST_STEPS):
        losses.append(float(_eager_step(paddle, model, crit, opt, x, y,
                                         "bfloat16")))
        if i == 0:
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
    return first_s, losses, next(iter(model.forward._fwd_cache.values()))


def persist_child(cache):
    """``chip_smoke.py --persist-child <dir>``: phase 19 (a)'s compiled
    GPT warm-started from ``<dir>``; then the stored entry corrupted and
    the same model built and run again in this process (the load rejects
    it and traces). Prints one JSON line: for each run its first step's
    seconds, losses, traces, loads and the cache's counts, and inductor's
    cache counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import persist
    from paddle_tpu_torch.models import gpt
    from torch._dynamo.utils import counters
    torch.backends.cuda.matmul.allow_tf32 = False   # as card() sets it
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_flags({"FLAGS_executable_cache_dir": cache})
    cfg = dataclasses.replace(gpt.GPT_CONFIGS["gpt2-medium"],
                              num_layers=COMPILED_GPT_LAYERS)
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
    out = {}
    for run in ("warm", "corrupt"):
        if run == "corrupt":
            entries = [f for f in os.listdir(cache) if f.endswith(".ptxc")]
            path = os.path.join(cache, entries[0])
            with open(path, "rb") as f:
                body = bytearray(f.read())
            body[len(body) // 2] ^= 0xFF
            with open(path, "wb") as f:
                f.write(body)
        before = persist.counters()
        first_s, losses, entry = _persist_run(paddle, gpt, cfg, x, y)
        out[run] = {"first_s": first_s, "losses": losses,
                    "traces": entry.traces, "loads": entry.loads,
                    "persist": {k: v - before[k] for k, v in
                                persist.counters().items()},
                    "inductor": {k: v for k, v in {
                        **counters["inductor"],
                        **counters["aot_autograd"]}.items()
                        if "cache" in k}}
    print(json.dumps(out))
    return 0


def persist_path(smi):
    """Phase 21 (b): a child process warm-starts phase 19 (a)'s compiled
    GPT from the directory phase 19 (a) stored into, then corrupts the
    entry and runs the model again (a reject and a new trace)."""
    cache = PERSIST.get("dir")
    check(cache is not None and "first_s" in PERSIST,
          "phase 19 (a) stored nothing to warm-start from")
    entries = sorted(f for f in os.listdir(cache) if f.endswith(".ptxc"))
    print(f"persist: phase 19 (a) (cold, {COMPILED_GPT_LAYERS} layers): "
          f"first step {PERSIST['first_s']:.1f} s, losses "
          f"{PERSIST['losses']}, counts {PERSIST.get('cache.persist.store')}"
          f" stored, {PERSIST.get('cache.persist.miss')} missed; entries "
          f"{entries}")
    check(len(entries) == 1, f"entries {entries}")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--persist-child", cache], capture_output=True,
                          text=True, timeout=NATIVE_WATCHDOG_S)
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-3000:])
    check(proc.returncode == 0, f"the child exited {proc.returncode}")
    got = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    warm, bad = got["warm"], got["corrupt"]
    print(f"persist warm child: first step {warm['first_s']:.1f} s "
          f"against {PERSIST['first_s']:.1f} s cold, traces "
          f"{warm['traces']}, loads {warm['loads']}, counts "
          f"{warm['persist']}, inductor {warm['inductor']}, losses "
          f"{warm['losses']} (cold {PERSIST['losses']}, bit-equal: "
          f"{warm['losses'] == PERSIST['losses']})")
    check(warm["persist"]["cache.persist.hit"] == 1 and warm["traces"] == 0,
          f"the warm child did not load: {warm}")
    if warm["losses"] != PERSIST["losses"]:
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(warm["losses"], PERSIST["losses"]))
        print(f"persist: warm losses {rel:.3g} relative from cold")
        check(rel <= COMPILE_LOSS_REL, f"warm losses off by {rel}")
    print(f"persist, the same child after corrupting its entry: first step "
          f"{bad['first_s']:.1f} s, traces {bad['traces']}, counts "
          f"{bad['persist']}, losses {bad['losses']} (bit-equal to the "
          f"warm run: {bad['losses'] == warm['losses']}) on {smi}")
    check(bad["persist"]["cache.persist.reject"] == 1
          and bad["persist"]["cache.persist.store"] == 1
          and bad["traces"] == 1, f"the corrupt entry was not rejected: "
          f"{bad}")
    check(bad["losses"] == warm["losses"] or max(
        abs(a - b) / abs(b) for a, b in zip(bad["losses"], warm["losses"]))
        <= COMPILE_LOSS_REL, f"losses after the reject {bad['losses']}")


def _comm_entries(paddle, D):
    """Each communication entry once on a CUDA tensor of the one-rank
    group, against its value there (the identity, as the reference's)."""
    def t(v):
        return paddle.to_tensor(np.asarray(v, "float32"))
    base = np.arange(6, dtype="float32").reshape(2, 3) + 1
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        x = t(base)
        D.all_reduce(x, op=op)
        out[f"all_reduce {op}"] = (x, base)
    x = t(base)
    D.broadcast(x, src=0)
    out["broadcast"] = (x, base)
    x = t(base)
    D.reduce(x, dst=0)
    out["reduce"] = (x, base)
    x = t(np.zeros(3))
    D.reduce_scatter(x, [t([4, 5, 6])])
    out["reduce_scatter"] = (x, np.array([4, 5, 6], "float32"))
    x = t(np.zeros(3))
    D.scatter(x, [t([7, 8, 9])], src=0)
    out["scatter"] = (x, np.array([7, 8, 9], "float32"))
    got = D.all_gather([], t(base))
    out["all_gather"] = (got[0], base)
    got = D.gather(t(base), [], dst=0)
    out["gather"] = (got[0], base)
    got = D.alltoall([], [t(base)])
    out["alltoall"] = (got[0], base)
    x = t(base)
    D.stream.all_reduce(x)
    D.wait(x)
    out["stream.all_reduce + wait"] = (x, base)
    ok = {}
    for name, (got, want) in out.items():
        ok[name] = got._t.is_cuda and bool(np.array_equal(got.numpy(), want))
    ok["all_gather_object"] = D.all_gather_object([], {"a": 1}) == [{"a": 1}]
    ok["broadcast_object_list"] = D.broadcast_object_list([3, "b"]) \
        == [3, "b"]
    D.barrier()
    ok["barrier"] = True
    for fn in (D.send, D.recv, D.isend, D.irecv):
        try:
            fn(t(base), 0)
            ok[fn.__name__ + " raises"] = False
        except RuntimeError:
            ok[fn.__name__ + " raises"] = True
    ok["get_backend NCCL"] = D.get_backend() == "NCCL"
    return ok


def data_parallel_path(smi):
    """Phase 21 (c): phase 10's eager step through ``DataParallel`` on a
    one-rank NCCL group against the step itself."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import gpt
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    D.init_parallel_env(f"tcp://127.0.0.1:{_free_port()}", rank=0,
                        world_size=1)
    try:
        cfg = gpt.GPT_CONFIGS["gpt2-medium"]
        paddle.set_device("gpu")
        rng = np.random.RandomState(0)
        x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
        y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
        crit = gpt.GPTPretrainingCriterion()
        runs = {}
        for name in ("plain", "dp"):
            paddle.seed(0)
            model = gpt.GPTForPretraining(cfg)
            wrapped = D.DataParallel(model) if name == "dp" else model
            runs[name] = (wrapped, model, paddle.optimizer.AdamW(
                1e-4, parameters=model.parameters()))

        def step(name):
            wrapped, _, opt = runs[name]
            return _eager_step(paddle, wrapped, crit, opt, x, y, "bfloat16")

        losses, grads = {"plain": [], "dp": []}, {}
        for name in ("plain", "dp"):
            _, model, opt = runs[name]
            loss, grads[name] = _step_grads(opt, list(model.parameters()),
                                            lambda: step(name))
            losses[name].append(float(loss))
        equal = all(torch.equal(a, b) for a, b in
                    zip(grads["plain"], grads["dp"]))
        del grads
        for _ in range(2):
            for name in ("plain", "dp"):
                losses[name].append(float(step(name)))
        dp = runs["dp"][0]
        print(f"data parallel (one-rank NCCL group): losses {losses['dp']} "
              f"against phase 10's step {losses['plain']}; step 1's "
              f"gradients bit-equal: {equal}; a step's reducer: "
              f"{dp.last_buckets} buckets of {dp._bucket_bytes / 2**20:.0f} "
              f"MB, {dp.last_collectives} collectives (1 gloo over host "
              f"flags, {dp.last_buckets} NCCL all_reduce)")
        check(losses["dp"] == losses["plain"], f"losses {losses}")
        check(equal, "DataParallel gradients differ from phase 10's")
        check(dp.last_buckets > 1 and dp.last_collectives
              == dp.last_buckets + 1, f"buckets {dp.last_buckets}")
        ms = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            float(step(name))
            torch.cuda.synchronize()
            ms[name] += _turns(lambda *_: step(name), None, None, None,
                               NATIVE_TURN_STEPS)
        med = {k: float(np.median(v)) for k, v in ms.items()}
        print(f"data parallel: {med['dp']:.2f} ms/step against phase 10's "
              f"step {med['plain']:.2f} ({med['dp'] / med['plain']:.3f}x) "
              f"in turns on {smi}")
        del runs, dp
        torch.cuda.empty_cache()
        ok = _comm_entries(paddle, D)
        print(f"communication entries on a CUDA tensor at world size 1: "
              f"{ok}")
        check(all(ok.values()), f"communication entries {ok}")
    finally:
        D.destroy_process_group()


def native_runtime_path(smi):
    """Phase 21: the native record core and driver (a), the persistent
    compile cache (b), DataParallel and the communication API (c)."""
    from paddle_tpu_torch._core import lazy, native
    phase("21 the native runtime and eager communication")
    times = {}
    try:
        t0 = time.perf_counter()
        core = lazy._NC if lazy._NC_TRIED else lazy._native_core()
        check(core is not None and lazy._DRIVE_OK,
              f"native record core: {native.EAGER_CORE_ERROR}")
        print(f"native record core: {core.__file__} ({native.RUNTIME_SO} "
              f"beside it) in {time.perf_counter() - t0:.1f} s")
        for label, run in (("(a) native gpt", lambda: native_gpt(smi, core)),
                           ("(a) host-bound models",
                            lambda: native_host_bound(smi, core)),
                           ("(b) persist", lambda: persist_path(smi)),
                           ("(c) data parallel",
                            lambda: data_parallel_path(smi))):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            print(f"-- 21 {label}", flush=True)
            run()
            times[label] = time.perf_counter() - t0
    finally:
        if PERSIST_DIR[0] is not None:
            shutil.rmtree(PERSIST_DIR[0], ignore_errors=True)
    print("phase 21 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items()) + f" on {smi}")


FLEET_WATCHDOG_S = 300
FLEET_TURN_STEPS = 4   # timed steps a turn (after one warm-up)


def _collectives_now():
    """Collectives issued so far by the port's distributed wrappers."""
    from paddle_tpu_torch.distributed import _collectives as C
    return sum(C.CALLS.values())


class _Stepper:
    """What ``_eager_step`` steps: ``step`` and ``clear_grad``."""

    def __init__(self, step, clear_grad):
        self.step, self.clear_grad = step, clear_grad


def _state_bytes(opt):
    return sum(v.numel() * v.element_size() for st in opt._states.values()
               for v in st.values())


def _param_bytes(model):
    return sum(p._t.numel() * p._t.element_size()
               for p in model.parameters())


def _fleet_wrappers(paddle, fleet, sharding, hcg):
    """Label -> (clip, make): ``make(model, opt)`` wraps phase 10's model
    and its AdamW and returns what the step calls (net, stepper) and what
    to read (state bytes, parameter bytes, a description)."""
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        HybridParallelOptimizer
    group = hcg.get_sharding_parallel_group()

    def fleet_api(model, opt):
        net = fleet.distributed_model(model)
        hopt = fleet.distributed_optimizer(opt)
        check(net is model and isinstance(hopt, HybridParallelOptimizer)
              and isinstance(opt._grad_clip, paddle.nn.ClipGradByGlobalNorm),
              f"single mode wrapped {type(net).__name__}, "
              f"{type(hopt).__name__}, clip {type(opt._grad_clip).__name__}")
        return net, hopt, lambda: _state_bytes(opt), \
            lambda: _param_bytes(model), "HybridParallelOptimizer"

    def zero2(offload):
        def make(model, opt):
            z = sharding.DygraphShardingOptimizer(opt, group,
                                                  offload=offload)
            return model, z, z.state_bytes, lambda: _param_bytes(model), \
                f"DygraphShardingOptimizer(offload={offload})"
        return make

    def zero3(model, opt):
        z3 = sharding.DygraphShardingStage3(model, opt, group)
        return z3, _Stepper(z3.step_and_release, opt.clear_grad), \
            z3.sharded_optimizer.state_bytes, z3.param_bytes, \
            "DygraphShardingStage3"

    def grouped(level):
        def make(model, opt):
            net, opt2, _ = sharding.group_sharded_parallel(model, opt, level)
            eager = getattr(opt2, "_zero", None) is not None \
                or getattr(net, "_group", None) is not None
            check(not eager, f"{level} at one rank ran the eager classes")
            return net, opt2, lambda: _state_bytes(opt), \
                lambda: _param_bytes(model), \
                f"{type(net).__name__} + {type(opt2).__name__} (pass-through)"
        return make

    return {"(a) fleet": (True, fleet_api),
            "(b) zero os_g": (False, zero2(False)),
            "(c) zero offload": (False, zero2(True)),
            "(d) zero stage3": (False, zero3),
            "(e) group_sharded os_g": (False, grouped("os_g")),
            "(e) group_sharded p_g_os": (False, grouped("p_g_os"))}


def fleet_pair(smi, label, clip, make, x, y, crit):
    """Phase 10's step through one wrapper of phase 22 against the plain
    step, each on its own model from seed 0."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    runs = {}
    for name in ("plain", label):
        paddle.seed(0)
        model = gpt.GPTForPretraining(cfg)
        opt = paddle.optimizer.AdamW(
            1e-4, parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0) if clip else None)
        if name == "plain":
            runs[name] = (model, opt, lambda o=opt: _state_bytes(o),
                          lambda m=model: _param_bytes(m), "AdamW",
                          model, opt)
        else:
            runs[name] = make(model, opt) + (model, opt)

    def step(name):
        net, stepper = runs[name][:2]
        return _eager_step(paddle, net, crit, stepper, x, y, "bfloat16")

    losses, grads, colls, launches = {}, {}, {}, {}
    for name in runs:
        model, opt = runs[name][5:]
        _reset_all_launches()
        before = _collectives_now()
        loss, grads[name] = _step_grads(opt, list(model.parameters()),
                                        lambda: step(name))
        losses[name] = [float(loss)]
        colls[name] = _collectives_now() - before
        launches[name] = _all_launches()
    equal = all(torch.equal(a, b) for a, b in
                zip(grads["plain"], grads[label]))
    n_leaves = len(grads[label])
    del grads
    for _ in range(2):
        for name in runs:
            losses[name].append(float(step(name)))
    nbytes = {name: (r[2](), r[3]()) for name, r in runs.items()}
    print(f"fleet {label} ({runs[label][4]}): losses {losses[label]} "
          f"against the plain step's {losses['plain']}; step 1's gradients "
          f"bit-equal over {n_leaves} leaves: {equal}; collectives a step "
          f"{colls[label]} (plain {colls['plain']}); state bytes "
          f"{nbytes[label][0]} against {nbytes['plain'][0]}, parameter "
          f"bytes {nbytes[label][1]} against {nbytes['plain'][1]}; "
          f"launches a step {launches[label]}")
    check(losses[label] == losses["plain"], f"{label} losses {losses}")
    check(equal, f"{label}: step 1's gradients differ from the plain step's")
    want = {k: cfg.num_layers if k in fa.LAUNCHES else 0
            for k in launches["plain"]}
    for name in runs:
        check(launches[name] == want, f"{label} {name} launches "
              f"{launches[name]}, want {want}")
    model, opt = runs[label][5:]
    if "offload" in label:
        devs = {v.device.type for st in opt._states.values()
                for v in st.values()}
        check(devs == {"cpu"} and all(p._t.is_cuda
                                      for p in model.parameters()),
              f"offloaded states on {devs}")
    ms = {name: [] for name in runs}
    for name in ("plain", label, label, "plain"):
        float(step(name))
        torch.cuda.synchronize()
        ms[name] += _turns(lambda *_: step(name), None, None, None,
                           FLEET_TURN_STEPS)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"fleet {label}: {med[label]:.2f} ms/step against the plain "
          f"step's {med['plain']:.2f} ({med[label] / med['plain']:.3f}x) "
          f"in turns on {smi}")
    return {"collectives": colls[label], "leaves": n_leaves,
            "ms": med[label],
            "plain_ms": med["plain"], "bytes": nbytes[label],
            "plain_bytes": nbytes["plain"]}


def _hold_exact(label, got, want):
    ok = got.shape == want.shape and torch.equal(got, want)
    check(ok, f"{label}: not bit-equal to the plain version")
    return ok


def _scale_err(got, want) -> float:
    """max |got - want| over the largest |want| (at least 1e-30)."""
    return float((got.double() - want.double()).abs().max()
                 / max(float(want.double().abs().max()), 1e-30))


def mp_collective_checks(paddle, hcg, cfg):
    """Phase 22 (f): each mp collective on CUDA tensors over the one-rank
    mp group (NCCL) against its plain version, forward and backward."""
    import torch.nn.functional as TF
    from paddle_tpu_torch._core.tensor import Tensor
    from paddle_tpu_torch.distributed import _collectives as C
    from paddle_tpu_torch.distributed.fleet import mp_ops
    group = hcg.get_model_parallel_group()
    check(group.pg is not None and group.nranks == 1,
          f"mp group {group} has no process group")
    gen = torch.Generator(device="cuda").manual_seed(22)
    h, v = cfg.hidden_size, cfg.vocab_size
    base = torch.randn(BATCH, SEQ, h, device="cuda", generator=gen)
    dy = torch.randn(BATCH, SEQ, h, device="cuda", generator=gen)
    results = {}
    C.reset_calls()
    for name, fn in (
            ("mp_identity", lambda t: mp_ops.mp_identity(t, group)),
            ("mp_allreduce", lambda t: mp_ops.mp_allreduce(t, group)),
            ("mp_concat", lambda t: mp_ops.mp_concat(t, group, 0, 1)),
            ("mp_split", lambda t: mp_ops.mp_split(t, group, 0, 1))):
        leaf = base.clone().requires_grad_()
        out = fn(Tensor(leaf))
        torch.autograd.backward(out._t, dy)
        results[name] = (_hold_exact(f"{name} forward", out._t, base)
                         and _hold_exact(f"{name} backward", leaf.grad, dy))
    calls = dict(C.CALLS)
    ids = torch.randint(0, v, (BATCH, SEQ), device="cuda", generator=gen)
    table = torch.randn(v, h, device="cuda", generator=gen) * 0.02
    w_port = table.clone().requires_grad_()
    w_plain = table.clone().requires_grad_()
    out = mp_ops.mp_lookup_table(Tensor(w_port), Tensor(ids), 0, group)
    want = TF.embedding(ids, w_plain)
    torch.autograd.backward(out._t, dy)
    torch.autograd.backward(want, dy)
    emb_err = _scale_err(w_port.grad, w_plain.grad)
    results["mp_lookup_table"] = _hold_exact(
        "mp_lookup_table forward", out._t, want) and emb_err <= 1e-6
    check(emb_err <= 1e-6, f"mp_lookup_table backward {emb_err}")
    del w_port, w_plain, table, out, want
    logits = torch.randn(BATCH, SEQ, v, device="cuda", generator=gen) * 2
    labels = torch.randint(0, v, (BATCH, SEQ, 1), device="cuda",
                           generator=gen)
    labels[0, :7] = -100
    lp = logits.clone().requires_grad_()
    lq = logits.clone().requires_grad_()
    del logits
    loss = mp_ops.mp_softmax_cross_entropy(Tensor(lp), Tensor(labels), 0,
                                           group)._t
    want = TF.cross_entropy(lq.view(-1, v), labels.view(-1),
                            reduction="none", ignore_index=-100
                            ).view(BATCH, SEQ)
    loss.mean().backward()
    want.mean().backward()
    ce_err = (_scale_err(loss.detach(), want.detach()),
              _scale_err(lp.grad, lq.grad))
    results["mp_softmax_cross_entropy"] = max(ce_err) <= 1e-5
    check(max(ce_err) <= 1e-5, f"mp_softmax_cross_entropy {ce_err}")
    del lp, lq, loss, want
    calls_all = dict(C.CALLS)
    print(f"mp collectives on CUDA tensors over the one-rank NCCL mp group "
          f"at gpt2-medium's widths (b{BATCH} s{SEQ} h{h}, vocab {v}): "
          f"{results}; mp_lookup_table's table gradient off by {emb_err:.3g} "
          f"of its scale; mp_softmax_cross_entropy's loss and logits "
          f"gradient off by {ce_err[0]:.3g} and {ce_err[1]:.3g} of their "
          f"scale (the plain: F.cross_entropy); collectives {calls} for the "
          f"four, {calls_all} with the two after")
    torch.cuda.empty_cache()
    return results


def scaler_pair(smi, hcg, x, y, crit):
    """Phase 22 (f): phase 10's fp16 step with
    ``HybridParallelGradScaler`` against ``GradScaler``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import \
        HybridParallelGradScaler
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    runs = {}
    for name in ("GradScaler", "HybridParallelGradScaler"):
        paddle.seed(0)
        model = gpt.GPTForPretraining(cfg)
        opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
        scaler = paddle.amp.GradScaler()
        if name != "GradScaler":
            scaler = HybridParallelGradScaler(scaler, hcg)
        runs[name] = (model, opt, scaler)
    losses, grads = {}, {}
    for name, (model, opt, scaler) in runs.items():
        loss, grads[name] = _step_grads(
            opt, list(model.parameters()),
            lambda: _eager_step(paddle, model, crit, opt, x, y, "float16",
                                scaler))
        losses[name] = [float(loss)]
        losses[name].append(float(_eager_step(paddle, model, crit, opt, x,
                                              y, "float16", scaler)))
    equal = all(torch.equal(a, b) for a, b in
                zip(*grads.values()))
    scales = {k: r[2]._scale for k, r in runs.items()}
    print(f"HybridParallelGradScaler (fp16 O1, one rank) against "
          f"GradScaler: losses {losses}, step 1's gradients bit-equal: "
          f"{equal}, scales {scales}")
    check(len(set(map(tuple, losses.values()))) == 1,
          f"scaler losses {losses}")
    check(equal and len(set(scales.values())) == 1, "scaler steps differ")
    del runs, grads
    torch.cuda.empty_cache()
    return equal


def metrics_checks():
    """Phase 22 (f): ``fleet.metrics`` on one rank, on CUDA tensors and
    host values, against their values."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet import metrics as M
    t = paddle.to_tensor(np.asarray([1.5, -2.0], "float32"))
    pos, neg = np.zeros(10), np.zeros(10)
    pos[9], neg[0] = 5, 5
    got = {"sum": M.sum(t).tolist(), "max": M.max(t).tolist(),
           "min": M.min(np.asarray([3.0])).tolist(),
           "mean": M.mean(t).tolist(), "acc": M.acc(80, 100),
           "auc": M.auc(pos, neg)}
    want = {"sum": [1.5, -2.0], "max": [1.5, -2.0], "min": [3.0],
            "mean": [1.5, -2.0], "acc": 0.8, "auc": 1.0}
    print(f"fleet.metrics on one rank: {got}")
    check(got == want, f"metrics {got}, want {want}")


def dist_backend(group):
    """The backend of a fleet ``Group``'s process group, or "none"."""
    import torch.distributed as dist
    return "none" if group.pg is None else dist.get_backend(group.pg)


def fleet_path(smi):
    """Phase 22: fleet's hybrid-parallel eager API and eager ZeRO on a
    one-rank NCCL group (see the module docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet, sharding
    from paddle_tpu_torch.models import gpt
    phase("22 fleet and ZeRO")
    t_phase = time.perf_counter()
    times = {}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    D.init_parallel_env(f"tcp://127.0.0.1:{_free_port()}", rank=0,
                        world_size=1)
    try:
        fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
        hcg = fleet.get_hybrid_communicate_group()
        axes = {a: (hcg.mesh.get_dim_size(a), str(dist_backend(g)))
                for a, g in zip(hcg.mesh.dim_names, (
                    hcg.get_pipe_parallel_group(),
                    hcg.get_data_parallel_group(),
                    hcg.get_sharding_parallel_group(),
                    hcg.get_sep_parallel_group(),
                    hcg.get_model_parallel_group()))}
        print(f"fleet.init: mode {hcg.get_parallel_mode()}, mesh "
              f"{hcg.mesh}, axes (size, backend) {axes}")
        check(hcg.get_parallel_mode() == "single"
              and hcg.mesh.dim_names == ["pp", "dp", "sharding", "sep", "mp"]
              and all("nccl" in b for _, b in axes.values()),
              f"fleet.init {hcg.get_parallel_mode()} {axes}")
        cfg = gpt.GPT_CONFIGS["gpt2-medium"]
        paddle.set_device("gpu")
        rng = np.random.RandomState(0)
        x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
        y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
        crit = gpt.GPTPretrainingCriterion()
        out = {}
        for label, (clip, make) in _fleet_wrappers(
                paddle, fleet, sharding, hcg).items():
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            print(f"-- 22 {label}", flush=True)
            out[label] = fleet_pair(smi, label, clip, make, x, y, crit)
            times[label] = time.perf_counter() - t0
        for label, r in out.items():
            # ZeRO: the flags, then a reduce and a broadcast a parameter
            want = 1 + 2 * r["leaves"] if "zero" in label else 0
            check(r["collectives"] == want, f"{label}: {r['collectives']} "
                  f"collectives a step, want {want}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        print("-- 22 (f) mp collectives, scaler, metrics", flush=True)
        mp_collective_checks(paddle, hcg, cfg)
        scaler_pair(smi, hcg, x, y, crit)
        metrics_checks()
        times["(f)"] = time.perf_counter() - t0
    finally:
        D.destroy_process_group()
    print("phase 22 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items())
        + f"; {time.perf_counter() - t_phase:.1f} in all on {smi}")


PIPELINE_WATCHDOG_S = 180
PP_MICRO = 4          # phase 23's accumulate_steps: micro-batches of 2
PP_STEPS = 3          # steps held against each other
PP_TURN_STEPS = 2     # timed steps a turn (after one warm-up)
# VPP at one stage: only the tied word embeddings' gradient sums its two
# chunks' parts in another order than one backward does (a relative
# rounding of fp32's), and what the steps after it compute moves with it
PP_VPP_WTE_REL = 1e-6
PP_VPP_LOSS_REL = 1e-4


def _gpt_pipeline(paddle, cfg):
    """Phase 10's gpt2-medium as a ``PipelineLayer``: the embeddings (a
    shared layer), the decoder layers, the final norm, and the head tied
    to the word embeddings through the shared layer's ``forward_func``;
    ``GPTPretrainingCriterion`` the loss. Its parameters are made in
    ``GPTForPretraining``'s order, so one seed gives both the same
    weights."""
    from paddle_tpu_torch.distributed import (LayerDesc, PipelineLayer,
                                              SharedLayerDesc)
    from paddle_tpu_torch.models import gpt

    def head(emb, h):
        return paddle.matmul(h, emb.word_embeddings.weight, transpose_y=True)

    key = "word_embeddings.weight"
    return PipelineLayer(
        [SharedLayerDesc("embed", gpt.GPTEmbeddings, None, key, cfg)]
        + [LayerDesc(gpt.GPTDecoderLayer, cfg)
           for _ in range(cfg.num_layers)]
        + [LayerDesc(paddle.nn.LayerNorm, cfg.hidden_size,
                     cfg.layer_norm_eps),
           SharedLayerDesc("embed", gpt.GPTEmbeddings, head, key, cfg)],
        num_stages=1, loss_fn=gpt.GPTPretrainingCriterion())


def _hand_step(paddle, model, opt, x, y, m, floats):
    """The hand-written accumulation of ``PipelineParallel.train_batch``:
    m micro-batches, each loss / m and its backward, one optimizer step,
    all under O1 bf16. Appends the sum of the m micro losses as Python
    floats (what the runtimes return) to ``floats``; returns the fp32
    sum."""
    mb = x.shape[0] // m
    total, parts = None, []
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        for i in range(m):
            loss = model._loss_fn(model(x[i * mb:(i + 1) * mb]),
                                  y[i * mb:(i + 1) * mb]) / m
            loss.backward()
            parts.append(float(loss))
            total = loss.detach() if total is None else \
                total + loss.detach()
        opt.step()
        opt.clear_grad()
    floats.append(sum(parts))
    return total


def _step_memory(step):
    """Runs ``step()``; the peak device memory it reached and its rise
    over what was allocated before it, in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - base


def pipeline_parallel_pair(smi, paddle, cfg, x, y):
    """Phase 23 (a): ``PipelineParallel.train_batch`` (accumulate_steps
    ``PP_MICRO``) against the hand-written accumulation on a twin from
    seed 0, in turns; then against phase 10's plain b8 step in turns,
    ms/step and memory."""
    from paddle_tpu_torch.distributed import PipelineParallel
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    strategy = DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": PP_MICRO,
                                 "micro_batch_size": BATCH // PP_MICRO,
                                 "schedule_mode": "1F1B"}
    models, opts = {}, {}
    for name in ("pipeline", "hand"):
        paddle.seed(0)
        models[name] = _gpt_pipeline(paddle, cfg)
        opts[name] = paddle.optimizer.AdamW(
            1e-4, parameters=models[name].parameters())
    pp = PipelineParallel(models["pipeline"], None, strategy)
    floats = []

    def step(name):
        if name == "hand":
            return _hand_step(paddle, models["hand"], opts["hand"], x, y,
                              PP_MICRO, floats)
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            return pp.train_batch([x, y], opts["pipeline"])

    losses, grads, launches = {"pipeline": [], "hand": []}, {}, {}
    for i in range(PP_STEPS):
        for name in ("pipeline", "hand"):
            _reset_all_launches()
            if i == 0:
                loss, grads[name] = _step_grads(
                    opts[name], list(models[name].parameters()),
                    lambda: step(name))
            else:
                loss = step(name)
            losses[name].append(float(loss))
            launches[name] = _all_launches()
    equal = all(torch.equal(a, b) for a, b in
                zip(grads["pipeline"], grads["hand"]))
    n_leaves = len(grads["hand"])
    want = {k: PP_MICRO * cfg.num_layers if k in fa.LAUNCHES else 0
            for k in launches["hand"]}
    print(f"pipeline (a) PipelineParallel.train_batch, {PP_MICRO} "
          f"micro-batches of {BATCH // PP_MICRO}: losses "
          f"{losses['pipeline']} against the hand-written accumulation's "
          f"{losses['hand']}; step 1's gradients bit-equal over {n_leaves} "
          f"leaves: {equal}; launches a step {launches['pipeline']} "
          f"(hand {launches['hand']})")
    check(losses["pipeline"] == losses["hand"],
          f"PipelineParallel losses {losses}")
    check(equal, "PipelineParallel's step 1 gradients differ from the "
          "hand-written accumulation's")
    for name in launches:
        check(launches[name] == want, f"(a) {name} launches "
              f"{launches[name]}, want {want}")
    del models["hand"], opts["hand"]
    torch.cuda.empty_cache()
    paddle.seed(0)
    plain = gpt.GPTForPretraining(cfg)
    plain_opt = paddle.optimizer.AdamW(1e-4, parameters=plain.parameters())
    crit = gpt.GPTPretrainingCriterion()
    runs = {"plain": lambda: _eager_step(paddle, plain, crit, plain_opt, x,
                                         y, "bfloat16"),
            "pipeline": lambda: step("pipeline")}
    ms, mem = {k: [] for k in runs}, {}
    for name in ("plain", "pipeline", "pipeline", "plain"):
        mem[name] = _step_memory(runs[name])
        ms[name] += _turns(lambda *_: runs[name](), None, None, None,
                           PP_TURN_STEPS)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    gib = {k: (v[0] / 2**30, v[1] / 2**30) for k, v in mem.items()}
    print(f"pipeline (a): {med['pipeline']:.2f} ms/step against phase 10's "
          f"plain b{BATCH} step's {med['plain']:.2f} "
          f"({med['pipeline'] / med['plain']:.3f}x) in turns; peak memory "
          f"{gib['pipeline'][0]:.2f} GiB against {gib['plain'][0]:.2f} "
          f"({mem['pipeline'][0] / mem['plain'][0]:.3f}x), the step's rise "
          f"{gib['pipeline'][1]:.2f} GiB against {gib['plain'][1]:.2f} "
          f"({mem['pipeline'][1] / mem['plain'][1]:.3f}x; both models and "
          f"their states resident) on {smi}")
    del plain, plain_opt, runs
    torch.cuda.empty_cache()
    return {"model": models["pipeline"], "grads": grads["hand"],
            "floats": floats[:PP_STEPS], "ms": med, "mem": mem}


def pipeline_runtimes(smi, paddle, cfg, x, y, a):
    """Phase 23 (b): ``build_pipeline_runtime`` over a one-rank NCCL group
    for each schedule, ``PP_STEPS`` steps from seed 0, against (a)'s
    hand-written accumulation."""
    import torch.distributed as dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import (
        PipelineParallelWithInterleave, build_pipeline_runtime)
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    group = D.new_group([0])
    check(group.pg is not None and "nccl" in str(dist.get_backend(group.pg)),
          f"pipeline group {group} is not on NCCL")
    mb = BATCH // PP_MICRO
    xs = [x[i * mb:(i + 1) * mb] for i in range(PP_MICRO)]
    ys = [y[i * mb:(i + 1) * mb] for i in range(PP_MICRO)]
    barriers = [0]
    barrier = dist.barrier

    def counted_barrier(*args, **kwargs):
        barriers[0] += 1
        return barrier(*args, **kwargs)

    out = {}
    for schedule in ("1F1B", "FThenB", "VPP", "ZeroBubble"):
        paddle.seed(0)
        model = _gpt_pipeline(paddle, cfg)
        opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
        if schedule == "VPP":
            strategy = DistributedStrategy()
            strategy.pipeline_configs = {"accumulate_steps": PP_MICRO}
            vpp = PipelineParallelWithInterleave(
                model, None, strategy, num_virtual_pipeline_stages=2)
            stage = [model._segment(lo, hi) for lo, hi in vpp._virtual_bounds]
        else:
            stage = model._segment(0, len(model.run_functions))
        rt = build_pipeline_runtime(stage, group, model._loss_fn, PP_MICRO,
                                    schedule)
        losses, ms, launches, counts = [], [], [], []

        def step():
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = rt.train_batch(xs, ys)
                opt.step()
                opt.clear_grad()
            return loss

        dist.barrier = counted_barrier
        try:
            for i in range(PP_STEPS):
                _reset_all_launches()
                before = dict(getattr(rt, "counts", {}))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == 0:
                    loss, grads = _step_grads(opt, list(model.parameters()),
                                              step)
                else:
                    loss = step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss)
                launches.append(_all_launches())
                counts.append({k: v - before.get(k, 0)
                               for k, v in getattr(rt, "counts", {}).items()})
        finally:
            dist.barrier = barrier
        names = [n for n, _ in model.named_parameters()]
        wte = [i for i, n in enumerate(names)
               if n.endswith("word_embeddings.weight")]
        differ = [names[i] for i, (g, w) in enumerate(zip(grads, a["grads"]))
                  if not torch.equal(g, w)]
        wte_rel = _divergence([grads[i] for i in wte],
                              [a["grads"][i] for i in wte])["worst"]
        loss_rel = max(abs(l - w) / abs(w)
                       for l, w in zip(losses, a["floats"]))
        want = {k: PP_MICRO * cfg.num_layers if k in fa.LAUNCHES else 0
                for k in launches[0]}
        print(f"pipeline (b) {schedule} ({type(rt).__name__}, one-rank NCCL "
              f"group): losses {losses} against (a)'s hand-written "
              f"{a['floats']} (worst {loss_rel:.3g} relative); step 1's "
              f"gradients differing from (a)'s: {differ} (tied "
              f"word embeddings {wte_rel:.3g} relative); max_inflight "
              f"{rt.max_inflight}, max_stash_bytes {rt.max_stash_bytes}; "
              f"counts a step {counts}; P2P sends {rt._p2p.sends}, NCCL "
              f"barriers {barriers[0]} over {PP_STEPS} steps; ms/step "
              f"{[round(v, 2) for v in ms]} (median of the last "
              f"{PP_STEPS - 1} {float(np.median(ms[1:])):.2f}) on {smi}")
        barriers[0] = 0
        for got in launches:
            check(got == want, f"(b) {schedule} launches {got}, want {want}")
        if schedule == "VPP":
            check(differ in ([], [names[i] for i in wte])
                  and wte_rel <= PP_VPP_WTE_REL,
                  f"VPP gradients {differ}, wte {wte_rel}")
            check(losses[0] == a["floats"][0]
                  and loss_rel <= PP_VPP_LOSS_REL, f"VPP losses {losses}")
        else:
            check(not differ, f"{schedule} gradients differ: {differ}")
            check(losses == a["floats"], f"{schedule} losses {losses}")
        if schedule == "ZeroBubble":
            check(all(c == {"F": PP_MICRO, "B": PP_MICRO, "W": PP_MICRO}
                      for c in counts), f"ZeroBubble counts {counts}")
        check(rt._p2p.sends == 0 and not rt._p2p._local,
              f"{schedule} at one rank sent {rt._p2p.sends}")
        out[schedule] = {"ms": float(np.median(ms[1:])),
                         "max_inflight": rt.max_inflight,
                         "max_stash_bytes": rt.max_stash_bytes}
        del model, opt, rt, stage, grads
        torch.cuda.empty_cache()
    return out


RESHARD_PAIRS = [(s, d) for s in ("R", "S0", "S1", "P")
                 for d in ("R", "S0", "S1", "P")]
RESHARD_ND = [("S0 R", "R S1"), ("P R", "R S0"), ("S0 S1", "R R"),
              ("R P", "S1 S0")]


def _placements(spec):
    """Placement words, one per mesh axis: R, S<dim>, P (a sum), Pmax."""
    from paddle_tpu_torch.distributed import Partial, Replicate, Shard
    return [Replicate() if w == "R" else Partial() if w == "P"
            else Partial("max") if w == "Pmax" else Shard(int(w[1:]))
            for w in spec.split()]


def reshard_pairs(smi, paddle, weight):
    """Phase 23 (c): ``shard_tensor``, ``reshard`` through every pair that
    ``choose_reshard_function`` knows on a one-rank NCCL mesh (the 16
    pairs of a 1-D mesh, multi-axis moves on a 2-D one, a cross-mesh
    move), ``dtensor_from_local`` / ``dtensor_to_local`` and
    ``unshard_dtensor``, on ``weight`` (the word embeddings), forward and
    backward: each piece bit-equal to the weight (one rank holds it all),
    each layout move's gradient bit-equal to its cotangent, no gradient
    through Partial."""
    from paddle_tpu_torch.distributed import (ProcessMesh, dtensor_from_local,
                                              dtensor_to_local, reshard,
                                              shard_tensor, unshard_dtensor)
    from paddle_tpu_torch.distributed import _collectives as C
    from paddle_tpu_torch.distributed.auto_parallel import \
        reshard_functions as rf
    w = weight._t.detach().clone()
    gen = torch.Generator(device="cuda").manual_seed(23)
    cot = torch.randn(w.shape, device="cuda", generator=gen)
    meshes = {1: ProcessMesh(np.array([0]), ["x"]),
              2: ProcessMesh(np.array([[0]]), ["x", "y"])}
    other = ProcessMesh(np.array([0]), ["x"])
    cases = [(1, s, d, meshes[1]) for s, d in RESHARD_PAIRS] \
        + [(2, s, d, meshes[2]) for s, d in RESHARD_ND] \
        + [(1, "P", "Pmax", meshes[1]), (1, "S0", "S1", other)]
    C.reset_calls()
    chosen, results = {}, {}
    t0 = time.perf_counter()
    for n, src, dst, dst_mesh in cases:
        mesh = meshes[n]
        leaf = paddle.to_tensor(w, stop_gradient=False)
        t = reshard(shard_tensor(leaf, mesh, _placements(" ".join("R" * n))),
                    mesh, _placements(src))
        fn = rf.choose_reshard_function(
            rf.DistAttrLite(mesh, t._dist_attr.placements),
            rf.DistAttrLite(dst_mesh, _placements(dst))).name
        out = reshard(t, dst_mesh, _placements(dst))
        layout = "P" not in src + dst
        ok = torch.equal(out._t, w) and out._dist_attr.global_shape \
            == list(w.shape) and out.stop_gradient is False
        if layout:
            torch.autograd.backward(out._t, cot)
            ok = ok and torch.equal(leaf._t.grad, cot)
        else:
            ok = ok and out._t.grad_fn is None
        chosen[fn] = chosen.get(fn, 0) + 1
        results[f"{src}->{dst}" + (" (cross)" if dst_mesh is other
                                    else "")] = ok
    local = paddle.to_tensor(w, stop_gradient=False)
    d = dtensor_from_local(local, meshes[1], _placements("S0"))
    whole = unshard_dtensor(d)
    torch.autograd.backward(whole._t, cot)
    results["from_local/unshard/to_local"] = (
        torch.equal(whole._t, w) and torch.equal(local._t.grad, cot)
        and torch.equal(dtensor_to_local(d)._t, w)
        and d._dist_attr.global_shape == list(w.shape))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls = dict(C.CALLS)
    print(f"pipeline (c) reshard on the word embeddings {list(w.shape)} "
          f"over a one-rank NCCL mesh, forward and backward: bit-equal "
          f"{sum(results.values())} of {len(results)}: {results}; functions "
          f"chosen {chosen}; collectives issued {calls} in {seconds:.2f} s "
          f"on {smi}")
    check(all(results.values()), f"reshard cases not bit-equal: "
          f"{[k for k, v in results.items() if not v]}")
    check(set(chosen) == {f.name for f in rf.all_reshard_functions()},
          f"reshard functions chosen {sorted(chosen)}")
    return calls


def checkpoint_round_trip(smi, paddle, model):
    """Phase 23 (d): ``save_state_dict`` / ``load_state_dict`` of the
    pipeline model's fp32 parameters: the round trip bit-equal, a flipped
    byte of ``data_rank0.pkl`` refused; seconds and GB/s each way (the
    file's bytes; the read after the write is warm in the file cache)."""
    import tempfile
    from paddle_tpu_torch.base.core import EnforceNotMet
    from paddle_tpu_torch.distributed import load_state_dict, save_state_dict
    state = model.state_dict()
    nbytes = sum(v._t.numel() * v._t.element_size() for v in state.values())
    root = tempfile.mkdtemp(prefix="pt_ckpt_")
    try:
        path = os.path.join(root, "ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state_dict(state, path)
        save_s = time.perf_counter() - t0
        data = os.path.join(path, "data_rank0.pkl")
        size = os.path.getsize(data)
        target = {k: paddle.zeros_like(v) for k, v in state.items()}
        t0 = time.perf_counter()
        load_state_dict(target, path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        equal = all(torch.equal(target[k]._t, v._t) and
                    target[k]._t.is_cuda for k, v in state.items())
        del target
        with open(data, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            load_state_dict({k: paddle.zeros_like(v)
                             for k, v in state.items()}, path)
            refused = "loaded"
        except EnforceNotMet as e:
            refused = str(e).splitlines()[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"pipeline (d) checkpoint of {len(state)} fp32 parameters "
          f"({nbytes} bytes, data_rank0.pkl {size} bytes): save "
          f"{save_s:.2f} s ({size / save_s / 1e9:.2f} GB/s), load "
          f"{load_s:.2f} s ({size / load_s / 1e9:.2f} GB/s, warm read); "
          f"round trip bit-equal: {equal}; a flipped byte: "
          f"{refused.replace(root, '<tmp>')!r} on {smi}")
    check(equal, "the checkpoint round trip is not bit-equal")
    check("corrupted" in refused, f"a flipped byte was not refused: "
          f"{refused}")
    return save_s, load_s, size


def pipeline_path(smi):
    """Phase 23: the eager pipeline and the semi-auto API at gpt2-medium on
    a one-rank NCCL group (see the module docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models import gpt
    phase("23 the eager pipeline, the semi-auto API, the checkpoint")
    t_phase = time.perf_counter()
    times = {}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    D.init_parallel_env(f"tcp://127.0.0.1:{_free_port()}", rank=0,
                        world_size=1)
    try:
        cfg = gpt.GPT_CONFIGS["gpt2-medium"]
        paddle.set_device("gpu")
        rng = np.random.RandomState(0)
        x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
        y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (BATCH, SEQ)))
        t0 = time.perf_counter()
        a = pipeline_parallel_pair(smi, paddle, cfg, x, y)
        times["(a)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipeline_runtimes(smi, paddle, cfg, x, y, a)
        times["(b)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wte = a["model"].run_functions[0].word_embeddings.weight
        reshard_pairs(smi, paddle, wte)
        times["(c)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint_round_trip(smi, paddle, a["model"])
        times["(d)"] = time.perf_counter() - t0
        del a
        torch.cuda.empty_cache()
    finally:
        D.destroy_process_group()
    print("phase 23 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in times.items())
        + f"; {time.perf_counter() - t_phase:.1f} in all on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--persist-child"]:
        return persist_child(sys.argv[2])
    name, count, smi = card()
    build()
    import tempfile
    PERSIST_DIR[0] = tempfile.mkdtemp(prefix="persist_")
    with watchdog("phase 3 (kernel checks)", 300):
        errs, varlen_results, flashmask_expected, fused_expected = \
            kernel_checks()
    with watchdog("phase 4 (timings)", 300):
        ms, plain_ms, library_ms, bnd = timings()
    with watchdog("phase 4 (head_dim 256 timings)", 300):
        d256 = d256_timings()
    with watchdog("phase 4 (head_dim 512 timings)", 300):
        d512 = d512_timings()
    with watchdog("phase 4 (fp16 timings)", 300):
        fp16, fp16_d256, fp16_d512 = fp16_timings({
            "#3 dq, path shape": ms["flash_bwd_dq"],
            "#8 varlen dq, path shape": ms["varlen_bwd_dq"],
            "#11 flashmask dq, path shape": ms["flashmask_bwd_dq"],
            "#3 dq, head_dim 256": d256[0]["flash_bwd_dq"],
            "#3 dq, head_dim 512": d512[0]["flash_bwd_dq"]})
    with watchdog("phase 4b (the public entry)", 300):
        entry_paths()
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
        resnet_ms = resnet_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 12 (op surface)", 600):
        op_surface_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 14 (nn layers)", 400):
        nn_layers_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 15 (input pipeline)", 400):
        input_pipeline_path(smi, compiled_ms, resnet_ms)
    torch.cuda.empty_cache()
    with watchdog("phase 17 (bert and the fused layers)", 300):
        bert_fused_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 18 (the mesh path)", 180):
        mesh_path(smi, compiled_ms)
    torch.cuda.empty_cache()
    with watchdog("phase 19 (the compile path)", 720):
        compile_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 20 (the steady-state runtime)", 300):
        steady_state_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 21 (the native runtime)", NATIVE_WATCHDOG_S):
        native_runtime_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 22 (fleet and ZeRO)", FLEET_WATCHDOG_S):
        fleet_path(smi)
    torch.cuda.empty_cache()
    with watchdog("phase 23 (the eager pipeline and the semi-auto API)",
                  PIPELINE_WATCHDOG_S):
        pipeline_path(smi)
    phase("16 results")
    for label, (d_ms, d_plain, d_lib, d_bnd) in (
            ("head_dim 256", d256), ("head_dim 512", d512),
            ("fp16 head_dim 64", fp16), ("fp16 head_dim 256", fp16_d256),
            ("fp16 head_dim 512", fp16_d512)):
        for kname in d_ms:
            lib = d_lib[kname]
            print(f"{label} {kname}: {d_ms[kname]:.4f} ms, plain "
                  f"{d_plain[kname]:.4f} ms, bound {d_bnd[kname][0]:.4f} ms "
                  f"({d_bnd[kname][1]}), {d_bnd[kname][0] / d_ms[kname]:.1%} "
                  f"of bound, library "
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
