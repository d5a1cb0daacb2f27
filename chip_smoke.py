"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printed as it runs:

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. builds the three flash-attention kernels from ``paddle_tpu_torch/csrc``
   (``nvcc``, ``sm_90a``), printing build seconds and ptxas's register and
   shared-memory lines;
3. holds each kernel against its plain PyTorch version at the training
   shape (``[8, 16, 1024, 64]`` bf16, causal) and at a cross shape
   (sq 128, sk 256, causal, head_dim 32, fp32);
4. times each kernel, its plain version and, as a yardstick only,
   ``scaled_dot_product_attention`` (which the port never calls), beside
   the least time the card could take for the same work;
5. checks the training step on a small GPT against the port's CPU path
   (the path the CPU tests hold against the JAX package), then drives the
   main path: gpt2-medium at full width (24 layers, hidden 1024), batch 8,
   seq 1024, bf16 params, fp32 master, remat per block, AdamW, 1 warm-up
   and 5 timed steps, and checks that every step launched 48 forward, 24
   dK/dV and 24 dQ kernels;
   one more step under ``torch.profiler`` splits the device time by
   phase (forward, backward, optimizer) and by kernel group;
6. prints the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. It never falls back
to the CPU or to a plain version: with no CUDA device it exits 1 before
doing anything.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
BATCH, SEQ, HEADS, HEAD_DIM = 8, 1024, 16, 64
TIMED_STEPS = 5
PHASES = ("forward", "optimizer")  # the trainer's profiler ranges
# per kernel: (module source, TPU kernel it replaces)
KERNELS = {
    "flash_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                  "paddle_tpu/ops/pallas/flash_attention.py:68"),
    "flash_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd_dkv.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:156"),
    "flash_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd_dq.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:205"),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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
    print(f"build wall {wall:.1f} s (nvcc processes run in parallel)")
    check(set(infos) == set(KERNELS), f"built {sorted(infos)}")


def _inputs(bh, sq, sk, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(s):
        return torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)

    return rnd(sq), rnd(sk), rnd(sk), rnd(sq)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def limit(dtype, key, want, abs_v_out=None):
    """Per-element bound on |kernel - plain| for output ``key``.

    fp32 io: the two differ only in summation order, 1e-5 absolute on
    unit-scale inputs; lse is fp32 at either io type (1e-4 in bf16, whose
    logits come from bf16 q and k). bf16 outputs: both sides compute in
    fp32 and round once, so an element may sit one bf16 ulp of itself
    apart (2^-7 |x|), plus fp32 summation noise, held at 1e-4 of the
    largest element. The forward also rounds P to bf16 against a running
    rather than the final max, which moves each term of P.V by at most
    2^-8 p|v| and l by 2^-8 of itself: ``abs_v_out`` is the plain output
    with |V| (sum_j p_j |v_j| / l)."""
    if key == "lse" or dtype == torch.float32:
        return 1e-4 if key == "lse" and dtype == torch.bfloat16 else 1e-5
    want = want.float().abs()
    lim = 2 ** -7 * want + 1e-4 * want.max()
    if key == "out":
        lim = lim + 2 ** -8 * (want + abs_v_out.float())
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
            got, want, limit(dtype, key, want, abs_v_out))
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


def kernel_checks():
    phase("3 kernels against their plain versions")
    path = hold_against_plain(BATCH * HEADS, SEQ, SEQ, HEAD_DIM,
                              torch.bfloat16, True, seed=0)
    hold_against_plain(4, 128, 256, 32, torch.float32, True, seed=1)
    return path


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
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


def timings():
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    phase("4 timings at the training shape")
    bh, s, d = BATCH * HEADS, SEQ, HEAD_DIM
    q, k, v, do = _inputs(bh, s, s, d, torch.bfloat16, seed=2)
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

    # yardstick only: the library's fused attention on the same inputs in
    # the [B, H, S, D] layout (its backward computes dq, dk and dv in one
    # call, so it stands beside no single backward kernel)
    q4, k4, v4, do4 = (t.view(BATCH, HEADS, s, d) for t in (q, k, v, do))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 20)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do4, retain_graph=True), 20)
    library_ms = {"flash_fwd": lib_fwd, "flash_bwd_dkv": None,
                  "flash_bwd_dq": None}
    bnd = bounds(bh, s, d, 2)
    for name in KERNELS:
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
    h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    n_params = 12 * L * h * h + v * h + cfg.max_position_embeddings * h
    flops_per_token = 6 * n_params + 12 * L * SEQ * h
    mfu = flops_per_token * tok_s / PEAK_BF16_FLOPS
    peak = torch.cuda.max_memory_allocated()
    print(f"gpt2-medium b{BATCH} s{SEQ} bf16 remat adamw: "
          f"median {med_ms:.2f} ms/step of {TIMED_STEPS} "
          f"(steps {[round(x, 2) for x in step_ms]}), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s, "
          f"peak memory {peak / 2**30:.2f} GiB")
    profile_step(step, state, tokens, labels, med_ms)
    return launches


def _kernel_group(name: str) -> str:
    if "pt_flash" in name:
        return "flash attention (port)"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "index" in name or "embedding" in name or "scatter" in name:
        return "embedding / index"
    if any(k in name for k in ("softmax", "log_softmax", "nll", "gather")):
        return "loss"
    if "reduce" in name:
        return "reductions"
    return "elementwise / other"


def profile_step(step, state, tokens, labels, step_ms):
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
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {t:.2f} ms ({t / total_ms:.1%})")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print(f"  top: {e.self_device_time_total / 1e3:8.2f} ms "
              f"x{e.count:<5d} {e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, count, smi = card()
    build()
    errs = kernel_checks()
    ms, plain_ms, library_ms, bnd = timings()
    torch.cuda.empty_cache()
    launches = main_path()
    phase("6 results")
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
