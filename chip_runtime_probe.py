"""Two readings beside ``chip_smoke.py`` phase 21, on one CUDA card::

    python3 chip_runtime_probe.py

1. Where the persistent compile cache's warm start saves. Phase 19 (a)'s
   compiled gpt2-medium (cut to ``COMPILED_GPT_LAYERS`` layers, b8 s1024,
   O1 bf16, AdamW) runs its first step in four child processes: cold into
   an empty ``FLAGS_executable_cache_dir``; warm from both caches (the
   stored graph and inductor's); from inductor's caches alone (the stored
   graph removed: the trace runs again); from the stored graph alone
   (inductor's and Triton's caches removed: inductor compiles again).
   Each prints its first step's seconds, traces, loads, the
   ``cache.persist.*`` counts, inductor's cache counts and three losses.
2. Whether a profiled step's kernel count moves with no change of prong.
   Phase 20 (a)'s windowed gpt2-medium step (a model for each prong from
   seed 0, their three losses compared), then ``PROFILE_READS`` reads of
   each prong in turns, each read taken two ways: a trace of the one step
   alone (``one_step_count``) and the post-pause read of ``chip_smoke.
   _rt_profile``.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

PROFILE_READS = 4


def persist_child(cache):
    """``--child <dir>``: one ``chip_smoke._persist_run`` from ``<dir>``;
    prints one JSON line."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import persist
    from paddle_tpu_torch.models import gpt
    from torch._dynamo.utils import counters
    torch.backends.cuda.matmul.allow_tf32 = False   # as card() sets it
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_flags({"FLAGS_executable_cache_dir": cache})
    cfg = dataclasses.replace(gpt.GPT_CONFIGS["gpt2-medium"],
                              num_layers=cs.COMPILED_GPT_LAYERS)
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (cs.BATCH, cs.SEQ)))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (cs.BATCH, cs.SEQ)))
    first_s, losses, entry = cs._persist_run(paddle, gpt, cfg, x, y)
    print(json.dumps({
        "first_s": first_s, "losses": losses, "traces": entry.traces,
        "loads": entry.loads, "persist": persist.counters(),
        "inductor": {k: v for k, v in {**counters["inductor"],
                                       **counters["aot_autograd"]}.items()
                     if "cache" in k}}))
    return 0


def persist_split(smi):
    root = tempfile.mkdtemp(prefix="persist_probe_")
    try:
        runs = {}

        def child(label, cache):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--child", cache], capture_output=True,
                                  text=True, timeout=400)
            if proc.returncode != 0:
                print(proc.stdout[-3000:])
                print(proc.stderr[-3000:])
            cs.check(proc.returncode == 0, f"{label}: exit {proc.returncode}")
            got = json.loads([ln for ln in proc.stdout.splitlines()
                              if ln.startswith("{")][-1])
            got["process_s"] = time.perf_counter() - t0
            runs[label] = got
            print(f"PERSIST {label}: first step {got['first_s']:.2f} s "
                  f"(process {got['process_s']:.1f} s), traces "
                  f"{got['traces']}, loads {got['loads']}, {got['persist']}, "
                  f"inductor {got['inductor']}, losses {got['losses']}",
                  flush=True)

        cold = os.path.join(root, "cold")
        child("cold", cold)
        both = os.path.join(root, "both")
        shutil.copytree(cold, both)
        child("warm from both caches", both)
        inductor_only = os.path.join(root, "inductor_only")
        shutil.copytree(cold, inductor_only)
        for f in os.listdir(inductor_only):
            if f.endswith(".ptxc"):
                os.unlink(os.path.join(inductor_only, f))
        child("warm from inductor's caches alone", inductor_only)
        graph_only = os.path.join(root, "graph_only")
        shutil.copytree(cold, graph_only)
        shutil.rmtree(os.path.join(graph_only, "inductor"))
        child("warm from the stored graph alone", graph_only)
        base = runs["cold"]["losses"]
        for label, got in runs.items():
            print(f"PERSIST {label}: losses bit-equal to cold: "
                  f"{got['losses'] == base}")
        print(f"PERSIST first-step seconds: " + ", ".join(
            f"{k} {v['first_s']:.2f}" for k, v in runs.items())
            + f" on {smi}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def one_step_count(step):
    """One step alone under ``torch.profiler``, the kernels counted over
    the whole trace (``key_averages``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.count for e in prof.key_averages()
               if e.device_type == cuda and e.key not in cs.PHASES)


def profile_reads(smi):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import lazy
    from paddle_tpu_torch.framework import enable_eager_fusion
    from paddle_tpu_torch.models import gpt
    core = lazy._native_core()
    cs.check(core is not None and lazy._DRIVE_OK, "no native record core")
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    paddle.set_device("gpu")
    crit = gpt.GPTPretrainingCriterion()
    pair, x, y = cs._rt_gpt_pair(paddle, gpt, cfg)
    models = {"native": pair[0], "python": pair[1]}

    def step(mode):
        cs._use_prong(mode == "native", core)
        model, opt = models[mode]
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    paddle.set_flags({"FLAGS_lazy_max_segment_ops": cs.RT_CAP})
    enable_eager_fusion(True)
    try:
        losses = {"native": [], "python": []}
        for i in range(6):
            for mode in ("native", "python"):
                loss = float(step(mode))
                if i < 3:
                    losses[mode].append(loss)
        print(f"PROFILE losses native {losses['native']}, python "
              f"{losses['python']}: bit-equal "
              f"{losses['native'] == losses['python']}")
        counts = {m: cs._steady_counts(f"PROFILE {m}", lambda m=m: step(m))
                  for m in ("native", "python")}
        reads = {m: {"one step": [], "after a pause": []}
                 for m in ("native", "python")}
        for _ in range(PROFILE_READS):
            for mode in ("python", "native"):
                reads[mode]["one step"].append(
                    one_step_count(lambda: float(step(mode))))
                got = cs._rt_profile(lambda: float(step(mode)))
                reads[mode]["after a pause"].append(
                    None if got is None else got[1])
        for mode in ("python", "native"):
            print(f"PROFILE {mode}: kernels a profiled step, {PROFILE_READS}"
                  f" reads in turns: {reads[mode]} (steady counts "
                  f"{counts[mode]}) on {smi}")
    finally:
        enable_eager_fusion(False)
        cs._use_prong(True, core)


def main():
    if not torch.cuda.is_available():
        print("chip_runtime_probe: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--child"]:
        return persist_child(sys.argv[2])
    _, _, smi = cs.card()
    cs.build()
    t0 = time.perf_counter()
    persist_split(smi)
    t1 = time.perf_counter()
    profile_reads(smi)
    print(f"probe seconds: persist {t1 - t0:.1f}, profile "
          f"{time.perf_counter() - t1:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
