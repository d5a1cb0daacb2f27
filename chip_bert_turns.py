"""A training step timed for several checkouts of the repo in turns on one
CUDA card: bert-base's, as ``chip_smoke.py`` phase 17 builds it,
gpt2-medium's eager step, as phase 10 runs it, or that step under the
lazy window, as phase 20 (a) runs it.

    python3 chip_bert_turns.py DIR [DIR ...] [--rounds 2] [--steps 10]
        [--model bert-base|gpt2-medium-eager|gpt2-medium-window]

Each DIR is the root of a checkout (its ``paddle_tpu_torch`` is the one
imported). A round runs the checkouts in the order given and then in the
reverse order (A B B A), each in a child process of its own, so a drift of
the machine during the round falls on both alike. For bert-base a child
builds ``models.bert.build_train_step(BERT_CONFIGS["bert-base"], lr=1e-4,
remat=True)`` on the card and draws tokens and labels as phase 17 does
(b16 s512, seed 0); for gpt2-medium-eager it builds phase 10's
``GPTForPretraining`` from seed 0 (fp32 parameters, O1 bf16 ``auto_cast``,
``AdamW(1e-4)``, b8 s1024); gpt2-medium-window runs that step with the
ambient window on (``enable_eager_fusion(True)``, a segment cap of 1024
ops, every telemetry plane off). It times 1 warm-up and ``--steps`` steps (host
clock, each ended by a synchronize), then one step under
``torch.profiler`` for the device's busy time and idle share of the
median. Prints every child's median and steps, and each checkout's median
over its children.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHAPES = {"bert-base": (16, 512), "gpt2-medium-eager": (8, 1024),
          "gpt2-medium-window": (8, 1024)}


def bert_step():
    """Phase 17's bert-base step: a callable returning the loss."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import bert
    cfg = bert.BERT_CONFIGS["bert-base"]
    batch, seq = SHAPES["bert-base"]
    init_fn, step = bert.build_train_step(cfg, lr=1e-4, remat=True,
                                          device="cuda")
    state = [init_fn(0)]
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (batch, seq))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (batch, seq))).cuda()

    def run():
        state[0], loss = step(state[0], tokens, labels)
        return loss
    return run


def gpt_eager_step():
    """Phase 10's eager gpt2-medium O1 bf16 step: a callable returning
    the loss."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    batch, seq = SHAPES["gpt2-medium-eager"]
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)))
    paddle.seed(0)
    model = gpt.GPTForPretraining(cfg)
    crit = gpt.GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())

    def run():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return run


def gpt_window_step():
    """Phase 20 (a)'s step: phase 10's under the ambient window."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import enable_eager_fusion
    paddle.set_flags({"FLAGS_lazy_max_segment_ops": 1024})
    enable_eager_fusion(True)
    return gpt_eager_step()


def child(root: str, steps: int, model: str) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, root)
    step = {"bert-base": bert_step,
            "gpt2-medium-eager": gpt_eager_step,
            "gpt2-medium-window": gpt_window_step}[model]()
    ms = []
    for i in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # the trainer's record_function ranges show on the device side too,
    # spanning their kernels: keep them out of the sum
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda
               and e.key not in ("forward", "optimizer")) / 1e3
    print(json.dumps({"root": root, "median_ms": med, "steps_ms": ms,
                      "busy_ms": busy, "idle": max(0.0, 1 - busy / med),
                      "loss": float(loss)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--child", default=None)
    ap.add_argument("--model", default="bert-base", choices=sorted(SHAPES))
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.steps, args.model)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.roots:
        print("needs a CUDA card and at least one checkout", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    roots = [os.path.abspath(r) for r in args.roots]
    batch, seq = SHAPES[args.model]
    what = {"bert-base": "bf16 remat adamw",
            "gpt2-medium-eager": "eager, O1 bf16, adamw",
            "gpt2-medium-window": "eager under the window, O1 bf16, "
                                  "adamw"}[args.model]
    print(f"{args.model} b{batch} s{seq} {what}, {args.steps} steps after 1 "
          f"warm-up, on {smi}", flush=True)
    medians = {r: [] for r in roots}
    for rnd in range(args.rounds):
        for root in roots + roots[::-1]:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--steps", str(args.steps), "--model", args.model],
                cwd=root, capture_output=True, text=True, timeout=600)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            res = json.loads(out.stdout.strip().splitlines()[-1])
            medians[root].append(res["median_ms"])
            print(f"round {rnd} {root}: median {res['median_ms']:.2f} ms "
                  f"(steps {[round(x, 2) for x in res['steps_ms']]}), busy "
                  f"{res['busy_ms']:.2f} ms, idle {res['idle']:.3f}, last "
                  f"loss {res['loss']:.5f}", flush=True)
    for root, meds in medians.items():
        meds = sorted(meds)
        mid = len(meds) // 2
        med = meds[mid] if len(meds) % 2 else (meds[mid - 1] + meds[mid]) / 2
        print(f"{root}: median of its {len(meds)} children's medians "
              f"{med:.2f} ms ({[round(x, 2) for x in meds]}) on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
