"""Trial-job runner: measured step times for candidate parallel configs,
the counterpart of ``paddle_tpu/distributed/auto_tuner/trial_runner.py``.

Like upstream's auto_tuner (which launches trial jobs and reads their
timings), each trial runs in processes of its own, so a config that runs
out of memory or fails kills only its trial and scores +inf, never the
tuner. A trial builds the port's GPT trainer (``models/gpt.py``
``build_train_step``: bf16 on a card, fp32 on the CPU) under the config's
dp/mp/pp degrees and times its steps, each ending in
``torch.cuda.synchronize()`` on a card. One rank runs as
``python -m paddle_tpu_torch.distributed.auto_tuner.trial_runner``; n =
dp·mp·pp above one runs as n ranks through the launcher
(``distributed.launch``: gloo on the CPU, NCCL on the cards), and rank 0's
log carries the result. A config with more ranks than there are cards (on
a card) or cores (on the CPU) returns +inf without starting a job. The
config travels in ``PT_TRIAL_CONFIG``; the job prints
``PT_TRIAL_SECONDS=<seconds a step>``.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
# what the parent's own job set, which would override the launcher's
_JOB_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
            "PADDLE_MASTER", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT")


def _ranks(config: Dict) -> int:
    return (int(config.get("dp_degree", 1)) * int(config.get("mp_degree", 1))
            * int(config.get("pp_degree", 1)))


def _capacity(device: str) -> int:
    """Ranks a trial may run: the cards on a card, the cores on the CPU."""
    if device == "cuda":
        import torch
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _seconds(text: str) -> float:
    for line in reversed(text.strip().splitlines() or [""]):
        if line.startswith("PT_TRIAL_SECONDS="):
            try:
                return float(line.split("=", 1)[1])
            except ValueError:
                return float("inf")
    return float("inf")


def measure_step_time(config: Dict, steps: int = 5, warmup: int = 2,
                      timeout: float = 300.0) -> float:
    """Run one trial job; +inf on any failure or timeout."""
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    n = _ranks(config)
    if n > _capacity(device):
        return float("inf")
    payload = dict(config, _steps=steps, _warmup=warmup, _device=device)
    env = {k: v for k, v in os.environ.items() if k not in _JOB_ENV}
    env["PT_TRIAL_CONFIG"] = json.dumps(payload)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    log_dir = None
    if n == 1:
        cmd = [sys.executable, "-m",
               "paddle_tpu_torch.distributed.auto_tuner.trial_runner"]
    else:
        log_dir = tempfile.mkdtemp(prefix="pt_trial_")
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc_per_node", str(n),
               "--master", f"127.0.0.1:{_free_port()}",
               "--log_dir", log_dir, os.path.abspath(__file__)]
    try:
        # a session of its own: a timeout stops the launcher's workers too
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            return float("inf")
        if log_dir is not None:
            log = os.path.join(log_dir, "workerlog.0.0.e0")
            if not os.path.exists(log):
                return float("inf")
            with open(log) as f:
                out = f.read()
        return _seconds(out)
    finally:
        if log_dir is not None:
            shutil.rmtree(log_dir, ignore_errors=True)


def _measure_in_process(config: Dict, steps: int = 5,
                        warmup: int = 2) -> float:
    """Build the GPT train step under ``config``'s dp/mp/pp degrees on
    this job's ranks and measure seconds/step; +inf when the config cannot
    be built or run (out of memory, an infeasible mesh)."""
    import torch

    from paddle_tpu_torch.distributed.mesh import auto_mesh
    from paddle_tpu_torch.distributed.parallel_env import init_parallel_env
    from paddle_tpu_torch.models.gpt import GPTConfig, build_train_step

    device = config.get("_device") or (
        "cuda" if torch.cuda.is_available() else "cpu")
    dp = int(config.get("dp_degree", 1))
    mp = int(config.get("mp_degree", 1))
    pp = int(config.get("pp_degree", 1))
    n = dp * mp * pp
    if n > _capacity(device):
        return float("inf")
    try:
        # bf16 on a card, fp32 on the CPU (the reference's split by
        # backend)
        dtype = "bfloat16" if device == "cuda" else "float32"
        model_cfg = GPTConfig(
            vocab_size=int(config.get("vocab_size", 8192)),
            hidden_size=int(config.get("hidden_size", 256)),
            num_layers=int(config.get("num_layers", 4)),
            num_heads=int(config.get("num_heads", 8)),
            max_position_embeddings=int(config.get("seq_len", 256)),
            dtype=dtype)
        mesh = None
        if n > 1:
            init_parallel_env(device=device)
            axes = [("dp", dp)] + ([("pp", pp)] if pp > 1 else []) \
                + [("mp", mp)]
            mesh = auto_mesh(*[d for _, d in axes],
                             dim_names=[name for name, _ in axes])
            mesh.groups()
        init_fn, step = build_train_step(
            model_cfg, mesh=mesh, lr=1e-4,
            remat=bool(config.get("recompute", True)), device=device)
        state = init_fn(0)
        gb = int(config.get("global_batch_size", max(8, dp)))
        seq = int(config.get("seq_len", 256))
        rng = np.random.RandomState(0)
        tokens = torch.from_numpy(
            rng.randint(0, model_cfg.vocab_size, (gb, seq))).to(device)
        labels = torch.from_numpy(
            rng.randint(0, model_cfg.vocab_size, (gb, seq))).to(device)

        def one():
            nonlocal state
            state, loss = step(state, tokens, labels)
            if device == "cuda":
                torch.cuda.synchronize()
            else:
                float(loss)

        for _ in range(warmup):
            one()
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        return (time.perf_counter() - t0) / steps
    except Exception:  # the failed trial scores +inf; its log says why
        traceback.print_exc()
        return float("inf")


def _main() -> int:
    cfg = json.loads(os.environ["PT_TRIAL_CONFIG"])
    steps = int(cfg.pop("_steps", 5))
    warmup = int(cfg.pop("_warmup", 2))
    sec = _measure_in_process(cfg, steps=steps, warmup=warmup)
    print(f"PT_TRIAL_SECONDS={sec}", flush=True)
    if _ranks(cfg) > 1:
        from paddle_tpu_torch.distributed.parallel_env import \
            destroy_process_group
        if sec == float("inf"):
            # the launcher tears the pod down: no peer waits on this rank
            return 1
        destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
