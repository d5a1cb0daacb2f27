"""Host cost of NCCL collectives at world size 1, and what it adds to the
gpt2-medium mesh step.

    python3 chip_nccl_probe.py

On a machine with a CUDA card and the CUDA toolkit. (1) For each setting
of ``TORCH_NCCL_TRACE_BUFFER_SIZE`` (unset: torch's default, NCCL's flight
recorder on, keeping each collective's stack; 2000; 0: the recorder off,
the port's default) a child process joins a one-rank NCCL group through
``distributed.init_parallel_env`` and times 300 calls of each collective
on a 16 MB bf16 tensor (and a 4 KB all-reduce), host clock around the
loop and again after a synchronize, beside a plain 16 MB copy. (2) A child
builds the kernels and times ``chip_smoke.py`` phase 18's two trainers
(gpt2-medium, b8 s1024, bf16, remat) in turns, two rounds: the
single-device step, the mesh step (dp1 x pp1 x mp1, seq_shard, ZeRO-1),
the mesh step with its NCCL calls replaced by device copies, and with its
collectives replaced by the identity (the shard-local code around them
alone); medians of 5 steps after 1 warm-up.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import torch

SETTINGS = (None, "2000", "0")  # None: the variable unset
CALLS = 300


def _port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _bench(label, fn):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  {label}: host {1e3 * (t1 - t0) / CALLS:.4f} ms a call, "
          f"{1e3 * (t2 - t0) / CALLS:.4f} with the device", flush=True)


def child() -> None:
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.distributed import (ProcessMesh,
                                              destroy_process_group,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed import _collectives as C
    if os.environ.pop("PT_PROBE_UNSET", None):
        # torch's own default: init_parallel_env would set the port's
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{_port()}", rank=0, world_size=1)
    else:
        init_parallel_env(f"tcp://127.0.0.1:{_port()}", 0, 1, "cuda")
    group = ProcessMesh([[[0]]], ["dp", "pp", "mp"]).get_group("mp")
    x = torch.randn(8, 1024, 1024, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(x)
    small = torch.randn(1024, device="cuda")
    print(f"TORCH_NCCL_TRACE_BUFFER_SIZE="
          f"{os.environ.get('TORCH_NCCL_TRACE_BUFFER_SIZE', 'unset')} (torch "
          f"{torch.__version__}, NCCL {torch.cuda.nccl.version()}, "
          f"{torch.cuda.get_device_name(0)}):", flush=True)
    _bench("copy_ 16 MB", lambda: out.copy_(x))
    _bench("all_gather 16 MB", lambda: C._all_gather_single(
        out, x, group=group))
    _bench("reduce_scatter 16 MB", lambda: C._reduce_scatter_single(
        out, x, group=group))
    _bench("all_reduce 16 MB", lambda: dist.all_reduce(x, group=group))
    _bench("all_reduce 4 KB", lambda: dist.all_reduce(small, group=group))
    destroy_process_group()


def steps() -> None:
    import numpy as np
    import torch.distributed as dist
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as cs
    from paddle_tpu_torch.distributed import (ProcessMesh,
                                              destroy_process_group,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed import _collectives as C
    from paddle_tpu_torch.models import gpt
    cs.build()
    init_parallel_env(f"tcp://127.0.0.1:{_port()}", 0, 1, "cuda")
    mesh = ProcessMesh([[[0]]], ["dp", "pp", "mp"])
    cfg = gpt.GPT_CONFIGS["gpt2-medium"]
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (cs.BATCH, cs.SEQ))).cuda()
    labels = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (cs.BATCH, cs.SEQ))).cuda()
    init_s, step_s = gpt.build_train_step(cfg, lr=1e-4, remat=True,
                                          device="cuda")
    init_m, step_m = gpt.build_train_step(
        cfg, mesh=mesh, lr=1e-4, seq_shard=True, zero1=True, remat=True,
        device="cuda")
    state_s, state_m = init_s(0), init_m(0)
    names = ("_all_gather_single", "_reduce_scatter_single", "all_gather",
             "reduce_scatter", "all_reduce")
    real = {n: getattr(C, n) for n in names}
    real_all_reduce = dist.all_reduce

    def as_copies():
        C._all_gather_single = lambda out, src, group=None: out.copy_(src)
        C._reduce_scatter_single = \
            lambda out, src, op=None, group=None: out.copy_(src)
        dist.all_reduce = lambda t, op=None, group=None: None

    def as_identity():
        C.all_gather = lambda x, dim, group: x
        C.reduce_scatter = lambda x, dim, group: x
        C.all_reduce = lambda x, group, op=None: x

    def restore():
        for n, f in real.items():
            setattr(C, n, f)
        dist.all_reduce = real_all_reduce

    print(f"gpt2-medium b{cs.BATCH} s{cs.SEQ} steps in turns on "
          f"{torch.cuda.get_device_name(0)}:", flush=True)
    for rnd in range(2):
        for label, patch, step, state in (
                ("single-device", None, step_s, state_s),
                ("mesh", None, step_m, state_m),
                ("mesh, NCCL calls as copies", as_copies, step_m, state_m),
                ("mesh, collectives as identity", as_identity, step_m,
                 state_m),
                ("mesh", None, step_m, state_m),
                ("single-device", None, step_s, state_s)):
            if patch is not None:
                patch()
            try:
                ms = cs._turns(step, state, tokens, labels, 6)
            finally:
                restore()
            print(f"  round {rnd} {label}: median "
                  f"{float(np.median(ms[1:])):.2f} ms "
                  f"({[round(x, 1) for x in ms[1:]]})", flush=True)
    destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_nccl_probe: no CUDA device", file=sys.stderr)
        return 1
    ifname = os.environ.get("NCCL_SOCKET_IFNAME", "lo")
    runs = [("--child", s) for s in SETTINGS] + [("--steps", "0")]
    for flag, setting in runs:
        env = dict(os.environ, NCCL_SOCKET_IFNAME=ifname)
        env.pop("TORCH_NCCL_TRACE_BUFFER_SIZE", None)
        if setting is None:
            env["PT_PROBE_UNSET"] = "1"
        else:
            env["TORCH_NCCL_TRACE_BUFFER_SIZE"] = setting
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               flag], env=env, timeout=600)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    elif sys.argv[1:] == ["--steps"]:
        steps()
    else:
        sys.exit(main())
