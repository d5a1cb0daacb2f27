"""CLI: run a small workload with telemetry on and print the stats (the
counterpart of ``python -m paddle_tpu.observability``).

    python -m paddle_tpu_torch.observability [stats|budget|merge|top]
        [--model chain|lenet|resnet50|gpt2] [--steps N] [--device D]
        [--json] [--trace PATH] [--flight] [--async-flush]
        [--distributed] [--nranks N]
        merge <dir>
        top [--port P | --store DIR] [--interval S] [--count N]

Modes:

- ``stats`` (default): run the workload with metrics on, print the
  registry snapshot (counters / derived rates / histograms).
- ``budget``: the per-step time-budget profile — spans aggregated into
  a ranked table (segment flush/build/execute, sot::, optimizer::,
  comm::, io::, plus the unspanned **host gap**), with the memory,
  compute (achieved GFLOP/s, MFU against the device's peak, the
  roofline verdict) and goodput columns (observability/budget.py).
  ``--static-diff`` needs the analysis plane's perf checker and raises
  ``NotImplementedError``.
- ``budget --distributed``: spawns ``--nranks`` local trainer ranks over
  ``paddle_tpu_torch.distributed.launch``, each publishing telemetry
  frames through a shared TCPStore while running compute and an
  all-reduce a step; rank 0 merges them and the command prints the
  cluster step table, the comm-overlap report and the goodput report,
  leaving the per-rank dumps and the merged chrome trace in a scratch
  dir. On the card each rank takes a card of its own (NCCL: two ranks
  cannot share one), so ``--nranks`` past the cards present is refused
  with exit code 2; ``--device cpu`` runs any number of ranks over gloo.
- ``merge <dir>``: offline aggregation of ``telem_rank*.json`` dumps into
  the same tables, and ``merged_trace.json`` beside them.
- ``top``: a refreshing per-rank table from a live monitor endpoint
  (``--port``/``--host``, the ``/snapshot`` route of a job running with
  FLAGS_monitor + FLAGS_monitor_port) or a dumped-frames dir (``--store
  DIR``); ``--count N`` stops after N renders (0 = until interrupted).

`chain` is an elementwise chain (segment record/flush/cache); `lenet`
runs train steps fed by a DataLoader through DevicePrefetcher; `resnet50`
and `gpt2` run the eager train loops (batch via BUDGET_BATCH; the GPT's
widths via BUDGET_GPT_LAYERS/HIDDEN/SEQ). Each step runs inside
``lazy_guard()``: the port's ambient window is off by default. The
workloads run on the card unless ``--device cpu`` is given, as every
entry point of the port does. `--trace PATH` also records the run under a
fused-runtime profiler and exports the chrome trace;
`--async-flush` turns the async flush on for the run. Exit code 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _run_chain(steps: int):
    import numpy as np
    import paddle_tpu_torch as paddle

    x = paddle.to_tensor(np.ones((16, 16), "float32"))
    for _ in range(steps):
        with paddle.framework.lazy_guard():
            y = x
            for _ in range(16):
                y = y * 1.0001 + 0.0001
        y.numpy()


def _train_loop(model, opt, x, y, loss_fn):
    import paddle_tpu_torch as paddle

    def one():
        with paddle.framework.lazy_guard():
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        float(loss)
    return one


def _lenet_step():
    """LeNet train step fed through the REAL input path — a DataLoader
    wrapped in DevicePrefetcher (FLAGS_prefetch_depth double buffer) —
    so the budget's host gap includes input feed the way a training
    loop pays it."""
    import numpy as np
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.io import DataLoader, Dataset, DevicePrefetcher
    from paddle_tpu_torch.vision.models import LeNet

    paddle.seed(0)
    model = LeNet()
    opt = paddle.optimizer.Adam(1e-3, parameters=model.parameters())
    rng = np.random.RandomState(0)
    b = int(os.environ.get("BUDGET_BATCH", "32"))
    xs = rng.randn(4 * b, 1, 28, 28).astype(np.float32)
    ys = rng.randint(0, 10, (4 * b,)).astype(np.int64)

    class _Synth(Dataset):
        def __len__(self):
            return len(xs)

        def __getitem__(self, i):
            return xs[i], ys[i]

    def batches():
        while True:
            for xb, yb in DevicePrefetcher(
                    DataLoader(_Synth(), batch_size=b, drop_last=True)):
                yield xb, yb

    feed = batches()

    def one():
        x, y = next(feed)
        with paddle.framework.lazy_guard():
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        float(loss)
    return one


def _resnet50_step():
    import numpy as np
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision.models import resnet50

    # the eager train step records more than 256 ops: a cap that keeps
    # it one segment keeps it on the fused step
    paddle.set_flags({"FLAGS_lazy_max_segment_ops": 1024})
    paddle.seed(0)
    model = resnet50()
    opt = paddle.optimizer.Momentum(0.1, parameters=model.parameters())
    rng = np.random.RandomState(0)
    b = int(os.environ.get("BUDGET_BATCH", "4"))
    x = paddle.to_tensor(rng.randn(b, 3, 224, 224).astype(np.float32))
    y = paddle.to_tensor(rng.randint(0, 1000, (b,)).astype(np.int64))
    return _train_loop(model, opt, x, y, F.cross_entropy)


def _gpt2_step():
    """Eager dygraph GPT train step (the fusion-window path). Layer
    count/width via BUDGET_GPT_LAYERS/HIDDEN/SEQ; its attention runs the
    port's flash kernels on the card."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTPretrainingCriterion)

    paddle.seed(0)
    cfg = GPTConfig(
        vocab_size=1024,
        hidden_size=int(os.environ.get("BUDGET_GPT_HIDDEN", "128")),
        num_layers=int(os.environ.get("BUDGET_GPT_LAYERS", "4")),
        num_heads=4, dtype="float32", use_flash_attention=False,
        max_position_embeddings=int(os.environ.get("BUDGET_GPT_SEQ",
                                                   "128")))
    model = GPTForPretraining(cfg)
    crit = GPTPretrainingCriterion()
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters())
    rng = np.random.RandomState(0)
    b = int(os.environ.get("BUDGET_BATCH", "2"))
    seq = cfg.max_position_embeddings
    x = paddle.to_tensor(rng.randint(0, cfg.vocab_size,
                                     (b, seq)).astype(np.int64))
    y = paddle.to_tensor(rng.randint(0, cfg.vocab_size,
                                     (b, seq)).astype(np.int64))

    def one():
        # one expression: a surviving grad-requiring `logits` local
        # would route backward() to the engine instead of the fused step
        with paddle.framework.lazy_guard():
            loss = crit(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
        float(loss)
    return one


_MODELS = {"chain": None, "lenet": _lenet_step,
           "resnet50": _resnet50_step, "gpt2": _gpt2_step}


# ------------------------------------------------- distributed budget
# One trainer rank of the local drill: a compute chain and an all-reduce a
# step under ElasticStep (so the step:: fault sites and the telemetry
# on_step hook both fire), frames published through the shared TCPStore.
# Env knobs (set by the CLI or a test):
#   TELEM_OUT        output dir (dumps, merged artifacts)
#   TELEM_DEVICE     gpu (rank r on card r, NCCL beside gloo) or cpu
#   TELEM_STEPS      steps per rank
#   TELEM_SLOW_RANK  optional straggler: that rank runs with an injected
#                    step::*=delay fault (TELEM_SLOW_DELAY s)
#   TELEM_KILL_RANK/TELEM_KILL_STEP  optional death drill: SIGKILL self
#                    after that step; the kill rank is left out of the
#                    comm group, so the survivors' collectives never wait
#                    for a dead peer
_DISTRIBUTED_DRILL = """
import json, os, signal, sys, time
import numpy as np
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.communication import all_reduce
from paddle_tpu_torch.distributed.resilience import ElasticStep
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import distributed as dtel

RANK = int(os.environ["PADDLE_TRAINER_ID"])
WORLD = int(os.environ["PADDLE_TRAINERS_NUM"])
OUT = os.environ["TELEM_OUT"]
STEPS = int(os.environ.get("TELEM_STEPS", "10"))
SLOW = int(os.environ.get("TELEM_SLOW_RANK", "-1"))
KILL = int(os.environ.get("TELEM_KILL_RANK", "-1"))
KILL_STEP = int(os.environ.get("TELEM_KILL_STEP", "2"))
DEVICE = os.environ.get("TELEM_DEVICE", "cpu")

paddle.set_device("gpu:%d" % RANK if DEVICE == "gpu" else "cpu")
paddle.set_flags({"FLAGS_observability": True,
                  "FLAGS_flight_recorder": True,
                  "FLAGS_distributed_telemetry": True,
                  "FLAGS_memory_telemetry": True,
                  "FLAGS_compute_telemetry": True,
                  "FLAGS_goodput": True})
if RANK == SLOW:
    delay = os.environ.get("TELEM_SLOW_DELAY", "0.05")
    paddle.set_flags({"FLAGS_fault_inject":          # @* = every step
                      "step::*@*=delay(%s)" % delay})

store = TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                 is_master=(RANK == 0), world_size=WORLD, timeout=120)
dist.rebuild_world(range(WORLD), 0, store=store, device=DEVICE)
pub = dtel.init(store, rank=RANK, world_size=WORLD)

comm_ranks = [r for r in range(WORLD) if r != KILL]
group = dist.new_group(comm_ranks) if len(comm_ranks) > 1 else None
if RANK not in comm_ranks:
    group = None

x = paddle.to_tensor(np.ones((64, 64), "float32"))
grad = paddle.to_tensor(np.ones((256, 256), "float32"))  # 256 KB payload
w = paddle.create_parameter([64, 64], "float32")
opt = paddle.optimizer.SGD(0.0, parameters=[w])
elastic = ElasticStep(optimizer=opt)


def step():
    with paddle.framework.lazy_guard():
        y = x
        for _ in range(16):
            y = y * 1.0001 + 0.0001
    y.numpy()                              # compute lands
    if group is not None:
        all_reduce(grad, group=group)      # host-driven gradient sync
    return y


for s in range(1, STEPS + 1):
    elastic.run(step)
    if RANK == KILL and s == KILL_STEP:
        pub.flush()
        os.kill(os.getpid(), signal.SIGKILL)

pub.flush()
pub.dump(OUT)
if group is not None:
    dist.barrier(group)                    # every dump and frame landed
post = None
if KILL >= 0:
    # death drill: survivors publish their flight rings; rank 0 also
    # aggregates the interleaved report (grace-bounded store polls)
    post = dtel.trigger_postmortem(
        "drill: rank %d killed at step %d" % (KILL, KILL_STEP))

if RANK == 0:
    agg = dtel.TelemetryAggregator()
    agg.poll_store(store, list(range(WORLD)))
    for r in range(WORLD):   # prefer full offline dumps when present
        p = os.path.join(OUT, "telem_rank%d.json" % r)
        if os.path.exists(p):
            agg.add_dump(p)
    out = {"nranks": WORLD, "steps": STEPS,
           "step_table": agg.step_table(),
           "overlap": agg.overlap_report(),
           "goodput": agg.goodput_report(),
           "postmortem": post}
    agg.merged_trace(os.path.join(OUT, "merged_trace.json"))
    with open(os.path.join(OUT, "distributed_budget.json"), "w") as f:
        json.dump(out, f)
if group is not None:
    dist.barrier(group)                    # hold the store master open
pub.shutdown()
store.close()
os._exit(0)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _budget_distributed(args) -> int:
    """Spawn `--nranks` local ranks over the distributed launcher, let
    rank 0 aggregate, print the merged step table + overlap report. On
    the card, one card a rank."""
    import subprocess
    import tempfile

    device = args.device.split(":")[0]
    if device in ("gpu", "cuda"):
        import torch
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if args.nranks > cards:
            print(f"budget --distributed on the card runs one rank a card: "
                  f"--nranks {args.nranks} asks for {args.nranks} cards and "
                  f"{cards} are present; pass --nranks {cards} or less, or "
                  f"--device cpu", file=sys.stderr)
            return 2
        device = "gpu"
    elif device != "cpu":
        print(f"unknown --device {args.device!r}: gpu or cpu",
              file=sys.stderr)
        return 2
    out_dir = args.out or tempfile.mkdtemp(prefix="pt_telem_")
    os.makedirs(out_dir, exist_ok=True)
    script = os.path.join(out_dir, "_telem_drill.py")
    with open(script, "w") as f:
        f.write(_DISTRIBUTED_DRILL)
    env = dict(os.environ)
    # the ranks start in out_dir: they find this checkout's package
    # through the path, as this process found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env["TELEM_OUT"] = out_dir
    env["TELEM_STEPS"] = str(args.steps)
    env["TELEM_DEVICE"] = device
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(args.nranks),
         "--elastic_mode", "shrink", "--min_np", "1",
         "--log_dir", os.path.join(out_dir, "log"),
         "--master", f"127.0.0.1:{_free_port()}", script],
        env=env, cwd=out_dir, capture_output=True, text=True,
        timeout=600)
    result_path = os.path.join(out_dir, "distributed_budget.json")
    if proc.returncode != 0 or not os.path.exists(result_path):
        sys.stderr.write(proc.stderr)
        logdir = os.path.join(out_dir, "log")
        if os.path.isdir(logdir):
            for name in sorted(os.listdir(logdir)):
                with open(os.path.join(logdir, name)) as f:
                    tail = f.read()[-1500:]
                sys.stderr.write(f"\n--- {name}\n{tail}\n")
        print(f"distributed budget failed (rc={proc.returncode})",
              file=sys.stderr)
        return proc.returncode or 1
    with open(result_path) as f:
        out = json.load(f)
    out["out_dir"] = out_dir
    if args.json:
        print(json.dumps(out))
    else:
        from paddle_tpu_torch.observability import distributed as dtel
        print(dtel.render_step_table(out["step_table"]))
        print(dtel.render_overlap(out["overlap"]))
        print(dtel.render_goodput(out.get("goodput")))
        if out.get("postmortem"):
            print(f"distributed postmortem: {out['postmortem']}")
        print(f"artifacts (dumps, merged_trace.json) in {out_dir}")
    return 0


def _merge(args) -> int:
    """Offline aggregation over telem_rank*.json dumps in a dir."""
    import glob

    from paddle_tpu_torch.observability import distributed as dtel

    d = args.path
    if not d or not os.path.isdir(d):
        print(f"merge: {d!r} is not a directory", file=sys.stderr)
        return 2
    dumps = sorted(glob.glob(os.path.join(d, "telem_rank*.json")))
    if not dumps:
        print(f"merge: no telem_rank*.json dumps in {d}",
              file=sys.stderr)
        return 2
    agg = dtel.TelemetryAggregator()
    for p in dumps:
        agg.add_dump(p)
    trace_path = os.path.join(d, "merged_trace.json")
    agg.merged_trace(trace_path)
    out = {"ranks": agg.ranks, "step_table": agg.step_table(),
           "overlap": agg.overlap_report(),
           "goodput": agg.goodput_report(), "trace": trace_path}
    if args.json:
        print(json.dumps(out))
    else:
        print(dtel.render_step_table(out["step_table"]))
        print(dtel.render_overlap(out["overlap"]))
        if out.get("goodput"):
            print(dtel.render_goodput(out["goodput"]))
        print(f"merged chrome trace written to {trace_path}")
    return 0


def _top_once(args) -> str:
    """One rendered top table (store dir or live endpoint)."""
    from paddle_tpu_torch.observability import exporter

    if args.store:
        import glob

        from paddle_tpu_torch.observability import distributed as dtel
        dumps = sorted(glob.glob(
            os.path.join(args.store, "telem_rank*.json")))
        if not dumps:
            raise FileNotFoundError(
                f"top: no telem_rank*.json dumps in {args.store}")
        agg = dtel.TelemetryAggregator()
        for p in dumps:
            agg.add_dump(p)
        return exporter.render_top(exporter.cluster_rows(agg),
                                   title=args.store)
    import urllib.request
    url = f"http://{args.host}:{args.port}/snapshot"
    with urllib.request.urlopen(url, timeout=10) as resp:
        snap = json.loads(resp.read().decode("utf-8"))
    rows = snap.get("cluster_rows")
    if rows is None:
        # single-process job: one row from the monitor's newest samples
        mon = snap.get("monitor", {})
        s = mon.get("series_latest", {})
        rows = [{"rank": snap.get("rank", 0),
                 "steps_per_s": s.get("steps_per_s"),
                 "step_time_ms": s.get("step_time_ms"),
                 "mfu": s.get("mfu"),
                 "goodput_frac": s.get("goodput_frac"),
                 "peak_bytes": s.get("mem_peak_bytes"),
                 "straggler_steps": 0}]
    return exporter.render_top(rows, title=url)


def _top(args) -> int:
    import time as _time
    n = 0
    while True:
        try:
            text = _top_once(args)
        except (OSError, FileNotFoundError) as e:
            print(f"top: {e}", file=sys.stderr)
            return 2
        if args.count != 1:
            sys.stdout.write("\x1b[2J\x1b[H")   # clear + home
        print(text, flush=True)
        n += 1
        if args.count and n >= args.count:
            return 0
        try:
            _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def _render(snap: dict) -> str:
    lines = ["== paddle_tpu_torch.observability stats =="]
    lines.append(f"  compiles:            {snap['compiles']}")
    for k in ("cache_hit_rate", "step_cache_hit_rate"):
        v = snap[k]
        lines.append(f"  {k + ':':<21}"
                     + ("n/a" if v is None else f"{v:.3f}"))
    mem = snap.get("memory")
    if mem:
        lines.append(f"  memory:              live {mem['live_bytes']} B"
                     f", peak {mem['peak_bytes']} B, donated "
                     f"{mem['donated_bytes']} B, census {mem['census']} "
                     f"buffer(s)")
    good = snap.get("goodput")
    if good and good.get("goodput_frac") is not None:
        top = good.get("top_badput")
        lines.append(
            f"  goodput:             "
            f"{good['goodput_frac'] * 100.0:.1f}% productive over "
            f"{good['steps']} step(s)"
            + (f", top badput {top['bucket']}" if top else ""))
    lines.append("  counters:")
    for k in sorted(snap["counters"]):
        lines.append(f"    {k:<40} {snap['counters'][k]}")
    if snap["histograms"]:
        lines.append("  histograms (us):")
        for k in sorted(snap["histograms"]):
            h = snap["histograms"][k]
            if not h["count"]:
                continue
            lines.append(
                f"    {k:<40} n={h['count']} avg={h['avg']:.1f} "
                f"min={h['min']:.1f} max={h['max']:.1f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability")
    ap.add_argument("mode", nargs="?", default="stats",
                    choices=("stats", "budget", "merge", "top"),
                    help="stats = registry snapshot; budget = ranked "
                         "per-step time-budget table; merge = offline "
                         "aggregation of per-rank telemetry dumps; "
                         "top = refreshing per-rank cluster table from "
                         "a live monitor endpoint or dumped frames")
    ap.add_argument("path", nargs="?", default=None,
                    help="merge mode: directory holding "
                         "telem_rank*.json dumps")
    ap.add_argument("--model", default="chain",
                    choices=tuple(_MODELS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="gpu",
                    help="where the workload runs: gpu (the card, the "
                         "default) or cpu; budget --distributed on gpu "
                         "takes a card a rank")
    ap.add_argument("--distributed", action="store_true",
                    help="budget mode: spawn --nranks local trainer "
                         "ranks over the launcher and print the merged "
                         "cross-rank step table + comm-overlap report "
                         "(on gpu one card a rank, NCCL; --device cpu "
                         "for more ranks than cards, gloo)")
    ap.add_argument("--nranks", type=int, default=4,
                    help="rank count for budget --distributed")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="budget --distributed: artifact directory "
                         "(default: a fresh temp dir)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="also export a fused-runtime chrome trace")
    ap.add_argument("--flight", action="store_true",
                    help="enable the flight recorder and print the ring")
    ap.add_argument("--async-flush", action="store_true",
                    help="run with FLAGS_async_flush on (before/after "
                         "budget comparisons from one command)")
    ap.add_argument("--port", type=int, default=0,
                    help="top mode: live monitor endpoint port "
                         "(FLAGS_monitor_port of the running job)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="top mode: live monitor endpoint host")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="top mode: render from telem_rank*.json "
                         "dumps in DIR instead of a live endpoint")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="top mode: refresh period in seconds")
    ap.add_argument("--count", type=int, default=0,
                    help="top mode: stop after N renders "
                         "(0 = until interrupted)")
    ap.add_argument("--static-diff", action="store_true",
                    help="budget mode: reconcile the static perf "
                         "analyzer against the meters (needs the "
                         "analysis plane: raises NotImplementedError)")
    args = ap.parse_args(argv)

    if args.mode == "merge":
        return _merge(args)
    if args.mode == "top":
        if not args.store and not args.port:
            print("top: pass --port (live endpoint) or --store DIR "
                  "(dumped frames)", file=sys.stderr)
            return 2
        return _top(args)
    if args.mode == "budget" and args.distributed:
        return _budget_distributed(args)

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import observability as obs

    paddle.set_device(args.device)
    if args.async_flush:
        paddle.set_flags({"FLAGS_async_flush": True})

    if args.mode == "budget":
        from paddle_tpu_torch.observability import budget as _budget
        make = _MODELS[args.model]
        step = (lambda: _run_chain(1)) if make is None else make()
        if args.static_diff:
            out = _budget.static_diff(step, steps=args.steps)
            out["model"] = args.model
            print(json.dumps(out) if args.json
                  else _budget.render_static_diff(
                      out, f"static vs measured [{args.model}]"))
            return 0 if out["ok"] else 1
        out = _budget.collect(step, steps=args.steps)
        out["model"] = args.model
        out["async_flush"] = bool(args.async_flush)
        print(json.dumps(out) if args.json
              else _budget.render(out, f"per-step budget [{args.model}]"))
        from paddle_tpu_torch._core import async_flush
        async_flush.drain()
        return 0

    obs.enable(flight_recorder=args.flight or None)
    obs.reset()
    if args.model == "chain":
        run = _run_chain
    else:
        step = _MODELS[args.model]()

        def run(steps):
            for _ in range(steps):
                step()

    if args.trace:
        from paddle_tpu_torch.profiler import Profiler, ProfilerTarget
        with Profiler(targets=[ProfilerTarget.CPU],
                      fused_runtime=True) as p:
            run(args.steps)
        path = p.export(args.trace)
        print(f"chrome trace written to {path}", file=sys.stderr)
    else:
        run(args.steps)

    # land any in-flight async flushes BEFORE snapshotting: counters
    # mid-flight would under-report, and an unread worker failure must
    # fail the command, not vanish into the atexit shutdown
    from paddle_tpu_torch._core import async_flush
    async_flush.drain()
    snap = obs.stats()
    print(json.dumps(snap) if args.json else _render(snap))
    if args.flight:
        print(obs.flight_record())
    return 0


if __name__ == "__main__":
    sys.exit(main())
