"""Does ``torch.profiler`` keep every device record of a short trace in a
process that has run the card for a while? Run on one CUDA card::

    python3 chip_profiler_probe.py

Each probe traces two pinned host-to-device copies (one on a side stream,
one on the default stream) and 22 small kernels, after a host-side wait
inside the trace, and prints how many device records the trace kept (24
wanted; the allocator may add two fills) and the spread of (device start
- launch) on the trace's clock. Probes run at start, after 120 s of
8192² matmuls, and after ``chip_smoke.py``'s build and phase 3 (the
kernel checks)."""
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs


def probe(label, delay_ms):
    side = torch.cuda.Stream()
    host = torch.arange(8192, dtype=torch.int32).pin_memory()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(delay_ms / 1e3)
        with torch.cuda.stream(side):
            a = host.to("cuda", non_blocking=True)
        b = host.to("cuda", non_blocking=True)
        for _ in range(20):
            a = a + 1
        (a.float() + b.float()).sum()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f).get("traceEvents", [])
    rt = {(e.get("args") or {}).get("correlation"): e for e in ev
          if e.get("cat") == "cuda_runtime"}
    gpu = [e for e in ev if e.get("cat") in ("gpu_memcpy", "kernel")]
    lag = [e["ts"] - rt[e["args"]["correlation"]]["ts"] for e in gpu
           if (e.get("args") or {}).get("correlation") in rt]
    h2d = sum("HtoD" in e["name"] for e in gpu)
    print(f"PROBE {label} delay {delay_ms} ms: device records {len(gpu)} "
          f"(want 24: 2 HtoD, 22 kernels), HtoD {h2d}, runtime calls "
          f"{len(rt)}; device ts - launch ts, us: min "
          f"{min(lag) if lag else None} max {max(lag) if lag else None}",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.card()
    for d in (0, 0, 20):
        probe("at start", d)
    x = torch.randn(8192, 8192, device="cuda")
    t1 = time.perf_counter()
    while time.perf_counter() - t1 < 120:
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()
    for d in (0, 5, 20, 100, 500):
        probe("after 120 s of matmuls", d)
    cs.build()
    with cs.watchdog("phase 3", 300):
        cs.kernel_checks()
    for d in (0, 5, 20, 100, 500, 2000):
        probe("after phase 3", d)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
