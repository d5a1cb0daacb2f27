"""The device trace's reader: the counterpart of
``paddle_tpu/profiler/xplane.py`` (the ``cuda_tracer.cc`` role).

The reference reads the XLA profile that ``jax.profiler`` dumps: through
``jax.profiler.ProfileData``, a hand-rolled protobuf wire-format decoder of
``*.xplane.pb``, or the ``*.trace.json.gz`` beside it. The port's device
tracer is ``torch.profiler`` with CUDA activities, which writes a Kineto
chrome trace (``*.pt.trace.json``); this module reads that one format. The
XLA wire-format parser has no counterpart.

``ingest(dir) -> (events, why)`` returns the device records (kernels,
memory copies and sets) as ``{"name", "tid", "start_ns", "dur_ns"}`` plus
``launch_ns`` (the start of the CPU-side launch that the record's
``correlation`` names) and ``src`` (the ``op@file:line`` of the innermost
recorded-op scope, ``<op>[<file>:<line>]``, open on the launching thread
at the launch; see ``observability/compute.py``). Kineto stamps on its own
clock, so every time is given relative to the anchor scope the profiler
opens as the trace starts (``ANCHOR``), whose host ``perf_counter`` time
the profiler knows: adding that time rebases the events onto the host
timeline. ``why`` is non-empty when no event came back.
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
from typing import Dict, List, Tuple

# the record_function the profiler opens right after the device tracer
# starts: its trace event and a perf_counter read align the two clocks
ANCHOR = "paddle_tpu_torch::profiler_clock_anchor"

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def ingest(trace_dir: str) -> Tuple[List[dict], str]:
    """Parse the newest Kineto trace under ``trace_dir``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json*"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return [], f"no Kineto trace (*.json) under {trace_dir}"
    try:
        trace = _load(paths[-1])
    except Exception as e:
        return [], f"Kineto trace {paths[-1]} did not parse: {e!r}"
    return from_trace(trace)


def from_trace(trace: dict) -> Tuple[List[dict], str]:
    """The device events of one parsed Kineto trace (see ``ingest``)."""
    from ..observability.compute import parse_scope
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    # the host-side scope (Kineto also mirrors annotations on the device's
    # lanes, as gpu_user_annotation)
    anchor = next((e for e in evs if e.get("name") == ANCHOR
                   and e.get("cat") == "user_annotation"), None)
    if anchor is None:
        return [], "the trace holds no clock anchor"
    t0_us = float(anchor["ts"])
    launches: Dict[object, dict] = {}
    scopes: Dict[Tuple, List] = {}
    device = []
    for e in evs:
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            device.append(e)
        elif cat in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "user_annotation":
            src = parse_scope(e.get("name", ""))
            if src is not None:
                scopes.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     src))
    if not device:
        return [], "the trace holds no device record"
    starts = {}
    for k, iv in scopes.items():
        iv.sort()
        starts[k] = [s for s, _, _ in iv]
    out = []
    for e in device:
        args = e.get("args") or {}
        ev = {"name": e.get("name", ""),
              "tid": f"stream {args.get('stream', e.get('tid'))}",
              "start_ns": int((float(e["ts"]) - t0_us) * 1000),
              "dur_ns": int(float(e.get("dur", 0)) * 1000)}
        launch = launches.get(args.get("correlation"))
        if launch is not None:
            lts = float(launch["ts"])
            ev["launch_ns"] = int((lts - t0_us) * 1000)
            key = (launch.get("pid"), launch.get("tid"))
            iv = scopes.get(key)
            if iv:
                # a runner's op scopes follow one another without nesting:
                # the one open at the launch is the latest that started
                # before it, if it has not ended
                i = bisect.bisect_right(starts[key], lts) - 1
                if i >= 0 and iv[i][1] >= lts:
                    ev["src"] = iv[i][2]
        out.append(ev)
    return out, ""
