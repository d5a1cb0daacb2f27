"""Zero-dependency HTTP exporter for the live monitoring plane (the
counterpart of ``paddle_tpu/observability/exporter.py``; metric names keep
the reference's ``paddle_tpu_`` prefix, so one dashboard reads both).

A stdlib `http.server` endpoint (started by the `FLAGS_monitor` watcher
when `FLAGS_monitor_port` is set; loopback-bound by default via
`FLAGS_monitor_host`) serving:

- ``/metrics`` — Prometheus text exposition (version 0.0.4): every
  registry counter as a ``counter``, registry gauges + the monitor
  rings' newest samples as ``gauge``s, histogram count/total pairs,
  all name-sanitized and labeled with this process's trainer ``rank``.
  With a cluster source attached (rank 0 polling the cross-rank telemetry
  frames), per-rank step-rate/MFU/goodput/peak-bytes gauges plus
  straggler and skew columns ride along under ``rank`` labels.
- ``/healthz`` — liveness verdict: hang-watchdog state, last step age,
  membership epoch. A tripped hang watchdog maps to HTTP 503 so an
  external prober can page without parsing the body.
- ``/snapshot`` — the full ``observability.stats()`` JSON plus the
  monitor's newest samples and fired regressions (and the cluster rows
  when attached).
- ``/timeseries?name=`` — one ring dumped as ``[[t_wall, value], ...]``
  (no name = the series directory).

Scrapes read snapshots only; the exporter never mutates the registry.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from . import _state

_SERVER = None
_THREAD: Optional[threading.Thread] = None
_LOCK = threading.Lock()

# cluster mode: (aggregator, poll_fn) — poll_fn (may be None) refreshes
# the aggregator's frame intake before each scrape
_CLUSTER = None

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _rank() -> int:
    r = os.environ.get("PADDLE_TRAINER_ID")
    return int(r) if r and r.isdigit() else 0


def sanitize(name: str) -> str:
    """Prometheus metric-name sanitization: every illegal character
    becomes '_', a leading digit gets a '_' prefix."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _line(out: List[str], name: str, kind: str, value,
          labels: Optional[Dict[str, object]] = None,
          typed: Optional[set] = None):
    full = "paddle_tpu_" + sanitize(name)
    if typed is not None and full not in typed:
        typed.add(full)
        out.append(f"# TYPE {full} {kind}")
    lab = dict(labels or {})
    lab.setdefault("rank", _rank())
    pairs = ",".join(f'{k}="{v}"' for k, v in sorted(lab.items()))
    try:
        v = float(value)
    except (TypeError, ValueError):
        return
    body = repr(int(v)) if v == int(v) else repr(v)
    out.append(f"{full}{{{pairs}}} {body}")


# series whose dotted suffix is a label, not part of the name
_SERIES_LABELS = {"mem_device_bytes": "device", "badput_frac": "bucket"}


def render_metrics() -> str:
    """The /metrics payload (also directly callable for tests and for
    scrape-free consumers)."""
    from . import metrics, timeseries
    out: List[str] = []
    typed: set = set()
    snap = metrics.snapshot()
    for k in sorted(snap["counters"]):
        _line(out, k + "_total", "counter", snap["counters"][k],
              typed=typed)
    for k in sorted(snap["gauges"]):
        _line(out, k, "gauge", snap["gauges"][k], typed=typed)
    for k in sorted(snap["histograms"]):
        h = snap["histograms"][k]
        _line(out, k + "_count", "counter", h["count"] or 0,
              typed=typed)
        _line(out, k + "_sum", "counter", h["total"] or 0.0,
              typed=typed)
    for name, value in sorted(timeseries.latest().items()):
        base, _, tail = name.partition(".")
        key = _SERIES_LABELS.get(base)
        if key and tail:
            _line(out, "monitor_" + base, "gauge", value,
                  labels={key: tail}, typed=typed)
        else:
            _line(out, "monitor_" + sanitize(name), "gauge", value,
                  typed=typed)
    cluster = _cluster_section()
    if cluster:
        for row in cluster["rows"]:
            lab = {"rank": row["rank"]}
            for col, kind in (("steps_per_s", "gauge"),
                              ("step_time_ms", "gauge"),
                              ("mfu", "gauge"),
                              ("goodput_frac", "gauge"),
                              ("peak_bytes", "gauge"),
                              ("straggler_steps", "gauge")):
                if row.get(col) is not None:
                    _line(out, "cluster_" + col, kind, row[col],
                          labels=lab, typed=typed)
        if cluster.get("skew_us") is not None:
            _line(out, "cluster_step_skew_us", "gauge",
                  cluster["skew_us"], typed=typed)
    return "\n".join(out) + "\n"


# ------------------------------------------------------------- cluster

def attach_cluster(aggregator, poll: Optional[Callable] = None):
    """Rank 0 attaches its TelemetryAggregator (and optionally a
    refresh callable — e.g. ``lambda: agg.poll_store(store, ranks)``)
    so /metrics and /snapshot merge the whole job under rank labels."""
    global _CLUSTER
    _CLUSTER = (aggregator, poll)


def detach_cluster():
    global _CLUSTER
    _CLUSTER = None


def cluster_rows(agg) -> List[Dict]:
    """Per-rank summary rows from a TelemetryAggregator: step rate,
    mean step time, MFU, goodput fraction, peak bytes, straggler step
    count — the `top` table and the cluster /metrics section."""
    table = agg.step_table()
    rep = agg.goodput_report() or {}
    mem = (table.get("memory") or {}).get("ranks", {})
    comp = (table.get("compute") or {}).get("ranks", {})
    strag = table.get("straggler_counts", {})
    rows = []
    for r in agg.ranks:
        rs = str(r)
        durs = [row["ranks"][rs] for row in table["steps"]
                if rs in row["ranks"]]
        mean_us = (sum(durs) / len(durs)) if durs else None
        good = (rep.get("ranks", {}).get(rs) or {})
        rows.append({
            "rank": int(r),
            "steps_per_s": (round(1e6 / mean_us, 3)
                            if mean_us else None),
            "step_time_ms": (round(mean_us / 1e3, 3)
                             if mean_us else None),
            "mfu": comp.get(rs, {}).get("mfu"),
            "goodput_frac": good.get("goodput_frac"),
            "top_badput": (good.get("top_badput") or {}).get("bucket")
            if good.get("top_badput") else None,
            "peak_bytes": mem.get(rs, {}).get("peak"),
            "straggler_steps": int(strag.get(rs, 0)),
        })
    return rows


def _cluster_section() -> Optional[Dict]:
    c = _CLUSTER
    if c is None:
        return None
    agg, poll = c
    try:
        if poll is not None:
            poll()
        table_rows = cluster_rows(agg)
        skew = None
        table = agg.step_table()
        if table["steps"]:
            skew = table["steps"][-1].get("skew_us")
        return {"rows": table_rows, "skew_us": skew}
    except Exception:
        return None


def render_top(rows: List[Dict], title: str = "cluster") -> str:
    """The `python -m paddle_tpu_torch.observability top` table body."""
    lines = [f"== paddle_tpu top [{title}] ==",
             "  rank | steps/s | step ms |   MFU  | goodput | "
             "peak MB | straggler"]
    for row in rows:
        def fmt(v, spec):
            if v is None:   # keep the column width: pad the dash
                return format("-", ">" + spec.split(".")[0])
            return format(v, spec)
        strag = row.get("straggler_steps") or 0
        flag = (f"YES x{strag}" if strag else "-")
        bad = row.get("top_badput")
        good = row.get("goodput_frac")
        goodcell = (f"{good * 100:5.1f}%" if good is not None else "-")
        if bad and good is not None:
            goodcell += f" ({bad})"
        lines.append(
            f"  r{row['rank']:<3} | {fmt(row.get('steps_per_s'), '7.2f')}"
            f" | {fmt(row.get('step_time_ms'), '7.2f')}"
            f" | {fmt(row.get('mfu'), '6.4f')}"
            f" | {goodcell:>7}"
            f" | {fmt((row.get('peak_bytes') or 0) / 1048576.0, '7.1f')}"
            f" | {flag}")
    if len(lines) == 2:
        lines.append("  (no frames yet)")
    return "\n".join(lines)


# -------------------------------------------------------------- health

def health() -> Dict:
    """The /healthz verdict. Unhealthy (HTTP 503) iff the goodput hang
    watchdog has tripped; the body always carries the staleness and
    membership columns so a prober can apply its own policy too."""
    import sys
    from . import timeseries
    hang = None
    hangs = 0
    good = sys.modules.get(__package__ + ".goodput")
    if good is not None:
        hangs = good.LEDGER.hangs
        if good.LEDGER.last_hang:
            hang = {k: v for k, v in good.LEDGER.last_hang.items()
                    if k != "stacks"}
    from .._core import lazy
    return {"ok": hang is None,
            "hang": hang, "hangs": hangs,
            "last_step_age_s": timeseries.last_step_age_s(),
            "steps": timeseries.STEPS,
            "membership_epoch": lazy.MESH_EPOCH}


def snapshot() -> Dict:
    """The /snapshot payload: stats() + the monitor surface."""
    from . import stats, timeseries
    snap = stats()
    snap["rank"] = _rank()
    snap["monitor"] = {
        "series_latest": timeseries.latest(),
        "series": timeseries.series_names(),
        "steps": timeseries.STEPS,
        "tokens": timeseries.TOKENS,
        "last_step_age_s": timeseries.last_step_age_s(),
        "regressions": list(timeseries.REGRESSIONS),
    }
    cluster = _cluster_section()
    if cluster:
        snap["cluster_rows"] = cluster["rows"]
        snap["cluster_skew_us"] = cluster["skew_us"]
    return snap


# ------------------------------------------------------------- server

def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        server_version = "paddle_tpu_monitor"

        def log_message(self, *a):   # scrapes must not spam stderr
            pass

        def _send(self, code: int, body: str, ctype: str):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                url = urlparse(self.path)
                if url.path == "/metrics":
                    self._send(200, render_metrics(),
                               "text/plain; version=0.0.4; "
                               "charset=utf-8")
                elif url.path == "/healthz":
                    h = health()
                    self._send(200 if h["ok"] else 503,
                               json.dumps(h), "application/json")
                elif url.path == "/snapshot":
                    self._send(200, json.dumps(snapshot()),
                               "application/json")
                elif url.path == "/timeseries":
                    from . import timeseries
                    q = parse_qs(url.query)
                    name = (q.get("name") or [None])[0]
                    if name is None:
                        body = {"series": timeseries.series_names()}
                    else:
                        body = {"name": name,
                                "samples": timeseries.series(name)}
                    self._send(200, json.dumps(body),
                               "application/json")
                else:
                    self._send(404, json.dumps(
                        {"error": "unknown path", "paths": [
                            "/metrics", "/healthz", "/snapshot",
                            "/timeseries"]}), "application/json")
            except BrokenPipeError:
                pass
            except Exception as e:   # a bad scrape must not kill serving
                try:
                    self._send(500, json.dumps({"error": repr(e)}),
                               "application/json")
                except Exception:
                    pass

    return Handler


def start(port: int, host: str = "127.0.0.1") -> int:
    """Bind and serve on a daemon thread (idempotent); returns the
    bound port (useful with port 0)."""
    global _SERVER, _THREAD
    from http.server import ThreadingHTTPServer
    with _LOCK:
        if _SERVER is not None:
            return _SERVER.server_address[1]
        srv = ThreadingHTTPServer((host, int(port)), _make_handler())
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             name="pt-monitor-exporter", daemon=True)
        t.start()
        _SERVER, _THREAD = srv, t
        return srv.server_address[1]


def stop():
    global _SERVER, _THREAD
    with _LOCK:
        srv, t = _SERVER, _THREAD
        _SERVER = _THREAD = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=2.0)


def bound_port() -> Optional[int]:
    srv = _SERVER
    return srv.server_address[1] if srv is not None else None
