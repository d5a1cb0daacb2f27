"""Profiler statistics report (profiler_statistic.py analog): aggregate
host events into a per-name table (calls, total/avg/max/min). The
counterpart of ``paddle_tpu/profiler/statistic.py``, unchanged."""
from __future__ import annotations

from enum import Enum
from typing import List, Optional


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3


class StatisticData:
    def __init__(self, rows):
        self.rows = rows


_UNIT = {"s": 1e-6, "ms": 1e-3, "us": 1.0}


def summary(events: List[dict], sorted_by: Optional[SortedKeys] = None,
            time_unit: str = "ms") -> str:
    agg = {}
    for e in events:
        if "dur" not in e:
            continue     # counter samples (memory track) have no span
        a = agg.setdefault(e["name"],
                           {"calls": 0, "total": 0.0, "max": 0.0,
                            "min": float("inf")})
        a["calls"] += 1
        a["total"] += e["dur"]
        a["max"] = max(a["max"], e["dur"])
        a["min"] = min(a["min"], e["dur"])
    scale = _UNIT.get(time_unit, 1e-3)
    rows = [(name, a["calls"], a["total"] * scale,
             a["total"] / a["calls"] * scale, a["max"] * scale,
             a["min"] * scale if a["calls"] else 0.0)
            for name, a in agg.items()]
    key_idx = {SortedKeys.CPUTotal: 2, SortedKeys.CPUAvg: 3,
               SortedKeys.CPUMax: 4, SortedKeys.CPUMin: 5}
    rows.sort(key=lambda r: r[key_idx.get(sorted_by, 2)], reverse=True)

    header = (f"{'Name':<40}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
              f"{'Avg':>12}{'Max':>12}{'Min':>12}")
    lines = ["-" * len(header), header, "=" * len(header)]
    for name, calls, total, avg, mx, mn in rows:
        lines.append(f"{name[:39]:<40}{calls:>8}{total:>14.4f}"
                     f"{avg:>12.4f}{mx:>12.4f}{mn:>12.4f}")
    lines.append("-" * len(header))
    report = "\n".join(lines)
    print(report)
    return report
