"""Cost-based planner for static auto-parallel, the counterpart of
``paddle_tpu/distributed/auto_parallel/planner.py`` (upstream
``auto_parallel/static/planner_v2.py`` + ``cost_model.py`` + ``tuner/``).

The completion pass propagates shardings by rule; this module adds the
cost layer upstream puts behind planner_v2:

- ``CostModel``: per-op flops and per-tensor comm-byte estimates with an
  alpha-beta (latency + bandwidth) comm time model, the role of
  upstream's OpCost/CommCost registries (``cost/comp_op_cost.py``,
  ``comm_op_cost.py``).
- ``plan_stage_map``: balanced pipeline-stage cuts by dynamic programming
  over the op chain, minimizing the bottleneck stage's compute, then the
  bytes crossing the cuts.
- ``score_sharding_candidates``: ranks candidate placements for a value
  by the comm volume they imply (partial allreduce bytes).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class CostModel:
    """Alpha-beta comm + roofline compute estimates.

    The defaults are the NVIDIA H100 80GB HBM3's data-sheet figures (SXM
    part, 700 W power limit, as ``nvidia-smi`` names the card the port
    runs on): 989e12 FLOP/s dense bf16 and 450e9 bytes/s of NVLink each
    way (900e9 both ways). They are spec figures, not measurements; only
    their ratios matter for planning."""

    def __init__(self, flops_per_s: float = 989e12,
                 bytes_per_s: float = 450e9,
                 latency_s: float = 1e-6,
                 dtype_bytes: int = 4):
        self.flops_per_s = flops_per_s
        self.bytes_per_s = bytes_per_s
        self.latency_s = latency_s
        self.dtype_bytes = dtype_bytes

    # ------------------------------------------------------------- shapes
    @staticmethod
    def _shape_of(var) -> Tuple[int, ...]:
        return tuple(getattr(var, "var_shape",
                             getattr(var, "shape", ())) or ())

    def var_bytes(self, var) -> float:
        shape = self._shape_of(var)
        return float(np.prod(shape)) * self.dtype_bytes if shape else \
            float(self.dtype_bytes)

    # -------------------------------------------------------------- costs
    def op_flops(self, node) -> float:
        """Name-keyed flops estimate (comp_op_cost.py role)."""
        name = getattr(node, "op_name", "")
        outs = [self._shape_of(v) for v in getattr(node, "outputs", [])]
        ins = [self._shape_of(v) for v in getattr(node, "inputs", [])]
        out_elems = sum(float(np.prod(s)) for s in outs if s)
        if name in ("matmul", "linear", "mv", "addmm"):
            # 2 * (output elements) * contraction length
            k = ins[0][-1] if ins and ins[0] else 1
            if name == "matmul" and len(ins) > 1 and ins[1]:
                # respect transpose-free [.., k] x [k, n]
                k = ins[1][0] if len(ins[1]) >= 1 else k
            return 2.0 * out_elems * float(k)
        if name in ("conv2d", "conv_nd"):
            return 18.0 * out_elems          # k*k*cin heuristic
        if name in ("softmax", "gelu", "tanh", "sigmoid"):
            return 5.0 * out_elems
        return out_elems                      # elementwise default

    def compute_time(self, node) -> float:
        return self.op_flops(node) / self.flops_per_s

    def comm_time(self, nbytes: float) -> float:
        """alpha-beta time for moving nbytes (callers apply collective
        volume factors like the ring's 2(n-1)/n before calling)."""
        if nbytes <= 0:
            return 0.0
        return self.latency_s + nbytes / self.bytes_per_s


def plan_stage_map(ws, n_stages: int,
                   cost_model: Optional[CostModel] = None) -> List[int]:
    """Balanced contiguous stage cuts via DP (planner_v2 role).

    Returns op_index -> stage. Minimizes the BOTTLENECK stage COMPUTE
    time (steady-state pipeline throughput is set by the slowest stage,
    with P2P overlapping compute), tie-broken by total bytes crossing
    the chosen cuts. O(n^2 * stages).
    """
    cm = cost_model or CostModel()
    ops = list(ws.ops)
    n = len(ops)
    if n == 0 or n_stages <= 1:
        return [0] * n
    n_stages = min(n_stages, n)
    comp = [cm.compute_time(op) for op in ops]
    prefix = np.concatenate([[0.0], np.cumsum(comp)])

    # bytes crossing a cut at position j (vars produced < j, consumed >= j)
    produced_at: Dict[int, int] = {}
    for i, op in enumerate(ops):
        for v in getattr(op, "outputs", []):
            produced_at[id(v)] = i
    # a var crossing a cut is ONE send regardless of how many later
    # ops consume it: accumulate per var over [producer+1, last_consumer]
    last_use: Dict[int, int] = {}
    var_of: Dict[int, object] = {}
    for i, op in enumerate(ops):
        for v in getattr(op, "inputs", []):
            p = produced_at.get(id(v))
            if p is None or p >= i:
                continue
            last_use[id(v)] = max(last_use.get(id(v), 0), i)
            var_of[id(v)] = v
    cross = [0.0] * (n + 1)
    for vid, i in last_use.items():
        p = produced_at[vid]
        b = cm.var_bytes(var_of[vid])
        for j in range(p + 1, i + 1):
            cross[j] += b

    # Objective (lexicographic): minimize the BOTTLENECK stage compute —
    # steady-state pipeline throughput is set by the slowest stage, with
    # P2P sends overlapping compute — then, among equal bottlenecks,
    # minimize total bytes crossing the cuts (upstream's cost model
    # treats comm as a secondary term the tuner breaks ties with).
    INF = (float("inf"), float("inf"))
    # f[s][i]: (bottleneck, comm bytes) for first i ops in s stages
    f = [[INF] * (n + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(n_stages + 1)]
    f[0][0] = (0.0, 0.0)
    for s in range(1, n_stages + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                fb, fc = f[s - 1][j]
                v = (max(fb, prefix[i] - prefix[j]),
                     fc + (cross[j] if j > 0 else 0.0))
                if v < f[s][i]:
                    f[s][i] = v
                    cut[s][i] = j
    # backtrack
    bounds = [n]
    i = n
    for s in range(n_stages, 0, -1):
        i = cut[s][i]
        bounds.append(i)
    bounds = list(reversed(bounds))   # [0, c1, ..., n]
    stage_map = [0] * n
    for s in range(n_stages):
        for i in range(bounds[s], bounds[s + 1]):
            stage_map[i] = s
    return stage_map


def stage_loads(ws, stage_map: Sequence[int],
                cost_model: Optional[CostModel] = None) -> List[float]:
    """Per-stage compute time under a given map (for tests/benchmarks)."""
    cm = cost_model or CostModel()
    n_stages = (max(stage_map) + 1) if stage_map else 1
    loads = [0.0] * n_stages
    for i, op in enumerate(ws.ops):
        loads[stage_map[i]] += cm.compute_time(op)
    return loads


def score_sharding_candidates(var, candidates, mesh,
                              cost_model: Optional[CostModel] = None
                              ) -> List[Tuple[float, int]]:
    """Rank candidate placements for one value by implied comm cost
    (tuner role). Each candidate: (dims_mapping, partial_axes) — a
    partial axis means a pending allreduce of the FULL value over that
    mesh axis; a sharded dim divides the bytes moved on reshard.

    Returns [(cost_seconds, candidate_index)] sorted ascending.
    """
    cm = cost_model or CostModel()
    nbytes = cm.var_bytes(var)
    out = []
    for idx, (dims_mapping, partial_axes) in enumerate(candidates):
        shard_frac = 1.0
        for m in dims_mapping:
            if m != -1:
                shard_frac /= max(mesh.shape[m], 1)
        cost = 0.0
        for ax in (partial_axes or ()):
            g = mesh.shape[ax]
            # ring allreduce moves 2(g-1)/g of the value
            cost += cm.comm_time(nbytes * shard_frac
                                 * 2 * (g - 1) / max(g, 1))
        out.append((cost, idx))
    out.sort()
    return out
