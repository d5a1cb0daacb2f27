"""Distributed static checks: reshard placement + pipeline schedules, the
counterpart of ``paddle_tpu/analysis/distributed_checks.py``.

Two checker families over the hand-written SPMD/pipeline orchestration
(the 2112.02752 adaptive-distributed layer this repo reproduces):

- `check_reshard`: a reshard src/dst pair is validated against the
  SPMD placement rules BEFORE any collective is planned — placement
  rank vs. mesh rank, shard dims vs. the tensor's global rank, uneven
  shard divisibility (NamedSharding requires equal chunks), Partial
  reduce-type algebra, and the equal-but-distinct-mesh trap (pairwise
  functions dispatch on mesh IDENTITY, so two `__eq__`-equal meshes
  silently take the gather-everything cross-mesh path).
- `check_pipeline_schedule` / `simulate_pipeline`: the host-driven
  schedules (FThenB / 1F1B / VPP interleave / ZeroBubble) lower to
  per-rank programs of blocking recvs and buffered sends over the
  store-backed ProcessGroup. The simulator executes all ranks' programs
  against FIFO channels and reports (a) DEADLOCK — some rank blocks on
  a recv no peer will ever satisfy (the mismatched-micro-count class
  `_check_micros` exists to catch one rank at a time), and (b) ORDERING
  violations — a recv that pops a FIFO message with the wrong
  (kind, stage, micro) tag, which at runtime is silent data corruption,
  not an error.

In the port both run in the world-shrink sweep
(``hooks.on_world_shrink``), which ``shrink_world`` and ``grow_world``
call before they move anything. The reference also runs them at the
reshard lowering and the pipeline runtime's construction under
``FLAGS_static_checks``, and from its analysis CLI; those wait for the
sanitizer (``ROADMAP.md`` §1 item 9). The schedules are the port's own
generators (``distributed/pipeline.py``) and the compiled pipeline's
permutations (``distributed/pipeline_compiled.py``).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .diagnostics import (SEVERITY_ERROR, SEVERITY_WARNING, CheckReport)

CHECKER_RESHARD = "reshard_placement"
CHECKER_PIPELINE = "pipeline_schedule"

_KNOWN_REDUCES = ("sum", "avg", "mean", "max", "min", "prod")


# ------------------------------------------------------------- reshard

def check_reshard(val_ndim: int, src, dst, report: CheckReport,
                  global_shape: Optional[Tuple[int, ...]] = None):
    """Validate a (mesh, placements) -> (mesh, placements) transition.
    `src`/`dst` carry `.mesh` and `.placements` (DistAttrLite or
    DistAttr duck-typed); `val_ndim` is the physical value's rank
    (stacked Partial dims included, the eager Partial representation)."""
    src_mesh = getattr(src, "process_mesh", None) or src.mesh
    dst_mesh = getattr(dst, "process_mesh", None) or dst.mesh
    n_partial = sum(1 for p in src.placements if p.is_partial())
    global_ndim = val_ndim - n_partial

    for name, attr, mesh in (("source", src, src_mesh),
                             ("destination", dst, dst_mesh)):
        if len(attr.placements) != mesh.ndim:
            report.add(
                CHECKER_RESHARD,
                f"{name} placements rank {len(attr.placements)} does "
                f"not match its mesh rank {mesh.ndim} "
                f"({mesh!r}): placements are per-MESH-dim",
                severity=SEVERITY_ERROR,
                hint="one placement entry per mesh axis "
                     "(Shard/Replicate/Partial)")
        for mesh_dim, p in enumerate(attr.placements):
            if p.is_shard():
                d = p.get_dim()
                if d < 0 or d >= global_ndim:
                    report.add(
                        CHECKER_RESHARD,
                        f"{name} Shard(dim={d}) on mesh axis {mesh_dim} "
                        f"is out of range for a rank-{global_ndim} "
                        f"global tensor",
                        severity=SEVERITY_ERROR,
                        hint="Shard dims index the GLOBAL tensor shape "
                             "(stacked Partial dims excluded)")
                elif global_shape is not None and mesh_dim < mesh.ndim:
                    size = global_shape[d] if d < len(global_shape) else None
                    axis = mesh.shape[mesh_dim]
                    if size is not None and axis and size % axis != 0:
                        report.add(
                            CHECKER_RESHARD,
                            f"{name} Shard(dim={d}) splits a dim of "
                            f"size {size} over mesh axis {mesh_dim} of "
                            f"size {axis}: not evenly divisible "
                            f"(NamedSharding requires equal chunks)",
                            severity=SEVERITY_ERROR,
                            hint="pad the tensor or pick a mesh axis "
                                 "whose size divides the dim")
            elif p.is_partial():
                rt = getattr(p, "reduce_type", "sum")
                if rt not in _KNOWN_REDUCES:
                    report.add(
                        CHECKER_RESHARD,
                        f"{name} Partial(reduce_type={rt!r}) on mesh "
                        f"axis {mesh_dim}: unknown reduction",
                        severity=SEVERITY_ERROR,
                        hint=f"one of {_KNOWN_REDUCES}")

    if src_mesh is not dst_mesh and src_mesh == dst_mesh:
        report.add(
            CHECKER_RESHARD,
            f"source and destination meshes are equal "
            f"({src_mesh!r}) but DISTINCT objects: pairwise reshard "
            f"functions dispatch on mesh identity, so this transition "
            f"takes the cross-mesh path (full gather to replicated, "
            f"then redistribute) instead of the cheap pairwise move",
            severity=SEVERITY_WARNING,
            hint="reuse one ProcessMesh object for both ends")


# ------------------------------------------------- pipeline schedules

# per-rank program ops: ("send", peer, tag) | ("recv", peer, tag) |
# ("local", what). Tags are (kind, stage-ish, micro) tuples; FIFO
# channels deliver them in send order, so a tag mismatch at a recv is
# the silent-corruption class, and an unsatisfiable recv is deadlock.

def schedule_programs(schedule: str, pp_size: int, num_micro: int,
                      num_chunks: int = 1) -> List[List[tuple]]:
    """Lower a host-driven schedule to per-rank P2P programs, reusing
    the SAME schedule generators the runtimes execute
    (distributed/pipeline.py) so the checker verifies shipping code,
    not a model of it."""
    P, m, C = pp_size, num_micro, num_chunks
    progs: List[List[tuple]] = []

    if schedule in ("FThenB", "1F1B"):
        from ..distributed.pipeline import _fb_schedule
        for r in range(P):
            ops: List[tuple] = []
            for kind, i in _fb_schedule(r, P, m, schedule):
                if kind == "F":
                    if r > 0:
                        ops.append(("recv", r - 1, ("act", r, i)))
                    ops.append(("local", f"F{i}"))
                    if r < P - 1:
                        ops.append(("send", r + 1, ("act", r + 1, i)))
                else:
                    if r < P - 1:
                        ops.append(("recv", r + 1, ("grad", r, i)))
                    ops.append(("local", f"B{i}"))
                    if r > 0:
                        ops.append(("send", r - 1, ("grad", r - 1, i)))
            progs.append(ops)
        return progs

    if schedule in ("VPP", "Interleave", "interleave"):
        from ..distributed.pipeline import _interleave_schedule
        V = P * C
        for r in range(P):
            ops = []
            for kind, chunk, i in _interleave_schedule(r, P, C, m):
                v = chunk * P + r
                if kind == "F":
                    if v > 0:
                        ops.append(("recv", (r - 1) % P, ("act", v, i)))
                    ops.append(("local", f"F{chunk}.{i}"))
                    if v < V - 1:
                        ops.append(("send", (r + 1) % P,
                                    ("act", v + 1, i)))
                else:
                    if v < V - 1:
                        ops.append(("recv", (r + 1) % P, ("grad", v, i)))
                    ops.append(("local", f"B{chunk}.{i}"))
                    if v > 0:
                        ops.append(("send", (r - 1) % P,
                                    ("grad", v - 1, i)))
            progs.append(ops)
        return progs

    if schedule in ("ZeroBubble", "ZBH1", "ZB"):
        from ..distributed.pipeline import _zero_bubble_schedule
        for r in range(P):
            ops = []
            for kind, i in _zero_bubble_schedule(r, P, m):
                if kind == "F":
                    if r > 0:
                        ops.append(("recv", r - 1, ("act", r, i)))
                    ops.append(("local", f"F{i}"))
                    if r < P - 1:
                        ops.append(("send", r + 1, ("act", r + 1, i)))
                elif kind == "B":
                    if r < P - 1:
                        ops.append(("recv", r + 1, ("grad", r, i)))
                    ops.append(("local", f"B{i}"))
                    if r > 0:
                        ops.append(("send", r - 1, ("grad", r - 1, i)))
                else:
                    ops.append(("local", f"W{i}"))
            progs.append(ops)
        return progs

    raise ValueError(f"unknown pipeline schedule '{schedule}'")


def simulate_pipeline(programs: Sequence[Sequence[tuple]],
                      report: CheckReport, schedule: str = "?"):
    """Execute all ranks' programs against FIFO channels: buffered
    sends (the store-backed transport never blocks the sender),
    blocking recvs. Reports ordering violations and deadlock."""
    P = len(programs)
    chans: Dict[Tuple[int, int], deque] = {}
    ptr = [0] * P
    progress = True
    while progress:
        progress = False
        for r in range(P):
            while ptr[r] < len(programs[r]):
                op = programs[r][ptr[r]]
                if op[0] == "send":
                    chans.setdefault((r, op[1]), deque()).append(op[2])
                elif op[0] == "recv":
                    q = chans.get((op[1], r))
                    if not q:
                        break                      # blocked
                    got = q.popleft()
                    if got != op[2]:
                        report.add(
                            CHECKER_PIPELINE,
                            f"schedule '{schedule}': rank {r} step "
                            f"{ptr[r]} expects {op[2]} from rank "
                            f"{op[1]} but the channel delivers {got}: "
                            f"FIFO order diverged — at runtime this is "
                            f"SILENT data corruption, not an error",
                            severity=SEVERITY_ERROR,
                            op_index=ptr[r],
                            hint="per directed pair, the send sequence "
                                 "must be the recv sequence's exact "
                                 "FIFO projection",
                            data={"rank": r, "step": ptr[r]})
                        return
                ptr[r] += 1
                progress = True
    blocked = [(r, programs[r][ptr[r]]) for r in range(P)
               if ptr[r] < len(programs[r])]
    if blocked:
        desc = "; ".join(
            f"rank {r} blocked at {op[0]}({op[2]} from rank {op[1]})"
            for r, op in blocked[:4])
        report.add(
            CHECKER_PIPELINE,
            f"schedule '{schedule}': DEADLOCK — {len(blocked)} rank(s) "
            f"wait on recvs no peer will ever send: {desc}",
            severity=SEVERITY_ERROR,
            hint="mismatched num_microbatches across ranks, or a "
                 "schedule whose P2P sequences are not FIFO-consistent "
                 "projections of one global order",
            data={"blocked": [r for r, _ in blocked]})
    undelivered = sum(len(q) for q in chans.values())
    if undelivered and not blocked:
        report.add(
            CHECKER_PIPELINE,
            f"schedule '{schedule}': all ranks completed but "
            f"{undelivered} sent message(s) were never received "
            f"(protocol asymmetry — the next batch reads stale data)",
            severity=SEVERITY_ERROR,
            data={"undelivered": undelivered})


def compiled_pipeline_programs(kind: str, pp_size: int,
                               num_micro: int) -> List[List[tuple]]:
    """Lower the COMPILED pipeline's collective-permute order to
    per-rank P2P programs — built from the permutation lists and tick
    counts the shipping lowerings themselves use
    (distributed/pipeline_compiled.py exports them), so the simulator
    validates the real lowering, not a hand-modeled one.

    A ``ppermute`` is a full collective: every rank sends along its
    edge and receives along the inverse edge every tick (bubble ticks
    carry zeros, exactly like the lowering). Tags are (stream, tick),
    so a FIFO divergence or an asymmetric edge set surfaces as the
    usual ordering / deadlock diagnostics."""
    from ..distributed import pipeline_compiled as pc
    P, m = pp_size, num_micro

    def _edges(perm, what):
        srcs = {s for s, _ in perm}
        dsts = {d for _, d in perm}
        if len(perm) != P or srcs != set(range(P)) \
                or dsts != set(range(P)):
            raise ValueError(
                f"{what} permutation is not a bijection over {P} "
                f"ranks: {perm}")
        return ({s: d for s, d in perm}, {d: s for s, d in perm})

    if kind in ("stream", "spmd_pipeline"):
        phases = [("act", _edges(pc.stream_permutation(P), "stream"))]
        T = pc.stream_tick_count(m, P)
    elif kind in ("1f1b", "pipeline_1f1b_train_step"):
        down, up = pc.fb_permutations(P)
        phases = [("act", _edges(down, "down")),
                  ("grad", _edges(up, "up"))]
        T = pc.fb_tick_count(m, P)
    else:
        raise ValueError(f"unknown compiled pipeline kind '{kind}'")

    progs: List[List[tuple]] = []
    for r in range(P):
        ops: List[tuple] = []
        for t in range(T):
            ops.append(("local", f"tick{t}"))
            for name, (dst_of, src_of) in phases:
                ops.append(("send", dst_of[r], (name, t)))
                ops.append(("recv", src_of[r], (name, t)))
        progs.append(ops)
    return progs


def check_compiled_pipeline(kind: str, pp_size: int, num_micro: int,
                            report: Optional[CheckReport] = None
                            ) -> CheckReport:
    """Lower + simulate the compiled pipeline's ppermute schedule."""
    if report is None:
        report = CheckReport(
            f"compiled pipeline {kind} (P={pp_size}, m={num_micro})")
    try:
        progs = compiled_pipeline_programs(kind, pp_size, num_micro)
    except ValueError as e:
        report.add(CHECKER_PIPELINE,
                   f"compiled pipeline '{kind}' rejected for "
                   f"P={pp_size}, m={num_micro}: {e}",
                   severity=SEVERITY_ERROR)
        return report
    simulate_pipeline(progs, report, schedule=f"compiled-{kind}")
    return report


def check_pipeline_schedule(schedule: str, pp_size: int, num_micro: int,
                            num_chunks: int = 1,
                            report: Optional[CheckReport] = None
                            ) -> CheckReport:
    """Lower + simulate one uniform schedule config."""
    if report is None:
        report = CheckReport(
            f"pipeline schedule {schedule} (P={pp_size}, m={num_micro}"
            + (f", C={num_chunks}" if num_chunks != 1 else "") + ")")
    try:
        progs = schedule_programs(schedule, pp_size, num_micro,
                                  num_chunks)
    except ValueError as e:
        report.add(CHECKER_PIPELINE,
                   f"schedule '{schedule}' rejected for P={pp_size}, "
                   f"m={num_micro}, C={num_chunks}: {e}",
                   severity=SEVERITY_ERROR)
        return report
    simulate_pipeline(progs, report, schedule=schedule)
    return report
