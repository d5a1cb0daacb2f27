"""The port's auto-parallel tooling against the JAX package's, on the CPU.

- Every registered spmd rule (``auto_parallel/spmd_rules.py``) on the same
  input attrs as the reference's, exact (dims mappings and partial
  status of the inferred inputs and the outputs), and the attr helpers.
- The three passes (``passes``: completion, gradient merge, recompute) on
  ``tests/test_dist_passes.py``'s MLP program: the attrs, the recorded
  shardings, the rewritten op list and ``ws.meta`` equal the reference's.
- The partitioner (``partitioner.py``): the rank programs of
  ``tests/test_partitioner.py``'s programs and meshes ([2, 2] dp × mp,
  [2, 2, 2] pp × dp × mp, the pp cut of the planner, the diamond DAG on
  5 stages, a batch of 8 over dp 3) op for op, and ``run_partitioned``
  against the reference's at 1e-5 (fp32); with the amp, recompute and
  gradient-merge strategy through ``Engine.build_rank_programs`` at the
  reference's own 3e-2 (bf16 products).
- A fact about the reference, kept: its ``mean`` rule marks a mean over a
  sharded dim Partial(sum), so the partitioned mean is the sum of the
  shards' means (dp times the mean) in both packages.
- The planner: ``plan_stage_map``, ``stage_loads`` and
  ``score_sharding_candidates`` equal the reference's under the same cost
  model; the port's default cost model is the H100's.
- ``Engine`` ``fit`` (gradient merge), ``evaluate``, ``predict``,
  ``save``/``load``, ``steps_per_epoch`` with validation, and
  ``to_static``, against the reference's ``Engine`` with the weights
  crossed (losses 1e-5).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.distributed as ref_dist
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as pt_dist
from paddle_tpu.distributed.auto_parallel import partitioner as ref_part
from paddle_tpu.distributed.auto_parallel import planner as ref_plan
from paddle_tpu.distributed.auto_parallel import spmd_rules as ref_rules
from paddle_tpu.distributed import passes as ref_passes
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.distributed.auto_parallel import partitioner as pt_part
from paddle_tpu_torch.distributed.auto_parallel import planner as pt_plan
from paddle_tpu_torch.distributed.auto_parallel import spmd_rules as pt_rules
from paddle_tpu_torch.distributed import passes as pt_passes

TOL = 1e-5
SIDES = {"ref": (ref, ref_dist, ref_rules, ref_passes, ref_part, ref_plan),
         "pt": (pt, pt_dist, pt_rules, pt_passes, pt_part, pt_plan)}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")
    yield
    for pkg in (ref, pt):
        pkg.disable_static()


# ------------------------------------------------------------- spmd rules

def _attrs(R, specs):
    return [R.TensorDistAttr(d, p) for d, p in specs]


def _flat(result):
    inferred, outs = result
    return ([(a.dims_mapping, a.partial_status) for a in inferred],
            [(a.dims_mapping, a.partial_status) for a in outs])


# inputs ((dims_mapping, partial_status) each) and attrs per rule function
_U = [([0, -1, 1], {}), ([-1, 1, 0], {0: "sum"})]
RULE_CASES = {
    "unary_rule": [([_U[0]], {}), ([_U[1]], {})],
    "dropout_rule": [([_U[0]], {}), ([_U[1]], {})],
    "elementwise_rule": [
        ([([0, -1], {}), ([-1], {})], {}),
        ([([-1, 1, -1], {}), ([0, -1, -1], {})], {}),
        ([([0, 1], {1: "sum"}), ([1, 0], {})], {}),
        ([([-1, 1], {}), ([-1], {}), ([0, -1], {})], {})],
    "_reduction_ops": [
        ([([0, 1, -1], {})], {"axis": 1}),
        ([([0, 1, -1], {})], {"axis": [0, 2], "keepdim": True}),
        ([([1, -1, 0], {})], {})],
    "matmul_rule": [
        ([([0, -1], {}), ([-1, 1], {})], {}),
        ([([-1, 0], {}), ([0, -1], {})], {}),
        ([([-1, 0], {}), ([1, -1], {})], {}),
        ([([0, -1], {}), ([1, -1], {})], {"transpose_y": True}),
        ([([-1, 0], {}), ([-1, 1], {})], {"transpose_x": True}),
        ([([0, -1, -1], {}), ([-1, 1], {})], {}),
        ([([0, -1], {}), ([-1, 0], {})], {}),
        ([([1, -1, 0], {}), ([0], {})], {})],
    "embedding_rule": [([([0, -1], {}), ([-1, -1], {})], {}),
                       ([([-1, 1], {}), ([0, -1], {})], {})],
    "softmax_ce_rule": [([([0, -1, 1], {}), ([0, -1, -1], {})], {}),
                        ([([-1, 0], {}), ([1, -1], {})], {})],
    "reshape_rule": [
        ([([0, -1, 1], {})], {"shape": [4, 48], "x_shape": [4, 6, 8]}),
        ([([0, 1], {})], {"shape": [2, 2, 12], "x_shape": [4, 12]}),
        ([([-1, 0], {1: "sum"})], {"shape": [-1], "x_shape": [4, 6]}),
        ([([1, 0], {})], {})],
    "transpose_rule": [([([0, -1, 1], {})], {"perm": [2, 0, 1]}),
                       ([([0, 1], {0: "sum"})], {})],
    "split_rule": [([([0, 1, -1], {})], {"axis": 1, "num": 3}),
                   ([([0, 1], {})], {"axis": -2})],
    "concat_rule": [([([0, -1], {}), ([-1, 1], {})], {"axis": 1}),
                    ([([0, 1], {}), ([0, 1], {}), ([-1, -1], {})],
                     {"axis": 0})],
    "slice_rule": [([([0, 1, -1], {})], {"axes": [1]}),
                   ([([0, 1], {})], {"axes": [-1, 0]})],
    "layer_norm_rule": [([([0, 1, -1], {}), ([-1], {}), ([-1], {})], {}),
                        ([([0, 1, 1], {}), ([0, -1], {})],
                         {"begin_norm_axis": 1})],
    "softmax_rule": [([([0, 1], {})], {}), ([([0, 1, -1], {})],
                                           {"axis": 1})],
    "flash_attention_rule": [
        ([([0, 1, -1, -1], {}), ([0, 1, -1, -1], {}),
          ([0, 1, -1, -1], {})], {"causal": True}),
        ([([0, -1, 1, -1], {}), ([-1, -1, 1, 0], {}),
          ([0, -1, 1, -1], {})], {})],
    "squeeze_rule": [([([0, -1], {})], {"out_ndim": 1}),
                     ([([0, 1], {})], {})],
    "gather_rule": [([([0, 1], {}), ([1], {})], {"axis": 0}),
                    ([([0, 1, -1], {}), ([-1, 0], {})], {"axis": -1})],
    "tile_rule": [([([0, 1], {})], {"out_ndim": 4}),
                  ([([1, -1], {})], {})],
    "stack_rule": [([([0, -1], {}), ([-1, 1], {})], {"axis": 1}),
                   ([([0, 1], {}), ([0, 1], {})], {"axis": -1})],
    "conv2d_rule": [([([0, -1, -1, -1], {}), ([1, -1, -1, -1], {})], {}),
                    ([([0, 1, -1, -1], {}), ([-1, 1, -1, -1], {})], {})],
    "pool2d_rule": [([([0, 1, -1, 0], {})], {})],
    "topk_rule": [([([0, 1], {})], {}), ([([0, 1, -1], {})], {"axis": 0})],
    "cumsum_rule": [([([0, 1], {})], {}), ([([0, 1, -1], {})],
                                          {"axis": 0})],
    "one_hot_rule": [([([0, 1], {})], {})],
    "scatter_rule": [([([0, 1], {}), ([1], {})], {}),
                     ([([0, 1], {}), ([1, -1], {}), ([0, -1], {})], {})],
}


def test_the_port_registers_every_rule_of_the_reference():
    assert pt_rules.registered_rules() == ref_rules.registered_rules()
    for name in ref_rules.registered_rules():
        assert pt_rules.get_spmd_rule(name).fn.__name__ == \
            ref_rules.get_spmd_rule(name).fn.__name__, name


@pytest.mark.parametrize("name", ref_rules.registered_rules())
def test_every_spmd_rule_matches_reference(name):
    cases = RULE_CASES[ref_rules.get_spmd_rule(name).fn.__name__]
    for specs, attrs in cases:
        want = _flat(ref_rules.resolve(name, _attrs(ref_rules, specs),
                                       **attrs))
        got = _flat(pt_rules.resolve(name, _attrs(pt_rules, specs),
                                     **attrs))
        assert got == want, (name, specs, attrs)


def test_unknown_op_and_notation_errors_match_reference():
    for R in (ref_rules, pt_rules):
        inferred, (out,) = R.resolve("no_such_op", [R.TensorDistAttr([0, 1])])
        assert out.dims_mapping == [-1, -1]
        with pytest.raises(ValueError, match="rank"):
            R.infer_einsum("mk,kn->mn", R.TensorDistAttr([0]),
                           R.TensorDistAttr([-1, 1]))


def test_attr_helpers_match_reference():
    from paddle_tpu.distributed.placements import (
        Partial as RPa, Replicate as RR_, Shard as RS)
    from paddle_tpu_torch.distributed.placements import (
        Partial as PPa, Replicate as PR_, Shard as PS)
    names = ["dp", "mp", "pp"]
    for (R, Sh, Re, Pa) in ((ref_rules, RS, RR_, RPa),
                            (pt_rules, PS, PR_, PPa)):
        a = R.from_placements([Sh(1), Pa("max"), Sh(0)], 3)
        assert (a.dims_mapping, a.partial_status) == ([2, 0, -1],
                                                      {1: "max"})
        assert [repr(p) for p in R.to_placements(a, 3)] == [
            "Shard(dim=1)", "Partial(reduce_type=max)", "Shard(dim=0)"]
    for dims in ([0, -1, 2], [-1, 1, -1], [-1, -1]):
        want = tuple(ref_rules.to_partition_spec(
            ref_rules.TensorDistAttr(dims), names))
        got = pt_rules.to_partition_spec(pt_rules.TensorDistAttr(dims),
                                         names)
        assert tuple(got) == want
        assert type(got).__module__ == "paddle_tpu_torch.distributed.mesh"


# ----------------------------------------------------------------- passes

def _mlp_program(side):
    pkg = SIDES[side][0]
    w1 = pkg.to_tensor(np.random.RandomState(0).randn(16, 32)
                       .astype(np.float32))
    w2 = pkg.to_tensor(np.random.RandomState(1).randn(32, 16)
                       .astype(np.float32))
    pkg.static.enable_static()
    try:
        prog = pkg.static.Program()
        with pkg.static.program_guard(prog):
            x = pkg.static.data("x", [8, 16], "float32")
            h = pkg.nn.functional.relu(pkg.matmul(x, w1))
            out = pkg.matmul(h, w2)
    finally:
        pkg.static.disable_static()
    return prog, x, w1, w2, out


def _out_index(ws):
    """id(var) -> (op index, output index) of a workspace's outputs."""
    return {id(v): (i, j) for i, n in enumerate(ws.ops)
            for j, v in enumerate(n.outputs)}


def _completed(side, seeded=True):
    pkg, dist, R, P, _, _ = SIDES[side]
    prog, x, w1, w2, out = _mlp_program(side)
    mesh = dist.mesh.auto_mesh(2, 4, dim_names=["dp", "mp"])
    ctx = P.DistContext(mesh)
    if seeded:
        Pl = dist.placements
        ctx.shard(x, [Pl.Shard(0), Pl.Replicate()])
        ctx.shard(w1, [Pl.Replicate(), Pl.Shard(1)])
        ctx.shard(w2, [Pl.Replicate(), Pl.Shard(0)])
    ws = pkg.ir.Workspace(prog)
    changed = P.ShardingCompletionPass(ctx).run(ws, frozenset())
    index = _out_index(ws)
    attrs = {index[k]: (a.dims_mapping, a.partial_status)
             for k, a in ctx.attrs.items() if k in index}
    return changed, attrs, sorted(index[k] for k in ws.shardings)


@pytest.mark.parametrize("seeded", [True, False])
def test_completion_pass_matches_reference(seeded):
    want = _completed("ref", seeded)
    got = _completed("pt", seeded)
    assert got == want
    if seeded:
        assert want[1][(2, 0)] == ([0, -1], {1: "sum"})


def test_recorded_shardings_are_the_port_partition_specs():
    pkg, dist, R, P, _, _ = SIDES["pt"]
    prog, x, w1, w2, out = _mlp_program("pt")
    mesh = dist.mesh.auto_mesh(2, 4, dim_names=["dp", "mp"])
    ctx = P.DistContext(mesh)
    ctx.shard(x, [dist.Shard(0), dist.Replicate()])
    ctx.shard(w1, [dist.Replicate(), dist.Shard(1)])
    ws = pkg.ir.Workspace(prog)
    P.ShardingCompletionPass(ctx).run(ws, frozenset())
    spec = ws.shardings[id(ws.ops[0].outputs[0])]
    assert spec == dist.mesh.PartitionSpec("dp", "mp")


def _strategy_meta(side, passes, consume=False):
    pkg = SIDES[side][0]
    prog, x, w1, w2, out = _mlp_program(side)
    if consume:
        pkg.static.enable_static()
        try:
            with pkg.static.program_guard(prog):
                pkg.nn.functional.gelu(out)
        finally:
            pkg.static.disable_static()
    ws = pkg.ir.Workspace(prog)
    ran = [p.run(ws, frozenset([id(out)])) for p in passes(side)]
    meta = dict(getattr(ws, "meta", {}))
    gm = meta.get("gradient_merge")
    if gm:
        meta["gradient_merge"] = dict(gm, scaled_losses=len(
            gm["scaled_losses"]))
    return ran, [n.op_name for n in ws.ops], \
        [dict(n.attrs) for n in ws.ops if n.op_name == "scale"], meta


@pytest.mark.parametrize("case", ["merge", "merge_twice", "consumed",
                                  "recompute", "both"])
def test_strategy_passes_match_reference(case):
    def passes(side):
        P = SIDES[side][3]
        return {"merge": [P.GradientMergePass(4)],
                "merge_twice": [P.GradientMergePass(4),
                                P.GradientMergePass(4)],
                "consumed": [P.GradientMergePass(4)],
                "recompute": [P.RecomputeProgramPass(segments=2)],
                "both": [P.RecomputeProgramPass(),
                         P.GradientMergePass(2, avg=True)]}[case]
    want = _strategy_meta("ref", passes, consume=case == "consumed")
    got = _strategy_meta("pt", passes, consume=case == "consumed")
    assert got == want


def test_build_strategy_passes_matches_reference():
    def names(side):
        P = SIDES[side][3]
        from paddle_tpu_torch.distributed.auto_parallel.engine import \
            Strategy as PS
        from paddle_tpu.distributed.auto_parallel.engine import \
            Strategy as RS
        S = RS if side == "ref" else PS
        s = S({"amp": {"enable": True}, "recompute": {"enable": True},
               "gradient_merge": {"enable": True, "k_steps": 3}})
        return [p.name for p in P.build_strategy_passes(s)]
    assert names("pt") == names("ref")


# ------------------------------------------------------------ partitioner

B, H, FF = 8, 4, 8


def _record(side, build):
    pkg = SIDES[side][0]
    consts = build.consts(pkg)
    pkg.enable_static()
    try:
        prog = pkg.static.Program()
        with pkg.static.program_guard(prog):
            x = pkg.static.data("x", [B, H], "float32")
            out = build(pkg, x, consts)
    finally:
        pkg.disable_static()
    return prog, x, consts, out


class _MLP:
    """x @ w1 (mp-col) -> gelu -> @ w2 (mp-row, Partial) -> @ w3."""

    @staticmethod
    def consts(pkg):
        rng = np.random.RandomState(0)
        return [pkg.to_tensor((rng.randn(*s) * 0.3).astype("float32"))
                for s in ((H, FF), (FF, H), (H, H))]

    def __call__(self, pkg, x, c):
        h = pkg.nn.functional.gelu(pkg.matmul(x, c[0]))
        return pkg.matmul(pkg.matmul(h, c[1]), c[2])


class _Diamond:
    """A stage-0 value read by two later stages."""

    @staticmethod
    def consts(pkg):
        rng = np.random.RandomState(3)
        return [pkg.to_tensor((rng.randn(H, H) * 0.3).astype("float32"))
                for _ in range(3)]

    def __call__(self, pkg, x, c):
        h0 = pkg.nn.functional.gelu(x)
        b = pkg.matmul(pkg.matmul(h0, c[0]), c[1])
        return pkg.add(b, pkg.matmul(h0, c[2]))


class _Unbalanced:
    """Two heavy products up front, eight cheap ops after."""

    @staticmethod
    def consts(pkg):
        rng = np.random.RandomState(4)
        return [pkg.to_tensor((rng.randn(*s) * 0.1).astype("float32"))
                for s in ((H, 256), (256, 256))]

    def __call__(self, pkg, x, c):
        h = pkg.matmul(pkg.matmul(x, c[0]), c[1])
        for _ in range(8):
            h = pkg.tanh(h)
        return h


class _Mean:
    """x @ w, then the mean of everything."""

    @staticmethod
    def consts(pkg):
        rng = np.random.RandomState(5)
        return [pkg.to_tensor(rng.randn(H, FF).astype("float32"))]

    def __call__(self, pkg, x, c):
        return pkg.mean(pkg.matmul(x, c[0]))


def _feed():
    return {"x": np.random.RandomState(1).randn(B, H).astype("float32")}


def _global(side, prog, out, feed):
    pkg = SIDES[side][0]
    pkg.enable_static()
    try:
        return pkg.static.Executor().run(prog, feed=feed,
                                         fetch_list=[out])[0]
    finally:
        pkg.disable_static()


def _seeds(dist, names, x, consts, kind):
    Pl = dist.placements
    rep = [Pl.Replicate()] * len(names)

    def on(axis, dim):
        pl = list(rep)
        if axis in names:
            pl[names.index(axis)] = Pl.Shard(dim)
        return pl
    if kind == "mlp":
        return {x: on("dp", 0), consts[0]: on("mp", 1),
                consts[1]: on("mp", 0), consts[2]: rep}
    return {x: on("dp", 0)}


def _partitioned(side, build, shape, names, kind, planned=False,
                 strategy=None):
    pkg, dist, R, P, Part, Plan = SIDES[side]
    prog, x, consts, out = _record(side, build)
    mesh = dist.ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                            dim_names=list(names))
    seeds = _seeds(dist, list(names), x, consts, kind)
    if strategy is not None:
        from importlib import import_module
        eng = import_module(f"{dist.__name__}.auto_parallel.engine")
        engine = eng.Engine(strategy=eng.Strategy(strategy))
        parts, ws, ctx = engine.build_rank_programs(
            prog, out, mesh=mesh, seed_placements=seeds)
    else:
        ctx = P.DistContext(mesh)
        for var, pl in seeds.items():
            ctx.shard(var, pl)
        ws = pkg.ir.Workspace(prog)
        P.ShardingCompletionPass(ctx).run(ws, frozenset())
        stage_map = Plan.plan_stage_map(ws, shape[0], Plan.CostModel(
            flops_per_s=1e14, bytes_per_s=1e11)) if planned else None
        parts = Part.Partitioner(ctx, mesh,
                                 stage_map=stage_map).partition_all(ws)
    index = _out_index(ws)
    index.update({id(v): ("feed", i) for i, v in enumerate(ws.feed_vars)})
    programs = [(rp.coord, [
        (o.kind, o.node.op_name if o.kind == "compute"
         else index.get(id(o.var)), o.mesh_dim, o.peer, o.stage)
        for o in rp.ops], {index[k]: tuple(s) for k, s in
                           rp.local_shapes.items() if k in index},
        {k: [(s.start, s.stop) for s in v]
         for k, v in rp.feed_slices.items()}) for rp in parts]
    feed = _feed()
    got = Part.run_partitioned(parts, ws, mesh, feed, out, ctx)
    return programs, np.asarray(got, np.float64), \
        np.asarray(_global(side, prog, out, feed), np.float64)


PARTITION_CASES = {
    "dp2_mp2": (_MLP(), (2, 2), ("dp", "mp"), "mlp", False),
    "pp2_dp2_mp2": (_MLP(), (2, 2, 2), ("pp", "dp", "mp"), "mlp", False),
    "pp2_planned": (_Unbalanced(), (2,), ("pp",), "x", True),
    "diamond_pp5": (_Diamond(), (5,), ("pp",), "x", False),
    "dp3_uneven": (_MLP(), (3,), ("dp",), "x", False),
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partitioned_composed_run_matches_reference(case):
    build, shape, names, kind, planned = PARTITION_CASES[case]
    want_progs, want, want_global = _partitioned("ref", build, shape, names,
                                                 kind, planned)
    got_progs, got, got_global = _partitioned("pt", build, shape, names,
                                              kind, planned)
    assert got_progs == want_progs
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, got_global, rtol=TOL, atol=TOL)
    kinds = {op[0] for _, ops, _, _ in got_progs for op in ops}
    if kind == "mlp":
        assert "allreduce" in kinds
    if "pp" in names:
        assert {"send", "recv"} <= kinds


def test_engine_strategy_build_matches_reference():
    strategy = {"amp": {"enable": True, "dtype": "bfloat16"},
                "recompute": {"enable": True},
                "gradient_merge": {"enable": True, "k_steps": 4}}
    args = (_MLP(), (2, 2, 2), ("pp", "dp", "mp"), "mlp")
    want_progs, want, want_global = _partitioned("ref", *args,
                                                 strategy=strategy)
    got_progs, got, got_global = _partitioned("pt", *args,
                                              strategy=strategy)
    assert got_progs == want_progs
    assert any(op[1] == "cast" for _, ops, _, _ in got_progs for op in ops)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, got_global / 4.0, rtol=3e-2, atol=3e-2)


def test_partitioned_mean_over_a_sharded_dim_is_the_sum_of_means():
    """Both packages' ``mean`` rule marks a mean over a dp-sharded dim
    Partial(sum): the partitioned run sums the shards' means, dp times the
    global mean (a fact about the reference, kept)."""
    want_progs, want, want_global = _partitioned("ref", _Mean(), (2,),
                                                 ("dp",), "x")
    got_progs, got, got_global = _partitioned("pt", _Mean(), (2,), ("dp",),
                                              "x")
    assert got_progs == want_progs
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, 2 * got_global, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- planner

def test_planner_matches_reference_under_the_same_cost_model():
    out = {}
    for side in ("ref", "pt"):
        pkg, dist, R, P, Part, Plan = SIDES[side]
        prog, x, consts, _ = _record(side, _Unbalanced())
        ws = pkg.ir.Workspace(prog)
        cm = Plan.CostModel(flops_per_s=1e14, bytes_per_s=1e11)
        n = len(ws.ops)
        uniform = [min(i // max(n // 2, 1), 1) for i in range(n)]
        planned = {s: Plan.plan_stage_map(ws, s, cm) for s in (1, 2, 3, 4)}

        class V:
            shape = [1024, 1024]
        mesh = dist.ProcessMesh(np.arange(4), ["mp"])
        out[side] = (planned, Plan.stage_loads(ws, planned[2], cm),
                     Plan.stage_loads(ws, uniform, cm),
                     Plan.score_sharding_candidates(
                         V(), [([-1, -1], (0,)), ([-1, 0], ()),
                               ([0, -1], (0,))], mesh, cm),
                     [cm.op_flops(op) for op in ws.ops])
    assert out["pt"][0] == out["ref"][0]
    assert out["pt"][0][2][1:3] == [0, 1]
    for got, want in zip(out["pt"][1:], out["ref"][1:]):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=1e-12)


def test_the_port_cost_model_defaults_are_the_h100s():
    """The reference's defaults are TPU-class (1e14 FLOP/s, 1e11 B/s); the
    port's are the H100's data-sheet figures (bf16 dense, NVLink each
    way)."""
    cm = pt_plan.CostModel()
    assert (cm.flops_per_s, cm.bytes_per_s, cm.latency_s,
            cm.dtype_bytes) == (989e12, 450e9, 1e-6, 4)
    rc = ref_plan.CostModel()
    assert (rc.flops_per_s, rc.bytes_per_s) == (1e14, 1e11)


# ----------------------------------------------------------------- engine

def _data_cls(pkg):
    class Data(pkg.io.Dataset):
        def __init__(self, n=32):
            rng = np.random.RandomState(0)
            self.x = rng.randn(n, 8).astype(np.float32)
            w = np.random.RandomState(42).randn(8, 4).astype(np.float32)
            self.y = (self.x @ w).astype(np.float32)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

        def __len__(self):
            return len(self.x)
    return Data


def _engines(strategy=None):
    """The same Linear(8, 4) and Adam(0.01) in both packages (the port's
    weights crossed from the reference's), each in an ``Engine``."""
    out = {}
    state = None
    for side in ("ref", "pt"):
        pkg, dist = SIDES[side][:2]
        net = pkg.nn.Linear(8, 4)
        if state is None:
            state = {k: np.array(v.numpy())
                     for k, v in net.state_dict().items()}
        else:
            net.set_state_dict(state)
        opt = pkg.optimizer.Adam(0.01, parameters=net.parameters())
        eng = dist.auto_parallel.Engine(
            model=net, loss=pkg.nn.MSELoss(), optimizer=opt,
            strategy=None if strategy is None
            else dist.auto_parallel.Strategy(strategy))
        out[side] = (pkg, net, eng, _data_cls(pkg))
    return out


def test_engine_fit_evaluate_predict_match_reference():
    e = _engines({"gradient_merge": {"enable": True, "k_steps": 2}})
    res = {}
    for side, (pkg, net, eng, Data) in e.items():
        hist = eng.fit(Data(64), batch_size=8, epochs=3)
        ev = eng.evaluate(Data(16), batch_size=8)
        outs = eng.predict(Data(16), batch_size=8)
        res[side] = (hist["loss"], ev["loss"],
                     [np.asarray(o.numpy()) for o in outs],
                     {k: np.array(v.numpy())
                      for k, v in net.state_dict().items()})
    got, want = res["pt"], res["ref"]
    assert len(got[0]) == len(want[0]) == 24
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    assert np.mean(got[0][-8:]) < np.mean(got[0][:8])
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
    assert len(got[2]) == len(want[2]) == 2
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for k in want[3]:
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=TOL,
                                   atol=TOL)


def test_engine_steps_per_epoch_and_validation_match_reference():
    e = _engines()
    hists = {side: eng.fit(Data(64), valid_data=Data(16), batch_size=8,
                           epochs=3, steps_per_epoch=2, valid_freq=1)
             for side, (pkg, net, eng, Data) in e.items()}
    assert len(hists["pt"]["loss"]) == 6
    assert len(hists["pt"]["eval_loss"]) == 3
    for key in ("loss", "eval_loss"):
        np.testing.assert_allclose(hists["pt"][key], hists["ref"][key],
                                   rtol=TOL, atol=TOL)


def test_engine_save_load_round_trip(tmp_path):
    from paddle_tpu_torch.distributed.auto_parallel import to_static
    pkg, net, _, Data = _engines()["pt"]
    opt = pkg.optimizer.Adam(0.01, parameters=net.parameters())
    engine = to_static(net, loss=pkg.nn.MSELoss(), optimizer=opt)
    assert engine._prepared and pt_dist.get_mesh() is not None
    engine.fit(Data(16), batch_size=8, epochs=1)
    engine.save(str(tmp_path / "m"))
    w0 = net.weight.numpy().copy()
    net.weight.set_value(pkg.zeros([8, 4]))
    engine.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(net.weight.numpy(), w0)
    pt_dist.set_mesh(None)


def test_engine_cost_matches_reference_with_the_hardware_given():
    hw = dict(chip_flops=197e12, hbm_bytes=16e9, ici_bandwidth=4.5e10,
              mfu=0.4)
    e = _engines()
    got = e["pt"][2].cost(**hw)
    want = e["ref"][2].cost(**hw)
    assert got["step_time"] == pytest.approx(want["step_time"], rel=1e-12)
    assert got["memory"] == pytest.approx(want["memory"], rel=1e-12)
    assert e["pt"][2]._n_params() == e["ref"][2]._n_params() == 36
    for dist in (ref_dist, pt_dist):
        dist.set_mesh(None)
