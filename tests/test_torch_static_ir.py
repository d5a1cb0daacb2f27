"""The port's ``static`` graph mode and ``ir`` passes against the JAX
package's, on the CPU.

The scenarios of ``tests/test_static.py`` and ``tests/test_ir_passes.py``:
each program is recorded in both packages from the same build function
and the same numpy constants; the op names after each pass (and so the
op counts) must equal the reference's on the same program, and the
executor's results must equal the reference's (fp32 rtol 1e-5, atol 1e-6)
and the plain numpy formula. The port's executor compiles with
``aot_eager`` (the CPU's default backend).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.ir  # noqa: F401  (the reference imports it lazily)
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device

PKGS = (ref, pt)


@pytest.fixture(autouse=True)
def _cpu_and_dynamic(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")
    yield
    for pkg in PKGS:
        pkg.disable_static()


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _record(pkg, build, feeds):
    """Record ``build(pkg, vars)`` into a fresh Program of ``pkg``."""
    pkg.static.enable_static()
    try:
        prog = pkg.static.Program()
        with pkg.static.program_guard(prog):
            vars_ = {name: pkg.static.data(name, shape, dtype)
                     for name, (shape, dtype) in feeds.items()}
            out = build(pkg, vars_)
    finally:
        pkg.static.disable_static()
    return prog, vars_, out


def _both(build, feeds):
    return [_record(pkg, build, feeds) for pkg in PKGS]


def _names(ops):
    return [n.op_name for n in ops]


def _run(pkg, prog, feed, out):
    return pkg.static.Executor().run(prog, feed=feed, fetch_list=[out])[0]


def _same_run(recorded, feed, want=None):
    (rp, _, ro), (pp, _, po) = recorded
    got = _run(pt, pp, feed, po)
    _close(got, _run(ref, rp, feed, ro))
    if want is not None:
        _close(got, want)
    return got


# ------------------------------------------------------------ static mode

def test_static_program_records_and_runs():
    eye = np.eye(4, dtype=np.float32) * 2

    def build(pkg, v):
        y = pkg.matmul(v["x"], pkg.to_tensor(eye))
        return y + 1.0

    rec = _both(build, {"x": ([None, 4], "float32")})
    assert _names(rec[1][0].ops) == _names(rec[0][0].ops)
    assert len(rec[1][0].ops) >= 2
    assert pt.static.Executor().run(pt.static.Program()) == []
    xs = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    _same_run(rec, {"x": xs}, xs * 2 + 1)


def test_static_matches_dygraph():
    rng = np.random.RandomState(1)
    w_np = rng.randn(8, 4).astype(np.float32)
    x_np = rng.randn(5, 8).astype(np.float32)

    def build(pkg, v):
        return pkg.tanh(pkg.matmul(v["x"], pkg.to_tensor(w_np))).sum(axis=1)

    rec = _both(build, {"x": ([None, 8], "float32")})
    assert _names(rec[1][0].ops) == _names(rec[0][0].ops)
    _same_run(rec, {"x": x_np}, np.tanh(x_np @ w_np).sum(axis=1))


def test_static_executor_cache_and_refeed():
    (prog, _, y), = [_record(pt, lambda pkg, v: v["x"] * 3.0,
                             {"x": ([None, 2], "float32")})]
    exe = pt.static.Executor()
    a, = exe.run(prog, feed={"x": np.ones((2, 2), np.float32)},
                 fetch_list=[y])
    b, = exe.run(prog, feed={"x": np.full((2, 2), 2.0, np.float32)},
                 fetch_list=[y])
    _close(a, 3.0)
    _close(b, 6.0)
    assert len(exe._cache) == 1   # same signature -> one compiled program
    programs = next(iter(exe._cache.values()))[1]
    assert len(programs) == 1


def test_static_nn_fc():
    (prog, _, out), = [_record(
        pt, lambda pkg, v: pkg.static.nn.fc(v["x"], 3, activation="relu"),
        {"x": ([None, 6], "float32")})]
    res, = pt.static.Executor().run(
        prog, feed={"x": np.ones((2, 6), np.float32)}, fetch_list=[out])
    assert res.shape == (2, 3)
    assert (res >= 0).all()
    # against the eager formula with the captured parameters
    w, b = (t for t in prog.ops[0].inputs + prog.ops[1].inputs
            if isinstance(t, pt.Tensor) and not isinstance(
                t, pt.static.Variable))
    _close(res, np.maximum(np.ones((2, 6)) @ w.numpy() + b.numpy(), 0))


def test_in_dynamic_mode_flag():
    for pkg in PKGS:
        assert pkg.in_dynamic_mode()
        pkg.enable_static()
        assert not pkg.in_dynamic_mode()
        pkg.disable_static()
        assert pkg.in_dynamic_mode()


# ------------------------------------------------------------ the passes

def _passes(pkg):
    return pkg.ir


def _pass_names(recorded, make_pass, protected_of=lambda rec: ()):
    """Run the pass ``make_pass(pkg)`` on a Workspace of each package's
    program; returns the op names after it, per package."""
    out = []
    for pkg, rec in zip(PKGS, recorded):
        ws = pkg.ir.Workspace(rec[0])
        p = make_pass(pkg)
        prot = protected_of(rec)
        if isinstance(p, pkg.ir.PassManager):
            p.run(ws, protected=prot)
        else:
            p.run(ws, frozenset(id(v) for v in prot))
        out.append((ws, _names(ws.ops)))
    assert out[1][1] == out[0][1], (out[1][1], out[0][1])
    return out


def test_constant_folding_folds_constant_chain():
    def build(pkg, v):
        a = pkg.to_tensor(np.ones((2, 2), np.float32))
        b = a + a            # constant: foldable
        return v["x"] + b

    rec = _both(build, {"x": ([2, 2], "float32")})
    assert [len(r[0].ops) for r in rec] == [2, 2]
    _, (_, names) = _pass_names(
        rec, lambda pkg: pkg.ir.ConstantFoldingPass())
    assert len(names) == 1  # only x + const remains


def test_constant_folding_numerics_unchanged():
    def build(pkg, v):
        c = pkg.to_tensor(np.full((3,), 2.0, np.float32))
        return (v["x"] * (c + c)) - c

    rec = _both(build, {"x": ([3], "float32")})
    x = np.array([1.0, 2.0, 3.0], np.float32)
    _same_run(rec, {"x": x}, x * 4.0 - 2.0)


def test_dce_removes_unfetched_branch():
    def build(pkg, v):
        used = v["x"] + 1.0
        _unused = v["x"] * 123.0   # dead: never fetched
        return used

    rec = _both(build, {"x": ([2], "float32")})
    n_before = len(rec[1][0].ops)
    _, (_, names) = _pass_names(
        rec, lambda pkg: pkg.ir.DeadCodeEliminationPass(),
        lambda r: [r[2]])
    assert len(names) < n_before
    assert "multiply" not in names


def test_dce_keeps_transitive_deps():
    def build(pkg, v):
        return (v["x"] + 1.0) * 2.0

    rec = _both(build, {"x": ([2], "float32")})
    _, (_, names) = _pass_names(
        rec, lambda pkg: pkg.ir.DeadCodeEliminationPass(),
        lambda r: [r[2]])
    assert len(names) == 2


def _twin(pkg, v):
    a = v["x"] + 1.0
    b = v["x"] + 1.0   # identical
    return a * b


def test_cse_dedupes_identical_ops():
    rec = _both(_twin, {"x": ([2], "float32")})
    _, (_, names) = _pass_names(
        rec, lambda pkg: pkg.ir.CommonSubexpressionEliminationPass(),
        lambda r: [r[2]])
    assert names.count("add") == 1


def test_cse_random_ops_not_deduped():
    # impure ops (dropout/random family) are never deduped, even with
    # identical inputs and attrs: the nodes are built directly
    rec = _both(lambda pkg, v: v["x"] + 1.0, {"x": ([2, 2], "float32")})
    for pkg, (prog, vars_, _) in zip(PKGS, rec):
        x = vars_["x"]
        prog.ops += [pkg.static.OpNode(
            "dropout_rng", {"p": 0.5}, [x],
            [pkg.static.Variable(f"d{i}", [2, 2], "float32", prog)])
            for i in (1, 2)]
    _, (_, names) = _pass_names(
        rec, lambda pkg: pkg.ir.CommonSubexpressionEliminationPass(),
        lambda r: [r[2]])
    assert names.count("dropout_rng") == 2


def test_cse_numerics_via_executor():
    rec = _both(_twin, {"x": ([2], "float32")})
    x = np.array([2.0, 3.0], np.float32)
    _same_run(rec, {"x": x}, (x + 1) ** 2)


def _cleanup(pkg, patterns):
    P = pkg.ir.passes
    return pkg.ir.PassManager([
        pkg.ir.PatternRewriter([getattr(P, n)() for n in patterns]),
        pkg.ir.DeadCodeEliminationPass()], iterate_to_fixpoint=True)


def test_lossless_double_cast_folded():
    def build(pkg, v):
        return v["x"].cast("float32").cast("float16")  # widening first

    rec = _both(build, {"x": ([2], "float16")})
    _, (_, names) = _pass_names(
        rec, lambda pkg: _cleanup(pkg, ("FoldDoubleCast",
                                        "DropIdentityCast")),
        lambda r: [r[2]])
    # cast(cast(x_f16, f32), f16) -> cast(x, f16) -> dropped (identity)
    assert "cast" not in names


def test_narrowing_double_cast_kept():
    def build(pkg, v):
        return v["x"].cast("float16").cast("float32")  # rounds values

    rec = _both(build, {"x": ([2], "float32")})
    _, (_, names) = _pass_names(
        rec, lambda pkg: _cleanup(pkg, ("FoldDoubleCast",
                                        "DropIdentityCast")),
        lambda r: [r[2]])
    assert names.count("cast") == 2


def _scales(pkg, v):
    return v["x"].scale(2.0).scale(3.0)


def test_scale_scale_fused():
    rec = _both(_scales, {"x": ([2], "float32")})
    out = _pass_names(rec, lambda pkg: _cleanup(pkg, ("FuseScaleScale",)),
                      lambda r: [r[2]])
    for ws, names in out:
        assert names.count("scale") == 1
        scale = [n for n in ws.ops if n.op_name == "scale"][0]
        assert scale.attrs["scale"] == pytest.approx(6.0)


def test_scale_scale_fused_numerics():
    rec = _both(_scales, {"x": ([2], "float32")})
    x = np.array([1.0, -1.0], np.float32)
    _same_run(rec, {"x": x}, x * 6.0)


def test_amp_pass_casts_matmul_inputs_to_bf16():
    def build(pkg, v):
        w = pkg.to_tensor(np.ones((4, 4), np.float32))
        return pkg.matmul(v["x"], w)

    rec = _both(build, {"x": ([2, 4], "float32")})
    _, (ws, names) = _pass_names(
        rec, lambda pkg: pkg.ir.AutoMixedPrecisionPass(), lambda r: [r[2]])
    assert "cast" in names
    mm = [n for n in ws.ops if n.op_name == "matmul"][0]
    # the constant weight cast at compile time; the variable via a cast op
    assert mm.inputs[1].dtype == torch.bfloat16


def test_full_pipeline_matches_eager():
    def build(pkg, v):
        c = pkg.to_tensor(np.full((4,), 0.5, np.float32))
        a = v["x"] * (c + c)        # foldable subexpr
        b = v["x"] * (c + c)        # CSE twin
        _dead = v["x"] - 42.0       # dead
        return a + b

    rec = _both(build, {"x": ([4], "float32")})
    _pass_names(rec, lambda pkg: pkg.ir.default_pass_manager(),
                lambda r: [r[2]])
    x = np.arange(4, dtype=np.float32)
    _same_run(rec, {"x": x}, 2 * x)


def test_pass_stats_recorded():
    rec = _both(lambda pkg, v: v["x"] + 1.0, {"x": ([2], "float32")})
    stats = []
    for pkg, (prog, _, out) in zip(PKGS, rec):
        pm = pkg.ir.default_pass_manager()
        pm.run(pkg.ir.Workspace(prog), protected=[out])
        stats.append([(s["pass"], s["changed"]) for s in pm.stats])
    assert stats[1] == stats[0]
    assert "dead_code_elimination" in {s for s, _ in stats[1]}


def test_pass_disable_flag_skips_a_pass():
    rec = _both(_twin, {"x": ([2], "float32")})
    prog, _, out = rec[1]
    pt.set_flags({"FLAGS_ir_pass_disable": "cse"})
    try:
        pm = pt.ir.default_pass_manager()
        ws = pt.ir.Workspace(prog)
        pm.run(ws, protected=[out])
    finally:
        pt.set_flags({"FLAGS_ir_pass_disable": ""})
    assert "cse" not in {s["pass"] for s in pm.stats}
    assert _names(ws.ops).count("add") == 2


# ------------------------------------------------------------ auto layout

CONV_RNG = 0


def _conv_chain(n_unary):
    rng = np.random.RandomState(CONV_RNG)
    w1 = rng.randn(4, 3, 3, 3).astype("float32") * 0.2
    w2 = rng.randn(2, 4, 3, 3).astype("float32") * 0.2

    def build(pkg, v):
        F = pkg.nn.functional
        h = F.conv2d(v["x"], pkg.to_tensor(w1), padding=1)
        h = F.relu(h)
        if n_unary > 1:
            h = pkg.cast(h, "float32")
            h = pkg.tanh(h)
        return F.conv2d(h, pkg.to_tensor(w2), padding=1)
    return build


def _replay(ws, feed, fetch):
    """Replay a transformed port Workspace as the Executor does."""
    from paddle_tpu_torch.static import Variable, run_node
    env = {id(v): torch.as_tensor(feed[v.name]) for v in ws.feed_vars}

    def val(t):
        t = ws.resolve(t)
        if isinstance(t, Variable):
            return env[id(t)] if id(t) in env else ws.const_env[id(t)]
        return t._t if isinstance(t, pt.Tensor) else t

    for node in ws.ops:
        for var, o in zip(node.outputs,
                          run_node(node, [val(t) for t in node.inputs])):
            env[id(var)] = o
    return env[id(ws.resolve(fetch))].numpy()


@pytest.mark.parametrize("n_unary", [1, 3],
                         ids=["nhwc_chain", "sinks_deep_chains_and_casts"])
def test_auto_layout_pass(n_unary):
    """conv -> unary ops -> conv in NCHW: both convs become NHWC, the
    restoring transpose sinks through the unary ops (a cast among them) and
    cancels against the second conv's (2 boundary transposes survive);
    numerics unchanged."""
    rec = _both(_conv_chain(n_unary), {"x": ([2, 3, 8, 8], "float32")})
    out = _pass_names(rec, lambda pkg: pkg.ir.passes.AutoLayoutPass(),
                      lambda r: [r[2]])
    for ws, names in out:
        assert [n.attrs.get("fmt") for n in ws.ops
                if n.op_name == "conv2d"] == ["NHWC", "NHWC"]
        assert names.count("transpose") == 2, names
    feed = {"x": np.random.RandomState(1).randn(2, 3, 8, 8)
            .astype("float32")}
    prog, _, fetch = rec[1]
    want = _run(pt, prog, feed, fetch)
    _close(_run(ref, rec[0][0], feed, rec[0][2]), want, 2e-5, 2e-5)
    _close(_replay(out[1][0], feed, fetch), want, 2e-5, 2e-5)


def test_auto_layout_flag_runs_in_executor():
    rng = np.random.RandomState(1)
    w = rng.randn(4, 3, 3, 3).astype("float32") * 0.2

    def build(pkg, v):
        F = pkg.nn.functional
        return F.relu(F.conv2d(v["x"], pkg.to_tensor(w), padding=1))

    (prog, _, out), = [_record(pt, build, {"x": ([2, 3, 8, 8], "float32")})]
    exe = pt.static.Executor()
    feed = {"x": rng.randn(2, 3, 8, 8).astype("float32")}
    want = exe.run(prog, feed=feed, fetch_list=[out])[0]
    pt.set_flags({"FLAGS_enable_auto_layout": True})
    try:
        # the flag joins the executor cache key: no cache-busting needed
        got = exe.run(prog, feed=feed, fetch_list=[out])[0]
    finally:
        pt.set_flags({"FLAGS_enable_auto_layout": False})
    assert len(exe._cache) == 2
    _close(got, want, 2e-5, 2e-5)
