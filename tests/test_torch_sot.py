"""SOT, the bytecode capture behind ``to_static(full_graph=False)``
(``paddle_tpu_torch/jit/sot``), against the reference's
(``paddle_tpu/jit/sot``), on the CPU: the counterpart of
``tests/test_sot.py``, test for test.

The same Python function runs through each package's
``symbolic_translate`` and eagerly, from the same numpy inputs (layers
carry the reference's weights). Values: 1e-5 relative and 1e-6 absolute
(fp32; the port's fast path is the captured segment compiled by
``aot_eager`` here, inductor on the card). The capture statistics are
compared exactly (``captures``, ``fast_hits``, ``breaks``,
``tensor_branches``, ``inlined``, and whether a frame fell back): both
interpreters run the same CPython 3.12 bytecode. Not compared: the
fallback reasons' wording and break reasons where the two packages land a
value by different routes (named at each such test).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu._core import lazy as ref_lazy
from paddle_tpu.jit import sot as ref_sot
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import lazy as pt_lazy
from paddle_tpu_torch.jit import sot as pt_sot

SIDES = [(ref, ref_sot, ref_lazy), (pt, pt_sot, pt_lazy)]
STATS = ("captures", "fast_hits", "breaks", "tensor_branches", "inlined")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _np(seed=0, shape=(4, 8)):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


def _stats(sfn, sot):
    st = sot.sot_stats(sfn)
    return {k: st[k] for k in STATS}, bool(st["fallbacks"])


def _same(fn_of, calls):
    """For each package: ``fn = fn_of(paddle)``, its SotFunction, each of
    ``calls`` (a function of the package returning the argument tuple)
    through both, compared with eager; returns the two packages' stats
    and outputs."""
    out = []
    for paddle, sot, _ in SIDES:
        fn = fn_of(paddle)
        sfn = sot.symbolic_translate(fn)
        vals = []
        for make in calls:
            args = make(paddle)
            got, want = sfn(*args), fn(*args)
            _close(got.numpy(), want.numpy())
            vals.append(got.numpy())
        out.append((_stats(sfn, sot), vals))
    (rs, rv), (ps, pv) = out
    for a, b in zip(pv, rv):
        _close(a, b)
    assert ps == rs, (ps, rs)
    return ps


def _F(paddle):
    return paddle.nn.functional


def test_straight_line_fast_path():
    st, fell = _same(lambda p: lambda x: (_F(p).relu(x * 2.0) + 1.0).mean(),
                     [lambda p: (p.to_tensor(_np()),)] * 2)
    assert st["captures"] == 1 and st["fast_hits"] == 1
    assert st["breaks"] == [["guard_exit"]] and not fell


def test_python_value_guards_retrace():
    def fn_of(p):
        def fn(x, n, mode="relu"):
            y = x
            for _ in range(n):
                y = y * 1.1
            return (_F(p).relu(y) if mode == "relu"
                    else _F(p).sigmoid(y)).sum()
        return fn
    st, _ = _same(fn_of, [lambda p: (p.to_tensor(_np(1)), 2),
                          lambda p: (p.to_tensor(_np(1)), 4),
                          lambda p: (p.to_tensor(_np(1)), 2)])
    assert st["captures"] == 2 and st["fast_hits"] == 1


def test_data_dependent_tensor_branch():
    def fn_of(p):
        def fn(x):
            if x.sum() > 0:          # lands the value: a graph break
                return x * 2.0
            return x - 5.0
        return fn
    st, _ = _same(fn_of, [lambda p: (p.to_tensor(np.ones(3, "float32")),),
                          lambda p: (p.to_tensor(-np.ones(3, "float32")),)])
    assert st["tensor_branches"] == 2
    assert all("materialize" in b for b in st["breaks"])


def test_print_side_effect_mid_function(capsys):
    def fn_of(p):
        def fn(x):
            y = x * 3.0
            print("trace:", float(y.sum().numpy()))
            return _F(p).relu(y).mean()
        return fn
    st, _ = _same(fn_of, [lambda p: (p.to_tensor(_np(2)),)])
    assert any(len(b) >= 2 for b in st["breaks"])
    assert capsys.readouterr().out.count("trace:") == 4


def test_unsupported_library_call():
    def fn_of(p):
        def fn(x):
            y = x * 2.0
            h = np.tanh(y.numpy())            # leaves the framework
            return (p.to_tensor(h) + x).sum()
        return fn
    st, fell = _same(fn_of, [lambda p: (p.to_tensor(_np(3)),)])
    assert not fell and any(len(b) >= 2 for b in st["breaks"])


def test_frame_fallback_try_except():
    """try/except is not interpreted: the frame runs natively, still under
    the capture, which records a segment."""
    def fn_of(p):
        def fn(x):
            try:
                y = _F(p).relu(x * 2.0)
            except ValueError:
                y = x
            return y.sum()
        return fn
    st, fell = _same(fn_of, [lambda p: (p.to_tensor(_np(4)),)])
    assert fell and st["breaks"][0]


def test_frame_fallback_generator():
    def gen(n):
        for i in range(n):
            yield i

    def fn_of(p):
        def fn(x, n):
            acc = x
            for i in gen(n):            # the generator runs natively
                acc = acc + float(i)
            return acc.mean()
        return fn
    _, fell = _same(fn_of, [lambda p: (p.to_tensor(_np(5)), 3)])
    assert not fell


def test_inlining_user_helpers_and_guards():
    def helper(t, k):
        return t * k + 1.0

    def fn(x, k):
        return helper(x, k).sum()
    st, _ = _same(lambda p: fn, [lambda p: (p.to_tensor(_np(6)), 3),
                                 lambda p: (p.to_tensor(_np(6)), 4),
                                 lambda p: (p.to_tensor(_np(6)), 3)])
    assert st["inlined"] >= 2
    assert st["captures"] == 2 and st["fast_hits"] == 1


_SCALE = 2.0


def _gfn(x):
    return (x * _SCALE).sum()


def test_global_value_guard():
    global _SCALE
    for paddle, sot, _ in SIDES:
        sfn = sot.symbolic_translate(_gfn)
        x = paddle.to_tensor(_np(7))
        _SCALE = 2.0
        _close(sfn(x).numpy(), (x * 2.0).sum().numpy())
        _SCALE = 5.0                  # guarded global changed: retrace
        _close(sfn(x).numpy(), (x * 5.0).sum().numpy())
        _SCALE = 2.0
        assert sot.sot_stats(sfn)["captures"] == 2


def _mlp_weights():
    ref.seed(0)
    net = ref.nn.Sequential(ref.nn.Linear(8, 16), ref.nn.ReLU(),
                            ref.nn.Linear(16, 4))
    return {k: np.array(v.numpy()) for k, v in net.state_dict().items()}


def _mlp(paddle, weights):
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    net.set_state_dict({k: paddle.to_tensor(v) for k, v in weights.items()})
    return net


def test_layer_capture_and_param_update():
    w = _mlp_weights()
    got = []
    for paddle, sot, _ in SIDES:
        net = _mlp(paddle, w)
        sfn = sot.symbolic_translate(lambda m, inp: m(inp))
        x = paddle.to_tensor(_np(8))
        outs = [sfn(net, x).numpy(), sfn(net, x).numpy()]
        assert sot.sot_stats(sfn)["fast_hits"] == 1
        with paddle.no_grad():
            wt = net[0].weight
            wt.set_value(wt * 0.5)    # visible on the fast path
        outs.append(sfn(net, x).numpy())
        _close(outs[-1], net(x).numpy())
        got.append(outs)
    for a, b in zip(*got):
        _close(b, a)


def test_grad_parity_on_fast_path():
    got = []
    for paddle, sot, _ in SIDES:
        net = paddle.nn.Linear(8, 4)
        net.set_state_dict({"weight": paddle.to_tensor(_np(40, (8, 4))),
                            "bias": paddle.to_tensor(_np(41, (4,)))})
        x = paddle.to_tensor(_np(9))

        def loss_fn(m, inp):
            return (m(inp) ** 2).mean()
        sfn = sot.symbolic_translate(loss_fn)

        def grad_of(f):
            net.weight.clear_grad()
            f(net, x).backward()
            return net.weight.grad.numpy().copy()
        g = [grad_of(sfn), grad_of(sfn), grad_of(loss_fn)]
        _close(g[0], g[2])
        _close(g[1], g[2])
        assert sot.sot_stats(sfn)["fast_hits"] >= 1
        got.append(g[2])
    _close(got[1], got[0])


def test_tensor_shape_guard_retraces():
    st, _ = _same(lambda p: lambda x: (x * 2.0).sum(),
                  [lambda p: (p.to_tensor(_np(10, (4, 8))),),
                   lambda p: (p.to_tensor(_np(10, (2, 3))),)])
    assert st["captures"] == 2


def test_containers_and_comprehensions():
    def fn(xs, scale):
        parts = [x * scale for x in xs]
        d = {"a": parts[0], "b": parts[1]}
        return d["a"].sum() + d["b"].sum()
    call = lambda p: ([p.to_tensor(_np(11)), p.to_tensor(_np(12))], 3)  # noqa
    st, _ = _same(lambda p: fn, [call, call])
    assert st["captures"] == 1 and st["fast_hits"] == 1


def test_to_static_full_graph_false():
    w = {"weight": _np(42, (8, 4)), "bias": _np(43, (4,))}
    got = []
    for paddle, sot, _ in SIDES:
        net = paddle.nn.Linear(8, 4)
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
        x = paddle.to_tensor(_np(13))
        want = net(x).numpy()
        paddle.jit.to_static(net, full_graph=False)
        assert isinstance(net.forward, sot.SotFunction)
        _close(net(x).numpy(), want)
        _close(net(x).numpy(), want)
        assert sot.sot_stats(net.forward)["fast_hits"] == 1
        got.append(want)
    _close(got[1], got[0])


def test_method_capture():
    class Head:
        def __init__(self, s):
            self.s = s

        def score(self, x):
            return (x * self.s).mean()
    for paddle, sot, _ in SIDES:
        h = Head(3.0)
        sfn = sot.symbolic_translate(h.score)
        x = paddle.to_tensor(_np(14))
        for _ in range(2):
            _close(sfn(x).numpy(), h.score(x).numpy())
        assert sot.sot_stats(sfn)["fast_hits"] == 1
        h.s = 7.0                       # attribute-chain guard on self.s
        _close(sfn(x).numpy(), h.score(x).numpy())
        assert sot.sot_stats(sfn)["captures"] == 2


def test_python_outputs_unwrapped_and_guarded():
    for paddle, sot, _ in SIDES:
        sfn = sot.symbolic_translate(lambda x, n: (x * 2.0, n + 1))
        x = paddle.to_tensor(_np(20))
        _, v1 = sfn(x, 3)
        assert type(v1) is int and v1 == 4
        assert sfn(x, 5)[1] == 6
        assert sfn(x, 3)[1] == 4


def test_list_arg_value_guard():
    for paddle, sot, _ in SIDES:
        sfn = sot.symbolic_translate(lambda xs: paddle.to_tensor(xs) * 2.0)
        _close(sfn([1.0, 2.0]).numpy(), [2.0, 4.0])
        _close(sfn([1.0, 2.0]).numpy(), [2.0, 4.0])
        _close(sfn([5.0, 6.0]).numpy(), [10.0, 12.0])


def test_layer_list_growth_retraces():
    """Appending to an iterated container invalidates the fast path (a
    length guard)."""
    for paddle, sot, _ in SIDES:
        class Stack:
            def __init__(self):
                self.blocks = [paddle.nn.Linear(4, 4)]

            def run(self, x):
                for blk in self.blocks:
                    x = blk(x)
                return x
        st = Stack()
        sfn = sot.symbolic_translate(st.run)
        x = paddle.to_tensor(_np(21, (2, 4)))
        for _ in range(2):
            _close(sfn(x).numpy(), st.run(x).numpy())
        st.blocks.append(paddle.nn.Linear(4, 4))
        _close(sfn(x).numpy(), st.run(x).numpy())
        assert sot.sot_stats(sfn)["captures"] == 2


def test_super_call_falls_back_cleanly():
    for paddle, sot, _ in SIDES:
        class Base(paddle.nn.Layer):
            def forward(self, x):
                return x * 2.0

        class Child(Base):
            def forward(self, x):
                return super().forward(x) + 1.0
        c = Child()
        sfn = sot.symbolic_translate(c.forward)
        x = paddle.to_tensor(_np(22))
        _close(sfn(x).numpy(), c.forward(x).numpy())
        assert sot.sot_stats(sfn)["fallbacks"]


def test_grad_survives_flush_inside_no_grad():
    for paddle, _, lazy in SIDES:
        x = paddle.to_tensor(np.ones((2, 2), "float32"))
        w = paddle.to_tensor(np.full((2, 2), 3.0, "float32"))
        w.stop_gradient = False
        with lazy.lazy_guard():
            y = (x * w).sum()
            with paddle.no_grad():
                _ = y.numpy()            # the flush runs under no_grad
        y.backward()
        assert w.grad is not None
        _close(w.grad.numpy(), np.ones((2, 2)))


def test_lazy_guard_error_path_materializes():
    for paddle, _, lazy in SIDES:
        x = paddle.to_tensor(np.ones((2,), "float32"))
        with pytest.raises(ValueError):
            with lazy.lazy_guard():
                y = x + 1.0
                raise ValueError("user error")
        _close(y.numpy(), [2.0, 2.0])


def test_grad_mode_not_baked_into_fast_path():
    """An entry captured under no_grad does not serve a training call."""
    for paddle, sot, _ in SIDES:
        net = paddle.nn.Linear(6, 3)
        sfn = sot.symbolic_translate(lambda m, inp: (m(inp) ** 2).mean())
        x = paddle.to_tensor(_np(30, (2, 6)))
        with paddle.no_grad():
            _ = sfn(net, x)
        loss = sfn(net, x)
        loss.backward()
        assert net.weight.grad is not None
        net.weight.clear_grad()
        with paddle.no_grad():
            out = sfn(net, x)
        assert out.stop_gradient


_MODE_A = object()
_MODE_B = object()


def test_is_comparison_on_tracked_object_guarded():
    class Cfg:
        mode = "a"

    def fn(c, x):
        if c.mode is _MODE_A:
            return x * 2.0
        return x * 100.0
    for paddle, sot, _ in SIDES:
        cfg = Cfg()
        cfg.mode = _MODE_A
        sfn = sot.symbolic_translate(fn)
        x = paddle.to_tensor(_np(31))
        _close(sfn(cfg, x).numpy(), (x * 2.0).numpy())
        cfg.mode = _MODE_B
        _close(sfn(cfg, x).numpy(), (x * 100.0).numpy())


def test_detached_alias_stays_detached_under_lazy():
    for paddle, _, lazy in SIDES:
        x = paddle.to_tensor(np.ones((2,), "float32"))
        x.stop_gradient = False
        with lazy.lazy_guard():
            y = (x * 2.0).detach()
        assert y.stop_gradient
        if paddle is pt:
            assert y._t.grad_fn is None and y._t.requires_grad is False
        else:
            assert y._autograd_meta.grad_node is None


def test_amp_rule_not_baked_into_fast_path():
    """The port's fast path holds the capture's AMP rule like its grad
    mode (as to_static's cache key does): an entry captured under O1 does
    not serve an fp32 call, and each call's output has eager's dtype. The
    reference's entry keys grad mode only; its values are compared where
    both hold."""
    w = {"weight": _np(44, (8, 4)), "bias": _np(45, (4,))}
    got = []
    for paddle, sot, _ in SIDES:
        net = paddle.nn.Linear(8, 4)
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
        x = paddle.to_tensor(_np(46))
        sfn = sot.symbolic_translate(lambda m, inp: m(inp) * 2.0)
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            low = sfn(net, x)
            low2 = sfn(net, x)
            want_low = net(x) * 2.0
        full = sfn(net, x)
        want = net(x) * 2.0
        assert low.dtype == low2.dtype == want_low.dtype == paddle.bfloat16
        if paddle is pt:
            assert full.dtype == want.dtype == paddle.float32
            assert sot.sot_stats(sfn)["captures"] == 2
            _close(full.numpy(), want.numpy())
        got.append(np.asarray(low2.astype("float32").numpy()))
    np.testing.assert_allclose(got[1], got[0], rtol=2 ** -7, atol=1e-2)


def test_side_effect_before_the_step_budget_runs_once():
    """A frame that writes outside state and then runs past
    ``FLAGS_sot_step_budget`` finishes in the interpreter: falling back
    there would call the function natively and run the write a second
    time. The port departs from the reference here (ROADMAP §3), whose
    fallback repeats it: the port alone is held."""
    from paddle_tpu_torch._core.flags import flag_value, set_flags

    class Counter:
        def __init__(self):
            self.n = 0

        def step(self, x):
            self.n += 1
            for _ in range(40):
                x = x + 1.0
            return x

    old = flag_value("FLAGS_sot_step_budget")
    set_flags({"FLAGS_sot_step_budget": 60})
    try:
        c = Counter()
        sfn = pt_sot.symbolic_translate(c.step)
        out = sfn(pt.to_tensor(_np()))
    finally:
        set_flags({"FLAGS_sot_step_budget": old})
    assert c.n == 1
    _close(out.numpy(), _np() + 40.0)


def test_scalar_built_inside_the_call_is_not_frozen():
    """A one-element tensor built inside the call from host data (no
    guarded source traces it) is not bound into the fast path as a
    constant: two calls draw two numbers, as eagerly. The reference
    freezes the first draw (ROADMAP §3): the port alone is held."""
    def f(x):
        s = pt.to_tensor(np.random.rand(), dtype="float32")
        return x * s

    sfn = pt_sot.symbolic_translate(f)
    x = pt.to_tensor(_np())
    np.random.seed(7)
    a = sfn(x).numpy()
    b = sfn(x).numpy()
    np.random.seed(7)
    want_a = f(x).numpy()
    want_b = f(x).numpy()
    _close(a, want_a)
    _close(b, want_b)
    assert not np.allclose(a, b)


def test_fallback_after_a_write_raises(monkeypatch):
    """Any other fallback met after a write outside the frame raises
    ``SotSideEffectError`` instead of running the frame natively (which
    would write again): here the interpreter is made to refuse a
    subtraction."""
    import dis
    from paddle_tpu_torch.jit.sot import opcode_executor as oe

    sub = [i for i, (name, _) in enumerate(dis._nb_ops)
           if name == "NB_SUBTRACT"][0]
    table = list(oe._NB_TABLE)
    table[sub] = None
    monkeypatch.setattr(oe, "_NB_TABLE", table)

    class Counter:
        def __init__(self):
            self.n = 0

        def step(self, x):
            self.n += 1
            return x - 1.0

    c = Counter()
    with pytest.raises(pt_sot.SotSideEffectError, match="repeat the write"):
        pt_sot.symbolic_translate(c.step)(pt.to_tensor(_np()))
    assert c.n == 1


@pytest.mark.parametrize("make", [
    lambda: pt.to_tensor(2.0),
    lambda: pt.full([1], 0.5),
    lambda: pt.to_tensor(2.0, dtype=pt.float32),
], ids=["to_tensor", "full", "to_tensor_dtype"])
def test_constant_scalar_built_inside_the_call_takes_the_fast_path(make):
    """A one-element tensor the port builds from the code's own constants
    is bound into the fast path as a constant: the second call hits it
    and gives the eager value."""
    def f(x):
        return x * make()

    sfn = pt_sot.symbolic_translate(f)
    x = pt.to_tensor(_np())
    want = f(x).numpy()
    for _ in range(2):
        _close(sfn(x).numpy(), want)
    st = pt_sot.sot_stats(sfn)
    assert st["captures"] == 1 and st["fast_hits"] == 1


@pytest.mark.parametrize("kind", ["counter", "draw"])
def test_zero_argument_scalar_factory_is_not_frozen(kind):
    """A call with no arguments that builds a one-element tensor from
    hidden state (here a counter, behind a try block so that it runs
    natively), and a draw from the port's generator, are not bound as
    constants: each call gives what the eager call gives."""
    import itertools
    counter = [itertools.count(1)]

    def tick():
        try:
            return pt.to_tensor(float(next(counter[0])))
        except StopIteration:
            raise

    def f(x):
        return x * (tick() if kind == "counter" else pt.rand([1]))

    sfn = pt_sot.symbolic_translate(f)
    x = pt.to_tensor(_np())
    pt.seed(3)
    got = [sfn(x).numpy() for _ in range(3)]
    counter[0] = itertools.count(1)
    pt.seed(3)
    want = [f(x).numpy() for _ in range(3)]
    for g, w in zip(got, want):
        _close(g, w)
    assert not np.allclose(got[0], got[1])
