"""The port's dy2static (``paddle_tpu_torch.jit.dy2static`` under
``jit.to_static``) against the JAX package's, on the CPU.

Every scenario of ``tests/test_dy2static.py``: the same model class built
in each package, the reference's weights crossed to the port with
``set_state_dict``, the same numpy inputs made from a seed, run through
each package's ``to_static`` (the port's with ``backend="aot_eager"``).
Outputs and gradients held at fp32 rtol 1e-5, atol 1e-6; the scenarios the
reference's test holds to a fixed value are held to it as well.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device

RTOL, ATOL = 1e-5, 1e-6
BACKEND = "aot_eager"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


def _nets(pkg):
    """The reference test's layers, built over ``pkg``."""
    nn, F = pkg.nn, pkg.nn.functional

    class BranchNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            if (h.mean() > 0):
                out = h * 2.0
            else:
                out = h - 1.0
            return out

    class LoopNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            n = (h * h).sum()
            while (n > 1.0):
                h = h * 0.5
                n = (h * h).sum()
            return h

    class EarlyReturn(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            if (h.mean() > 0):
                return h * 2.0
            return h - 1.0

    class Gated(nn.Layer):
        def __init__(self, use_gate):
            super().__init__()
            self.lin = nn.Linear(4, 4)
            self.use_gate = use_gate

        def forward(self, x):
            h = self.lin(x)
            if self.use_gate:  # plain Python flow: static, no conversion
                h = F.relu(h)
            return h

    return {"branch": BranchNet, "loop": LoopNet, "early": EarlyReturn,
            "gated": Gated}


def _pair(name, *args):
    """The reference's layer and the port's with its weights."""
    ref.seed(0)
    r = _nets(ref)[name](*args)
    p = _nets(pt)[name](*args)
    p.set_state_dict({k: np.array(v.numpy())
                      for k, v in r.state_dict().items()})
    return r, p


def _static(pkg, fn):
    if pkg is pt:
        return pt.jit.to_static(fn, backend=BACKEND)
    return ref.jit.to_static(fn)


def _data(sign, scale=1.0):
    x = np.random.RandomState(0).randn(8, 4).astype("float32")
    return np.abs(x) * sign * scale


@pytest.mark.parametrize("sign", [+1.0, -1.0])
def test_branch_net_eager_vs_static_both_branches(sign):
    r, p = _pair("branch")
    x = _data(sign)
    want = ref.jit.to_static(r)(ref.to_tensor(x)).numpy()
    got = _static(pt, p)(pt.to_tensor(x)).numpy()
    _close(got, want)
    _, eager = _pair("branch")
    _close(got, eager(pt.to_tensor(x)).numpy())


@pytest.mark.parametrize("sign", [+1.0, -1.0])
def test_branch_net_gradients_match(sign):
    r, p = _pair("branch")
    x = _data(sign)
    loss_r = (ref.jit.to_static(r)(ref.to_tensor(x)) ** 2).mean()
    loss_r.backward()
    loss_p = (_static(pt, p)(pt.to_tensor(x)) ** 2).mean()
    loss_p.backward()
    _close(float(loss_p), float(loss_r))
    for (name, pr), pp in zip(r.named_parameters(), p.parameters()):
        _close(pp.grad.numpy(), pr.grad.numpy())


def test_loop_net_eager_vs_static():
    r, p = _pair("loop")
    x = _data(+1.0, 3.0)
    want = ref.jit.to_static(r)(ref.to_tensor(x)).numpy()
    _close(_static(pt, p)(pt.to_tensor(x)).numpy(), want)


@pytest.mark.parametrize("sign", [+1.0, -1.0])
def test_early_return_in_tensor_branch(sign):
    r, p = _pair("early")
    x = _data(sign)
    want = ref.jit.to_static(r.forward)(ref.to_tensor(x)).numpy()
    got = _static(pt, p.forward)(pt.to_tensor(x)).numpy()
    _close(got, want)
    _close(got, p(pt.to_tensor(x)).numpy())


def _both(fn, *arrays):
    """``fn`` through each package's to_static on the same arrays."""
    want = ref.jit.to_static(fn)(*[ref.to_tensor(a) for a in arrays])
    got = _static(pt, fn)(*[pt.to_tensor(a) for a in arrays])
    return got, want


def _leaves(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _check_both(fn, *arrays, value=None):
    got, want = _both(fn, *arrays)
    for g, w in zip(_leaves(got), _leaves(want)):
        _close(g.numpy(), w.numpy())
        if value is not None:
            assert abs(float(g.numpy()) - value) < 1e-6


def over_range(x):
    acc = x * 0.0
    for i in range(3):
        acc = acc + x * float(i + 1)
    return acc


def over_tensor(x):
    acc = x[0] * 0.0
    for row in x:
        acc = acc + row
    return acc


def bc(x):
    s = x.sum() * 0.0
    i = x.sum() * 0.0
    while i < 10.0:
        i = i + 1.0
        if i == 3.0:
            continue
        if i > 6.0:
            break
        s = s + i
    return s


def cont_for(x):
    s = x.sum() * 0.0
    for i in range(5):
        if i == 2:
            continue
        s = s + float(i)
    return s


def ret_in_loop(x):
    s = x.sum() * 0.0
    for i in range(5):
        s = s + 1.0
        if s > 2.5:
            return s * 100.0
    return s


def brk_tensor(x):
    s = x.sum() * 0.0
    for i in range(5):
        if s > 2.5:
            break
        s = s + 1.0
    return s


def enum_fn(t):
    s = t.sum() * 0.0
    for i, v in enumerate([1.0, 2.0]):
        s = s + v * float(i + 1)
    return s


def zip_fn(t):
    s = t.sum() * 0.0
    for a, b in zip([1.0, 2.0], [3.0, 4.0]):
        s = s + a * b
    return s


def tup_fn(t):
    if t.mean() > 0:
        return t * 2.0, t + 1.0
    return t, t


def test_for_loop_over_range_and_tensor():
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    _check_both(over_range, x)
    _check_both(over_tensor, x)
    got, _ = _both(over_tensor, x)
    np.testing.assert_allclose(got.numpy(), x.sum(0), rtol=1e-5)


ONES = np.ones((2, 2), "float32")


@pytest.mark.parametrize("fn,value", [
    (bc, 18.0),           # 1 + 2 + 4 + 5 + 6: 3 skipped, 7 breaks
    (cont_for, 8.0),      # the index bump precedes the continue guard
    (ret_in_loop, 300.0),
    (brk_tensor, 3.0),    # a Python-count loop turned traced mid-flight
    (enum_fn, 5.0),
    (zip_fn, 11.0),
], ids=["break_continue_in_tensor_while", "continue_in_for_advances_index",
        "tensor_return_inside_loop", "tensor_break_in_python_trip_count",
        "for_over_enumerate", "for_over_zip"])
def test_converted_loops(fn, value):
    _check_both(fn, ONES, value=value)


def test_tuple_return_in_tensor_branch():
    x = np.full((2, 2), -1.0, "float32")
    _check_both(tup_fn, x)
    got, _ = _both(tup_fn, x)
    for g in got:
        np.testing.assert_allclose(g.numpy(), x)


def test_user_var_single_branch_binding_raises_clearly():
    def bad_fn(t):
        y = None
        if t.mean() > 0:
            y = t * 2.0
        if y is None:
            return t - 1.0
        return y

    x = np.full((2, 2), -1.0, "float32")
    with pytest.raises(RuntimeError, match="one branch"):
        ref.jit.to_static(bad_fn)(ref.to_tensor(x))
    with pytest.raises(RuntimeError, match="one branch"):
        _static(pt, bad_fn)(pt.to_tensor(x))


def test_python_value_guards_retrace():
    def fn(x, mode):
        if mode == 1:
            return x * 2.0
        return x * 3.0

    x = np.ones((2, 2), "float32")
    rs, ps = ref.jit.to_static(fn), _static(pt, fn)
    for mode, factor in ((1, 2.0), (2, 3.0), (1, 2.0)):
        got = ps(pt.to_tensor(x), mode).numpy()
        _close(got, rs(ref.to_tensor(x), mode).numpy())
        np.testing.assert_allclose(got, x * factor)
    assert len(ps._fwd_cache) == len(rs._fwd_cache) == 2


@pytest.mark.parametrize("flag", [True, False])
def test_static_python_control_flow_untouched(flag):
    r, p = _pair("gated", flag)
    x = _data(-1.0)
    want = ref.jit.to_static(r)(ref.to_tensor(x)).numpy()
    got = _static(pt, p)(pt.to_tensor(x)).numpy()
    _close(got, want)


def test_to_static_with_amp_loss_backward():
    """An AMP'd loss downstream of the compiled forward: torch's autograd
    casts the cotangent to the forward's output type, as the reference's
    VJP casts it. The port's compiled gradient equals its eager one and the
    reference's eager one at the fp32 tolerances (bit for bit here); the
    reference's compiled VJP rounds the bf16 product's gradient at other
    points (0.6% apart on one element), so against it the gradient is
    held within bf16's rounding: 2^-7 of the largest element."""
    ref.seed(0)
    rm = ref.nn.Linear(8, 4)
    state = {k: np.array(v.numpy()) for k, v in rm.state_dict().items()}
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    y = np.array([1, 3], np.int64)

    def grad(pkg, static):
        m = pkg.nn.Linear(8, 4)
        m.set_state_dict(state)
        f = _static(pkg, m) if static else m
        with pkg.amp.auto_cast(level="O1"):
            loss = pkg.nn.functional.cross_entropy(
                f(pkg.to_tensor(x)), pkg.to_tensor(y))
        loss.backward()
        assert m.weight.grad is not None
        return np.asarray(m.weight.grad.numpy(), np.float64)

    got = grad(pt, True)
    assert np.isfinite(got).all()
    _close(got, grad(pt, False))
    _close(got, grad(ref, False))
    want = grad(ref, True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
