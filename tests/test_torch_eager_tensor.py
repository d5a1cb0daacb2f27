"""The port's eager Tensor, ops and autograd against the JAX package's, on
the CPU: creation types (paddle's int64 integer default), the arithmetic
operators' type promotion, the manipulation, reduction and product ops,
and gradients of a small graph. Inputs are made from a seed with numpy and
handed to both.

Tolerances: fp32 on both sides, 1e-6 (relative and absolute): the ops
here are single elementwise passes or reductions over a few dozen terms.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The eager API on the CPU for each test (no card here), restored
    after it."""
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _both(fn):
    """``fn(paddle)`` on each framework."""
    return fn(ref), fn(pt)


def _np(x):
    return np.asarray(x.numpy())


CREATION = {
    "arange_int": lambda p: p.arange(5),
    "arange_float": lambda p: p.arange(0, 1, 0.25),
    "arange_start_end": lambda p: p.arange(2, 9, 3),
    "zeros": lambda p: p.zeros([2, 3]),
    "ones_int32": lambda p: p.ones([2], "int32"),
    "full_int": lambda p: p.full([2], 1),
    "full_float": lambda p: p.full([2], 1.5),
    "full_bool": lambda p: p.full([2], True),
    "full_dtype": lambda p: p.full([2], 3, dtype="float16"),
    "to_tensor_int": lambda p: p.to_tensor(7),
    "to_tensor_float": lambda p: p.to_tensor(1.5),
    "to_tensor_list": lambda p: p.to_tensor([[1, 2], [3, 4]]),
    "to_tensor_bool": lambda p: p.to_tensor([True, False]),
    "to_tensor_int32": lambda p: p.to_tensor(np.array([1, 2], np.int32)),
    "to_tensor_float64": lambda p: p.to_tensor(np.array([1.0, 2.0])),
    "to_tensor_dtype": lambda p: p.to_tensor([1, 2], dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CREATION))
def test_creation_types_values_and_shapes_match_reference(case):
    r, t = _both(CREATION[case])
    assert t.dtype.name == r.dtype.name
    assert t.shape == list(r.shape)
    np.testing.assert_array_equal(_np(t).astype(np.float64),
                                  _np(r).astype(np.float64))
    assert t.stop_gradient


_DTYPES = ["bool", "int8", "int32", "int64", "float16", "bfloat16",
           "float32"]
_OPERANDS = ["int", "float", "bool"] + [f"t_{d}" for d in _DTYPES]
_OPS = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
        "floordiv": lambda a, b: a // b, "pow": lambda a, b: a ** b,
        "radd": lambda a, b: b + a, "rdiv": lambda a, b: b / a,
        "rmul": lambda a, b: b * a}


def _operand(p, kind):
    if kind == "int":
        return 2
    if kind == "float":
        return 1.5
    if kind == "bool":
        return True
    return p.to_tensor(np.array([1, 2, 3])).astype(kind[2:])


def _result_type(p, lhs, op, rhs):
    a = p.to_tensor(np.array([1, 0, 2])).astype(lhs)
    b = _operand(p, rhs)
    if op.startswith("r") and not isinstance(b, (int, float)):
        return None  # a reflected op needs a Python scalar on the left
    try:
        return _OPS[op](a, b).dtype.name
    except Exception:  # an operation neither side defines (bool - bool ...)
        return "refused"


@pytest.mark.parametrize("lhs", _DTYPES)
def test_operator_promotion_matches_reference(lhs):
    """Every binary operator against Python int, float and bool scalars
    and tensors of every type: the port's result type is the reference's
    (JAX's rules with x64 on), where the reference gives one."""
    diffs = []
    for op in _OPS:
        for rhs in _OPERANDS:
            want = _result_type(ref, lhs, op, rhs)
            if want in (None, "refused"):
                continue
            got = _result_type(pt, lhs, op, rhs)
            if got != want:
                diffs.append((lhs, op, rhs, want, got))
    assert not diffs


def _x(p, seed=0, shape=(2, 3, 4)):
    return p.to_tensor(np.random.RandomState(seed).randn(*shape)
                       .astype(np.float32))


VALUE_OPS = {
    "reshape": lambda p: _x(p).reshape([3, 8]),
    "reshape_infer": lambda p: p.reshape(_x(p), [-1, 6]),
    "transpose": lambda p: p.transpose(_x(p), [2, 0, 1]),
    "unbind": lambda p: p.concat(p.unbind(_x(p), axis=1), axis=0),
    "concat": lambda p: p.concat([_x(p), _x(p, 1)], axis=1),
    "split": lambda p: p.split(_x(p), [1, -1], axis=2)[1],
    "matmul_transpose_y": lambda p: p.matmul(_x(p), _x(p, 1),
                                             transpose_y=True),
    "matmul_transpose_x": lambda p: p.matmul(_x(p), _x(p, 1),
                                             transpose_x=True),
    "sum_axis": lambda p: p.sum(_x(p), axis=[0, 2]),
    "sum_all": lambda p: _x(p).sum(),
    "mean_keepdim": lambda p: p.mean(_x(p), axis=-1, keepdim=True),
    "max_axis": lambda p: p.max(_x(p), axis=1),
    "exp": lambda p: p.exp(_x(p)),
    "log": lambda p: p.log(p.abs(_x(p)) + 0.5),
    "tanh": lambda p: p.tanh(_x(p)),
    "cast": lambda p: _x(p).astype("float16").astype("float32"),
    "mixed": lambda p: (_x(p) * 2 - 1) / 3 + _x(p, 1) ** 2,
}


@pytest.mark.parametrize("case", sorted(VALUE_OPS))
def test_ops_match_reference(case):
    r, t = _both(VALUE_OPS[case])
    assert t.shape == list(r.shape) and t.dtype.name == r.dtype.name
    np.testing.assert_allclose(_np(t), _np(r), rtol=1e-6, atol=1e-6)


def _graph(p, w_np, x_np):
    w = p.to_tensor(w_np, stop_gradient=False)
    x = p.to_tensor(x_np, stop_gradient=False)
    h = p.tanh(p.matmul(x, w, transpose_y=True))
    q, k = p.unbind(h.reshape([4, 2, 3]), axis=1)
    loss = p.mean(p.exp(q) * k) + p.sum(p.transpose(h, [1, 0]) ** 2) / 7
    return loss, w, x


def test_small_graph_gradients_match_reference():
    rng = np.random.RandomState(3)
    w_np, x_np = rng.randn(6, 5).astype(np.float32), \
        rng.randn(4, 5).astype(np.float32)
    (rl, rw, rx), (tl, tw, tx) = _both(lambda p: _graph(p, w_np, x_np))
    assert not tl.stop_gradient
    rl.backward()
    tl.backward()
    np.testing.assert_allclose(float(tl), float(rl.numpy()), rtol=1e-6)
    for got, want in ((tw, rw), (tx, rx)):
        np.testing.assert_allclose(_np(got.grad), _np(want.grad), rtol=1e-6,
                                   atol=1e-6)


def test_paddle_grad_matches_and_grad_accumulates_until_clear_grad():
    rng = np.random.RandomState(4)
    w_np, x_np = rng.randn(6, 5).astype(np.float32), \
        rng.randn(4, 5).astype(np.float32)
    r_loss, r_w, r_x = _graph(ref, w_np, x_np)
    t_loss, t_w, t_x = _graph(pt, w_np, x_np)
    r_g = ref.grad(r_loss, [r_w, r_x], retain_graph=True)
    t_g = pt.grad(t_loss, [t_w, t_x], retain_graph=True)
    for got, want in zip(t_g, r_g):
        assert got.stop_gradient
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    assert t_w.grad is None  # paddle.grad leaves .grad alone
    t_loss.backward(retain_graph=True)
    np.testing.assert_allclose(_np(t_w.grad), _np(t_g[0]), rtol=1e-6)
    t_loss.backward()  # a second backward adds to .grad
    np.testing.assert_allclose(_np(t_w.grad), 2 * _np(t_g[0]), rtol=1e-6)
    t_w.clear_grad()
    assert t_w.grad is None


def test_no_grad_and_stop_gradient():
    w = pt.to_tensor(np.ones((2, 2), np.float32), stop_gradient=False)
    with pt.no_grad():
        y = w * 2
    assert y.stop_gradient and pt.is_grad_enabled()
    z = w * 3
    assert not z.stop_gradient
    z.stop_gradient = True  # cut off from the graph
    assert z.stop_gradient and z.is_leaf
    with pytest.raises(RuntimeError):
        pt.to_tensor([1.0]).backward()


def test_tensor_creation_without_a_card_raises(monkeypatch):
    """The eager API's default device is the card: with none here and no
    ``set_device('cpu')``, creation raises instead of running on the
    CPU."""
    monkeypatch.setattr(pt_device, "_current", None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: pt.to_tensor([1.0]), lambda: pt.zeros([2]),
                 lambda: pt.arange(3), lambda: pt.nn.Linear(2, 2),
                 pt.get_device):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    pt.set_device("cpu")
    assert pt.get_device() == "cpu"
    assert pt.to_tensor([1.0]).place == pt.CPUPlace()
